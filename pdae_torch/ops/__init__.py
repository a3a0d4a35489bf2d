"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``set_use_kernels`` is the tri-state switch (the port's counterpart of
``pdae_tpu.ops.set_use_pallas``):

* ``None`` (auto, the default): the kernel for a CUDA tensor, the plain
  version for a CPU tensor;
* ``False``: the plain version everywhere (whole-path comparisons on the card);
* ``True``: the kernel, and a CPU tensor raises.

A CUDA tensor never falls back: it launches the kernel or raises, in the
forward and, where a gradient is wanted, in the backward. Each kernel
module keeps a plain integer ``launches`` that its wrapper raises by one per
launch; ``launch_counts``/``reset_launch_counts`` read and clear them. The GN
forward and the GN backward each have three hand-written variants: for a
contiguous (NCHW) input the cluster or the general one, chosen from the shape
before the launch, and for a channels-last one (the bf16 models) the NHWC
one; ``gn_variant_counts`` and ``gn_bwd_variant_counts`` say how many of
their launches each served, and ``launch_counts`` carries the NHWC ones too
(``gn_adagn_silu_nhwc``, ``gn_adagn_silu_bwd_nhwc``: parts of the totals). The
split passes of the two GN kernels (spatial parallelism: ``gn_stats``,
``gn_apply``, ``gn_bwd_moments``, ``gn_bwd_dx``) are counted under those
names.
"""

from __future__ import annotations

from . import attention, groupnorm, groupnorm_train
from ._dispatch import set_use_kernels
from .attention import fused_qkv_attention, reference_attention
from .groupnorm import (fused_gn_adagn_silu, gn_adagn_silu, gn_adagn_silu_fwd,
                        gn_apply, gn_apply_plain, gn_stats, gn_stats_plain,
                        moments_from_sums, reference_gn_adagn_silu)
from .groupnorm_train import (gn_adagn_silu_bwd_plain, gn_adagn_silu_split,
                              gn_adagn_silu_train, gn_bwd_dx_plain, gn_bwd_moments_plain)

_KERNEL_MODULES = {"attention": attention, "gn_adagn_silu": groupnorm,
                   "gn_adagn_silu_bwd": groupnorm_train}


def launch_counts() -> dict:
    return {**{name: mod.launches for name, mod in _KERNEL_MODULES.items()},
            **groupnorm.pass_launches, **groupnorm_train.pass_launches,
            "gn_adagn_silu_nhwc": groupnorm.variant_launches["nhwc"],
            "gn_adagn_silu_bwd_nhwc": groupnorm_train.variant_launches["nhwc"]}


def gn_variant_counts() -> dict:
    return dict(groupnorm.variant_launches)


def gn_bwd_variant_counts() -> dict:
    return dict(groupnorm_train.variant_launches)


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
    for counts in (groupnorm.variant_launches, groupnorm_train.variant_launches,
                   groupnorm.pass_launches, groupnorm_train.pass_launches):
        for variant in counts:
            counts[variant] = 0


__all__ = ["set_use_kernels", "launch_counts", "gn_variant_counts", "gn_bwd_variant_counts",
           "reset_launch_counts", "fused_qkv_attention", "reference_attention",
           "gn_adagn_silu", "gn_adagn_silu_fwd", "fused_gn_adagn_silu",
           "reference_gn_adagn_silu", "gn_adagn_silu_train",
           "gn_adagn_silu_bwd_plain", "gn_adagn_silu_split", "gn_stats", "gn_stats_plain",
           "gn_apply", "gn_apply_plain", "moments_from_sums", "gn_bwd_moments_plain",
           "gn_bwd_dx_plain"]
