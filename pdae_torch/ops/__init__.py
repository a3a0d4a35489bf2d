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
launch; ``launch_counts``/``reset_launch_counts`` read and clear them.
"""

from __future__ import annotations

from . import attention, groupnorm, groupnorm_train
from ._dispatch import set_use_kernels
from .attention import fused_qkv_attention, reference_attention
from .groupnorm import (fused_gn_adagn_silu, gn_adagn_silu, gn_adagn_silu_fwd,
                        reference_gn_adagn_silu)
from .groupnorm_train import gn_adagn_silu_bwd_plain, gn_adagn_silu_train

_KERNEL_MODULES = {"attention": attention, "gn_adagn_silu": groupnorm,
                   "gn_adagn_silu_bwd": groupnorm_train}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0


__all__ = ["set_use_kernels", "launch_counts",
           "reset_launch_counts", "fused_qkv_attention", "reference_attention",
           "gn_adagn_silu", "gn_adagn_silu_fwd", "fused_gn_adagn_silu",
           "reference_gn_adagn_silu", "gn_adagn_silu_train",
           "gn_adagn_silu_bwd_plain"]
