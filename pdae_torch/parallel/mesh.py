"""The FSDP rule of ``pdae_tpu/parallel/mesh.py`` (``fsdp_sharding``), as a
pure function of a leaf's shape: which of its dims a world of processes
splits, or none.

``pdae_tpu`` lays a leaf out over the data axis of its mesh by this rule; the
port's ``param_sharding: fsdp`` (``training/fsdp.py``) applies it to the
same leaves, in the flax layout, so each process holds the slices that the
JAX process of that rank holds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

FSDP_MIN_SIZE = 2 ** 15          # runner_config.fsdp_min_size's default


def fsdp_dim(shape: Sequence[int], world: int,
             min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dim of a leaf of ``shape`` that FSDP shards over ``world``
    processes: None below ``min_size`` elements, else the largest dim that
    is at least ``world`` and divisible by it (ties to the lower dim, the
    stable sort of ``pdae_tpu``'s rule), else None (the leaf stays whole on
    every process)."""
    if int(np.prod(shape)) < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[i] >= world and shape[i] % world == 0:
            return i
    return None
