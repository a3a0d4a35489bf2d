"""Processes of one run: the port of ``pdae_tpu/parallel/dist.py``.

A run of several processes is started by ``torchrun``, whose environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
takes the place of ``JAX_COORDINATOR_ADDRESS``. Host objects (metric
results, latents, images, features) go between processes pickled over a
``gloo`` group, as ``process_allgather`` of pickled bytes does in JAX: on
the card too, which also lets two ranks share one card, where NCCL refuses
two ranks on one device. Each process computes on ``cuda:LOCAL_RANK``
(``pdae_torch.resolve_device``).

Without ``WORLD_SIZE`` > 1 every function here is the one-process identity:
count 1, index 0, the whole index range, the local list.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def init_distributed() -> None:
    """Join the process group that torchrun's environment describes; a no-op
    without ``WORLD_SIZE`` > 1 and when the group exists already. With a
    card, the process's current device becomes ``cuda:LOCAL_RANK``, so the
    kernels launch on the card its tensors are on."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world)
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def dispatch_num_samples_for_process(total_num: int, rank: Optional[int] = None,
                                     world: Optional[int] = None) -> int:
    """How many of ``total_num`` samples this process generates: the floor of
    the share, and one more on each of the first ``total_num % world`` ranks."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return total_num // world + (1 if rank < total_num % world else 0)


def process_shard_indices(n: int, rank: Optional[int] = None, world: Optional[int] = None,
                          pad_to_even: bool = True) -> np.ndarray:
    """This process's indices of ``range(n)``: every ``world``-th from
    ``rank``. With ``pad_to_even`` the range is first wrapped (repeated from
    its start, as often as it takes when n < world) to a multiple of
    ``world``, so every process gets as many indices as the others."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    idx = np.arange(n)
    if pad_to_even and n and n % world != 0:
        pad = world - (n % world)
        reps = -(-pad // n)
        idx = np.concatenate([idx] + [idx[:n]] * reps)[:n + pad]
    return idx[rank::world]


def gather_objects(local_list) -> list:
    """Every process's ``local_list``, concatenated in rank order, on every
    process. The lists may differ in length and content; each is pickled
    whole. Collective: every process must call it."""
    if process_count() == 1:
        return list(local_list)
    parts = [None] * process_count()
    dist.all_gather_object(parts, list(local_list))
    return [obj for part in parts for obj in part]


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier across the processes (``name`` is for the reader: gloo's
    barrier has none)."""
    if process_count() > 1:
        dist.barrier()
