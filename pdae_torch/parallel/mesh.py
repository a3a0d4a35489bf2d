"""The layout rules of ``pdae_tpu/parallel/mesh.py`` as pure functions of a
flax leaf's shape: which of its dims FSDP (``fsdp_sharding``), tensor
parallelism (``tp_sharding``) and both together (``fsdp_tp_sharding``) split,
or none; and a rank's place on the ``[data, model]`` grid (``make_tp_mesh``),
on the ``[data, sp]`` grid (``make_sp_mesh``) and on the ``[rows, cols]``
host grid of ``mesh_layout: hier`` (``make_hier_mesh``).

``pdae_tpu`` lays a leaf out over the data axis of its mesh by this rule; the
port's ``param_sharding: fsdp`` (``training/fsdp.py``) applies it to the
same leaves, in the flax layout, so each process holds the slices that the
JAX process of that rank holds.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def tp_dim(shape: Sequence[int], tp: int, min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dim of a flax leaf of ``shape`` that tensor parallelism shards
    over ``tp`` model ranks (``pdae_tpu``'s ``tp_sharding``): None for ``tp``
    1, for fewer than 2 dims and below ``min_size`` elements; else the last
    dim (the out channels: column-parallel) where it is at least ``tp`` and
    divisible by it, else dim -2 (the in channels: row-parallel) on the same
    terms, else None (the leaf stays whole on every rank)."""
    ndim = len(shape)
    if tp == 1 or ndim < 2 or int(np.prod(shape)) < min_size:
        return None
    for i in (ndim - 1, ndim - 2):
        if shape[i] >= tp and shape[i] % tp == 0:
            return i
    return None


def fsdp_tp_dims(shape: Sequence[int], dp: int, tp: int,
                 min_size: int = FSDP_MIN_SIZE) -> Tuple[Optional[int], Optional[int]]:
    """``(tp dim, data dim)`` of a flax leaf of ``shape`` under ``fsdp+tp``
    (``pdae_tpu``'s ``fsdp_tp_sharding``): below ``min_size`` elements (of
    the whole shape) neither; else the tp dim by ``tp_dim``'s order, then the
    largest other dim that is at least ``dp`` and divisible by it (ties to
    the lower dim) for the data axis."""
    ndim = len(shape)
    if int(np.prod(shape)) < min_size:
        return None, None
    model = None
    if ndim >= 2 and tp > 1:
        for i in (ndim - 1, ndim - 2):
            if shape[i] >= tp and shape[i] % tp == 0:
                model = i
                break
    data = None
    if dp > 1:
        for i in sorted((i for i in range(ndim) if i != model), key=lambda i: shape[i],
                        reverse=True):
            if shape[i] >= dp and shape[i] % dp == 0:
                data = i
                break
    return model, data


def tp_coords(rank: int, world: int, tp: int) -> Tuple[int, int]:
    """``(data index, model index)`` of ``rank`` on ``pdae_tpu``'s
    ``reshape(world // tp, tp)`` grid: a row is a data replica, a column a
    model rank. Raises ``pdae_tpu``'s ``ValueError`` where ``tp`` does not
    divide ``world``."""
    if tp < 1 or world % tp:
        raise ValueError(f"model_size={tp} must divide the device count {world}")
    return rank // tp, rank % tp


def sp_coords(rank: int, world: int, sp: int) -> Tuple[int, int]:
    """``(data index, sp index)`` of ``rank`` on ``pdae_tpu``'s
    ``reshape(world // sp, sp)`` grid (``make_sp_mesh``): a row is a data
    replica, a column a rank's share of every image's rows. Raises
    ``pdae_tpu``'s ``ValueError`` where ``sp`` does not divide ``world``."""
    if sp < 1 or world % sp:
        raise ValueError(f"sp_size={sp} must divide the device count {world}")
    return rank // sp, rank % sp


def hier_shape(world: int, local_world: int,
               shape: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """``(rows, cols)`` of the host grid of ``pdae_tpu``'s ``make_hier_mesh``
    over ``world`` ranks: a row a host, a column a card of each host. Without
    ``shape`` a host is the ``local_world`` ranks that torchrun numbers
    together (``LOCAL_WORLD_SIZE``): ``world // local_world`` rows of
    ``local_world``, and ``pdae_tpu``'s ``ValueError`` where ``local_world``
    does not divide ``world``. ``shape`` (``runner_config.hier_shape``)
    must cover the world: a process group cannot leave ranks out as a JAX
    mesh leaves devices out."""
    if shape is not None:
        rows, cols = (int(v) for v in shape)
        if rows < 1 or cols < 1 or rows * cols != world:
            raise ValueError(f"runner_config.hier_shape={list(shape)} must cover the "
                             f"world of {world} processes (rows * cols == {world})")
        return rows, cols
    if local_world < 1 or world % local_world:
        counts = [local_world] * (world // max(local_world, 1))
        if world % max(local_world, 1):
            counts.append(world % max(local_world, 1))
        raise ValueError(f"uneven device count per process: {counts}")
    return world // local_world, local_world


def hier_coords(rank: int, world: int, rows: int, cols: int) -> Tuple[int, int]:
    """``(row, column)`` of ``rank`` on the ``[rows, cols]`` host grid
    (``make_hier_mesh``'s ``devices[:rows * cols].reshape(rows, cols)``): the
    row is its host (``dcn``), the column its card there (``ici``), the
    FSDP axis."""
    if rows * cols != world:
        raise ValueError(f"a [{rows}, {cols}] grid does not cover {world} processes")
    return rank // cols, rank % cols
