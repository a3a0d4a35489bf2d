"""Processes of one run: the port of ``pdae_tpu/parallel/dist.py``.

A run of several processes is started by ``torchrun``, whose environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
takes the place of ``JAX_COORDINATOR_ADDRESS``. Each process computes on
``cuda:LOCAL_RANK`` (``pdae_torch.resolve_device``). Two groups join the
processes:

* the default group, always ``gloo``: host objects (metric results, latents,
  images, features, stop flags) go between processes pickled over it, as
  ``process_allgather`` of pickled bytes does in JAX, and the barrier;
* the tensor group, over which a data-parallel train step averages its
  gradients and loss (``all_reduce_mean_``, where JAX's GSPMD inserts the
  all-reduce) and an FSDP step reduce-scatters its gradients and all-gathers
  its parameters (``reduce_scatter_mean_``, ``all_gather_into_``,
  ``gather_full``): ``nccl`` where each rank has a card of its own, else
  ``gloo``, which also lets two ranks share one card (NCCL refuses two ranks
  on one device) by moving CUDA tensors through host copies: gloo's own
  all-reduce does so, and the reduce-scatter and the all-gather stage their
  flat buffers through the host here, as part of the gloo transport.
  ``init_distributed``'s ``backend`` names it; nothing falls back from one
  backend to the other.

Without ``WORLD_SIZE`` > 1 and without a ``backend`` every function here is
the one-process identity: count 1, index 0, the whole index range, the local
list, and no tensor group.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


_TENSOR_GROUP = None
_TENSOR_BACKEND: Optional[str] = None


def default_backend() -> str:
    """The tensor group's backend where the caller names none: ``nccl`` where
    a card is available and this host's ranks (``LOCAL_WORLD_SIZE``, else
    ``WORLD_SIZE``) have one each, else ``gloo``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if torch.cuda.is_available() and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(backend: Optional[str] = None) -> None:
    """Join the process group that torchrun's environment describes, and
    form the tensor group over ``backend`` (``"nccl"`` or ``"gloo"``; None:
    ``default_backend()``). A no-op when the group exists already, and
    without ``WORLD_SIZE`` > 1 unless a ``backend`` is named: a named
    backend forms the groups for a world of one too (``MASTER_ADDR`` and
    ``MASTER_PORT`` set), whose reduction is exact. With a card, the
    process's current device becomes ``cuda:LOCAL_RANK``, so the kernels
    launch on the card its tensors are on."""
    global _TENSOR_GROUP, _TENSOR_BACKEND
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or (world <= 1 and backend is None):
        return
    backend = default_backend() if backend is None else backend
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"the tensor group's backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("an NCCL tensor group needs a CUDA device")
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo", init_method="env://",
                            rank=int(os.environ.get("RANK", "0")), world_size=world)
    _TENSOR_GROUP = dist.new_group(backend="nccl") if backend == "nccl" else dist.group.WORLD
    _TENSOR_BACKEND = backend


def tensor_backend() -> Optional[str]:
    """The tensor group's backend, None without a group."""
    return _TENSOR_BACKEND if dist.is_initialized() else None


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


def all_reduce_mean_(tensors: Sequence[torch.Tensor], buffer: torch.Tensor,
                     group=None, mean: bool = True) -> None:
    """Each of ``tensors`` (on one device) replaced in place by its mean
    (its sum where not ``mean``) over the processes of ``group`` (None: the
    tensor group): the tensors are copied into the flat
    fp32 ``buffer`` (at least their total size), reduced there with one
    ``all_reduce(SUM)``, divided by the world size (gloo has no ``AVG``) and
    copied back in their own dtypes. Over NCCL it does not wait for the
    card, so a CUDA graph can capture it; the buffer is the same memory at
    every call. Collective: every process of the group must call it."""
    n = sum(t.numel() for t in tensors)
    flat = buffer[:n]
    views, offset = [], 0
    for t in tensors:
        views.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    with torch.no_grad():
        torch._foreach_copy_(views, list(tensors))
        group = _TENSOR_GROUP if group is None else group
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if mean:
            flat.div_(dist.get_world_size(group))
        torch._foreach_copy_(list(tensors), views)


def mean_all_reducer(numel: int, device, group=None,
                     mean: bool = True) -> Optional[Callable[[Sequence[torch.Tensor]], None]]:
    """``reduce(tensors)``: ``all_reduce_mean_`` over ``group`` (None: the
    tensor group) through one flat fp32 buffer of ``numel`` elements on
    ``device``, allocated here, once, before any step is captured; None
    without a tensor group, so that one process issues no collective. One
    reduction runs here, so an NCCL communicator is built before any
    capture. Collective."""
    if tensor_backend() is None:
        return None
    group = _TENSOR_GROUP if group is None else group
    buffer = torch.zeros(int(numel), dtype=torch.float32, device=device)
    dist.all_reduce(buffer[:1], group=group)

    def reduce(tensors):
        all_reduce_mean_(tensors, buffer, group, mean)
    return reduce


def new_tensor_group(ranks: Sequence[int]):
    """A subgroup of the tensor group over ``ranks``, on the tensor group's
    backend (the same rule, no fallback). Collective over the default group:
    every process calls it for every subgroup, in the same order."""
    return dist.new_group(ranks=list(ranks), backend=_TENSOR_BACKEND)


def tensor_group():
    """The tensor group (None without one)."""
    return _TENSOR_GROUP if dist.is_initialized() else None



# gloo moves a large buffer through one TCP pair per collective; pieces of
# about this many bytes, issued at once, travel over its worker threads
# together (on a one-card host, two ranks' all-gather of 64 MB: 0.3 GB/s in
# one piece, 1.0 GB/s in 8)
GLOO_PIECE_BYTES = 1 << 22
GLOO_MAX_PIECES = 16


def host_stage(t: torch.Tensor) -> torch.Tensor:
    """A host copy of the CUDA tensor ``t`` in page-locked memory (PyTorch's
    caching host allocator keeps the blocks for the next call), taken when
    this returns."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _pieces(n: int, itemsize: int) -> List[tuple]:
    """``(offset, length)`` pieces of a flat buffer of ``n`` elements."""
    k = max(1, min(GLOO_MAX_PIECES, n * itemsize // GLOO_PIECE_BYTES))
    step = -(-n // k)
    return [(o, min(step, n - o)) for o in range(0, n, step)]


def _gloo_all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``all_gather_into_tensor`` of host ``inp`` (flat, n) into ``out``
    (flat, world * n), in pieces issued together."""
    world, n = dist.get_world_size(group), inp.numel()
    parts = _pieces(n, inp.element_size())
    if len(parts) == 1:
        dist.all_gather_into_tensor(out, inp, group=group)
        return
    bufs = [torch.empty(world * m, dtype=inp.dtype) for _, m in parts]
    works = [dist.all_gather_into_tensor(b, inp[o:o + m], group=group, async_op=True)
             for b, (o, m) in zip(bufs, parts)]
    rows = out.view(world, n)
    for w, b, (o, m) in zip(works, bufs, parts):
        w.wait()
        rows[:, o:o + m].copy_(b.view(world, m))


def _gloo_reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``reduce_scatter_tensor(SUM)`` of host ``inp`` (flat, world * n) into
    ``out`` (flat, n), in pieces issued together."""
    world, n = dist.get_world_size(group), out.numel()
    parts = _pieces(n, out.element_size())
    if len(parts) == 1:
        dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, group=group)
        return
    rows = inp.view(world, n)
    works = [dist.reduce_scatter_tensor(out[o:o + m], rows[:, o:o + m].reshape(-1),
                                        op=dist.ReduceOp.SUM, group=group, async_op=True)
             for o, m in parts]
    for w in works:
        w.wait()


def gloo_all_reduce_(t: torch.Tensor, group) -> None:
    """``all_reduce(SUM)`` of the contiguous host tensor ``t`` in place, in
    pieces issued together."""
    flat = t.view(-1)
    works = [dist.all_reduce(flat[o:o + m], group=group, async_op=True)
             for o, m in _pieces(flat.numel(), flat.element_size())]
    for w in works:
        w.wait()


def _through_host(kind: str, out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """The collective ``kind`` (``all_gather``: ``out`` flat world * n from
    ``inp`` flat n; ``reduce_scatter``: the sum's rank piece) over ``group``,
    of the tensor group's backend. Over gloo, CUDA tensors go through
    page-locked host copies (the gloo transport of a card's tensors), and a
    large buffer travels in pieces."""
    if _TENSOR_BACKEND != "gloo":
        if kind == "all_gather":
            dist.all_gather_into_tensor(out, inp, group=group)
        else:
            dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, group=group)
        return
    run = _gloo_all_gather if kind == "all_gather" else _gloo_reduce_scatter
    if not (out.is_cuda or inp.is_cuda):
        run(out, inp, group)
        return
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    run(host, host_stage(inp) if inp.is_cuda else inp, group)
    out.copy_(host)


def reduce_scatter_mean_(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """``out`` (flat, n elements) replaced by the mean over the processes of
    their ``inp[rank * n:(rank + 1) * n]`` (``inp`` flat, world * n): one
    ``reduce_scatter(SUM)``, then a division by the world size, as
    ``all_reduce_mean_`` divides. Over NCCL it does not wait for the card, so
    a CUDA graph can capture it. ``group``: None, the tensor group.
    Collective."""
    group = _TENSOR_GROUP if group is None else group
    with torch.no_grad():
        _through_host("reduce_scatter", out, inp, group)
        out.div_(dist.get_world_size(group))


def all_gather_into_(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """``out`` (flat, world * n elements) filled with every process's ``inp``
    (flat, n) in rank order: one ``all_gather``. Over NCCL it does not wait
    for the card (capturable). ``group``: None, the tensor group.
    Collective."""
    group = _TENSOR_GROUP if group is None else group
    with torch.no_grad():
        _through_host("all_gather", out, inp, group)


def all_gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` ranks of ``group``'s ``x`` concatenated along ``dim`` in rank
    order (the tensor group's backend; over gloo, a card's tensors through
    the host). Collective; no gradient."""
    dim %= x.ndim
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    all_gather_into_(out.view(-1), x.view(-1), group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``group``'s ``x``, a new tensor. Collective; no gradient."""
    with torch.no_grad():
        if _TENSOR_BACKEND == "gloo" and x.is_cuda:
            host = host_stage(x.contiguous())
            gloo_all_reduce_(host, group)
            return host.to(x.device)
        out = x.contiguous().clone()
        if _TENSOR_BACKEND == "gloo":
            gloo_all_reduce_(out, group)
        else:
            dist.all_reduce(out, group=group)
        return out


def reduce_scatter_dim(x: torch.Tensor, group, n: int, index: int, dim: int) -> torch.Tensor:
    """Rank ``index``'s block along ``dim`` of the sum of the ``n`` ranks of
    ``group``'s ``x``. Collective; no gradient."""
    dim %= x.ndim
    blk = x.shape[dim] // n
    with torch.no_grad():
        stacked = x.unflatten(dim, (n, blk)).movedim(dim, 0).contiguous()
        out = torch.empty(stacked.shape[1:], dtype=x.dtype, device=x.device)
        _through_host("reduce_scatter", out.view(-1), stacked.view(-1), group)
        return out


def gather_full(shards: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                group=None) -> List[torch.Tensor]:
    """The whole tensors of which every process holds ``shards``, split
    evenly along ``dims`` in rank order (None: the tensor is whole on every
    process and comes back as it is), on the shards' device, through one
    all-gather of a flat fp32 buffer made for the call. The port's
    ``host_copy_tree``, without the trip through the host. Without a tensor
    group the shards are the whole tensors. ``group``: None, the tensor
    group. Collective."""
    if tensor_backend() is None:
        return list(shards)
    group = _TENSOR_GROUP if group is None else group
    world = dist.get_world_size(group)
    split = [(t, d) for t, d in zip(shards, dims) if d is not None]
    if not split:
        return list(shards)
    total = sum(t.numel() for t, _ in split)
    with torch.no_grad():
        inp = torch.cat([t.detach().reshape(-1).float() for t, _ in split])
        out = torch.empty(world * total, dtype=torch.float32, device=inp.device)
        all_gather_into_(out, inp, group)
        rows = out.view(world, total)
        whole, offset = {}, 0
        for t, d in split:
            n = t.numel()
            parts = rows[:, offset:offset + n].reshape(world, *t.shape)
            shape = list(t.shape)
            shape[d] *= world
            whole[id(t)] = parts.movedim(0, d).reshape(shape).to(t.dtype)
            offset += n
    return [whole[id(t)] if d is not None else t for t, d in zip(shards, dims)]
