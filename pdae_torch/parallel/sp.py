"""Spatial parallelism (``param_sharding: sp`` and ``fsdp+sp``, the service's
``sp_size``): the port of ``pdae_tpu``'s ``[data, sp]`` mesh
(``parallel/mesh.py``'s ``make_sp_mesh`` and ``constrain_spatial``), with
the activations split by image rows as GSPMD splits them there.

**The grid.** Rank ``r`` of a world ``W`` has data index ``r // sp`` and sp
index ``r % sp`` (``reshape(W // sp, sp)``). The *sp group* holds the ``sp``
consecutive ranks of one data index, the *data group* the ranks that share
an sp index; both are subgroups of the tensor group, on its backend. Every
rank of an sp group holds the same batch rows and the whole parameters.

**The split.** A model laid out with ``shard_rows`` takes its input whole
and keeps, of every NCHW activation whose height ``H`` divides by ``sp``,
the rank's ``H / sp`` contiguous rows; a map whose height does not divide
stays whole on every rank (``constrain_spatial``'s batch-only fallback): the
rows are gathered before the op whose output does not divide and cut again
after the op whose output does. The model's output is gathered, whole on
every rank. A 3x3 conv exchanges one halo row with each neighbour (zeros at
the image's top and bottom) and runs with padding ``(0, 1)``; a stride-2 one
needs the row above alone. A GroupNorm(+AdaGN)+SiLU chain runs the stats
pass, one all-reduce of the ``[B, G, 2]`` sums, then the apply pass
(``ops.gn_adagn_silu_split``); the attention's plain GroupNorm sums its
statistics the same way in torch ops; the attention runs the rank's query
rows against k and v gathered over the group in token order (``Tq < Tk``).
1x1 convs, the nearest upsample, the 2x2 pool and the skip concat are local
to the rows. Dropout draws the whole map's mask (every rank of an sp group
the same, from the data index's seed) and takes the rank's rows.

**The gradients.** One rule: an activation split by rows carries a gradient
complete for the rank's rows; a whole tensor (z, the embeddings, a gathered
map) carries the rank's partial gradient, whose sum over the sp group is the
gradient. So a gather's backward is a reduce-scatter (sum), a cut's backward
puts the rank's rows into zeros, the statistics' all-reduce is its own
backward, and every parameter gradient is the rank's partial sum: the train
step sums it over the sp group, then averages over the data group
(``grad_reducer``, ``grad_sum``). The model's output gather is the one exception: the loss
is computed from the whole output on every rank alike, so its gradient is
already whole and the gather's backward takes the rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dist as pdist
from .mesh import sp_coords


@dataclasses.dataclass
class Groups:
    """This rank's place on the ``[data, sp]`` grid and its two groups (None
    where no tensor group exists: a world of one)."""
    sp: int
    dp: int
    sp_index: int
    data_index: int
    sp_group: object = None
    data_group: object = None

    def splits(self, height: int) -> bool:
        """Whether a map of ``height`` rows is split over the sp group."""
        return self.sp > 1 and height % self.sp == 0


# one rank per image: nothing splits, and every helper below is the plain op
ONE = Groups(1, 1, 0, 0)

_GROUPS: Dict[int, Groups] = {}


def sp_groups(sp_size: Optional[int] = None) -> Groups:
    """The grid of ``sp_size`` ranks per image (None: the whole world) over
    the processes, and its sp and data groups, made once per size on every
    rank in the same order (``new_group`` is collective). Raises
    ``pdae_tpu``'s ``ValueError`` where ``sp_size`` does not divide the
    world."""
    rank, world = pdist.process_index(), pdist.process_count()
    sp = world if sp_size is None else int(sp_size)
    data_index, sp_index = sp_coords(rank, world, sp)
    if sp in _GROUPS:
        return _GROUPS[sp]
    groups = Groups(sp, world // sp, sp_index, data_index)
    if pdist.tensor_backend() is not None:
        whole = pdist.tensor_group()
        rows = [whole if sp == world else pdist.new_tensor_group(range(d * sp, (d + 1) * sp))
                for d in range(world // sp)]
        data = [whole if sp == 1 else pdist.new_tensor_group(range(i, world, sp))
                for i in range(sp)]
        groups.sp_group, groups.data_group = rows[data_index], data[sp_index]
    _GROUPS[sp] = groups
    return groups


# --------------------------------------------------------------------- #
# collectives over the sp group
# --------------------------------------------------------------------- #

def _all_gather(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    """Every sp rank's ``x`` concatenated along ``dim`` in rank order."""
    return pdist.all_gather_dim(x, g.sp_group, g.sp, dim)


def all_reduce(x: torch.Tensor, g: Groups) -> torch.Tensor:
    """The sum of every sp rank's ``x`` (a new tensor)."""
    return pdist.all_reduce_sum(x, g.sp_group)


def _reduce_scatter(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every sp rank's ``x``."""
    return pdist.reduce_scatter_dim(x, g.sp_group, g.sp, g.sp_index, dim)


def own(x: torch.Tensor, g: Groups, dim: int = 2) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (the rows), contiguous."""
    blk = x.shape[dim] // g.sp
    return x.narrow(dim, g.sp_index * blk, blk).contiguous()


def _placed(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    """``x``, the rank's block, placed in zeros of the whole shape."""
    shape = list(x.shape)
    shape[dim] *= g.sp
    out = x.new_zeros(shape)
    out.narrow(dim, g.sp_index * x.shape[dim], x.shape[dim]).copy_(x)
    return out


class _Gather(torch.autograd.Function):
    """Blocks -> whole (partial gradient): forward all-gather, backward the
    reduce-scatter (sum) of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.g, ctx.dim), None, None


class _Cut(torch.autograd.Function):
    """Whole (partial gradient) -> the rank's block: forward the cut,
    backward the block's gradient in zeros."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return own(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _placed(grad, ctx.g, ctx.dim), None, None


class _Enter(torch.autograd.Function):
    """A model's whole input -> the rank's rows: backward the all-gather of
    the rows' gradients (whole on every rank, as the caller's tensor)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return own(x, g, 2)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.g, 2), None


class _Leave(torch.autograd.Function):
    """The rank's rows of a model's output -> whole on every rank: the loss
    on it is the same on every rank, so the backward takes the rank's rows
    of its gradient."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_gather(x, g, 2)

    @staticmethod
    def backward(ctx, grad):
        return own(grad, ctx.g, 2), None


class _AllReduce(torch.autograd.Function):
    """The sum over the sp group of partial statistics; its backward is the
    same sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.g), None


def _boundaries(top: torch.Tensor, bottom: torch.Tensor, g: Groups):
    """Every sp rank's ``(top, bottom)`` rows, one all-gather: ``[sp, 2, ...]``."""
    return _all_gather(torch.stack([top, bottom]).unsqueeze(0), g, 0)


class _Halo(torch.autograd.Function):
    """The rank's rows with one halo row above (the previous rank's last row;
    zeros on the first rank) and, where ``below``, one below (the next rank's
    first row; zeros on the last). Backward: each halo row's gradient goes
    back to its owner and is added to that row's."""

    @staticmethod
    def forward(ctx, x, g, below):
        ctx.g, ctx.below = g, below
        every = _boundaries(x[:, :, :1], x[:, :, -1:], g)
        i = g.sp_index
        above = every[i - 1, 1] if i > 0 else torch.zeros_like(x[:, :, :1])
        rows = [above, x]
        if below:
            rows.append(every[i + 1, 0] if i < g.sp - 1 else torch.zeros_like(x[:, :, :1]))
        return torch.cat(rows, dim=2)

    @staticmethod
    def backward(ctx, grad):
        g, i = ctx.g, ctx.g.sp_index
        h = grad.shape[2] - (2 if ctx.below else 1)
        top = grad[:, :, :1]
        bottom = grad[:, :, -1:] if ctx.below else torch.zeros_like(top)
        every = _boundaries(top, bottom, g)
        dx = grad[:, :, 1:1 + h].clone()
        if i > 0:              # the previous rank's halo below is this rank's first row
            dx[:, :, :1] += every[i - 1, 1]
        if i < g.sp - 1:       # the next rank's halo above is this rank's last row
            dx[:, :, -1:] += every[i + 1, 0]
        return dx, None, None


# --------------------------------------------------------------------- #
# the layers' split forwards
# --------------------------------------------------------------------- #

def whole(x: torch.Tensor, g: Groups, height: int) -> torch.Tensor:
    """A map of ``height`` rows whole on every rank (gathered where split)."""
    return _Gather.apply(x, g, 2) if g.splits(height) else x


def rows(x: torch.Tensor, g: Groups, height: int) -> torch.Tensor:
    """A whole map of ``height`` rows laid out: the rank's rows where it
    splits."""
    return _Cut.apply(x, g, 2) if g.splits(height) else x


def enter(x: torch.Tensor, g: Groups) -> torch.Tensor:
    """A model's whole NCHW input laid out."""
    return _Enter.apply(x, g) if g.splits(x.shape[2]) else x


def leave(y: torch.Tensor, g: Groups, height: int) -> torch.Tensor:
    """A model's NCHW output of ``height`` rows, whole on every rank."""
    return _Leave.apply(y, g) if g.splits(height) else y


def resample(fn, x: torch.Tensor, g: Groups, h_in: int, h_out: int) -> torch.Tensor:
    """``fn`` (a nearest upsample or a 2x2 pool: local to the rows) from a
    map of ``h_in`` rows to one of ``h_out``: on the rows where both split,
    on the whole map where neither does, else through the whole map."""
    if g.splits(h_out) and g.splits(h_in):
        return fn(x)
    return rows(fn(whole(x, g, h_in)), g, h_out)


def conv(layer, x: torch.Tensor, g: Groups, height: int):
    """``(y, y's height)``: the 3x3 (stride 1 or 2, padding 1) or 1x1
    ``layer`` of ``models/blocks.py`` on a map of ``height`` rows. Split in
    and out: the halo rows, then the conv with padding ``(0, 1)``; where the
    output does not split, on the whole map."""
    stride, k = layer.stride[0], layer.kernel_size[0]
    h_out = height // stride
    if k == 1:
        return layer(x), h_out
    if not g.splits(h_out):
        return layer(whole(x, g, height)), h_out
    dt = layer.compute_dtype
    x = _Halo.apply(x.to(dt), g, stride == 1)
    y = F.conv2d(x, layer.weight.to(dt), layer.bias.to(dt), stride, (0, layer.padding[1]))
    return y, h_out


def chain(mod, x: torch.Tensor, g: Groups, height: int, scale=None, shift=None,
          z_scale=None, z_shift=None) -> torch.Tensor:
    """A GroupNorm(+AdaGN)+SiLU chain (``GNSiluChain``) on a map of
    ``height`` rows: the split passes where it splits, else the chain."""
    if not g.splits(height):
        return mod(x, scale, shift, z_scale, z_shift)
    from .. import ops
    return ops.gn_adagn_silu_split(x, mod.weight, mod.bias, scale, shift, z_scale, z_shift,
                                   mod.groups, lambda t: _AllReduce.apply(t, g), g.sp)


def group_norm(norm, x: torch.Tensor, g: Groups) -> torch.Tensor:
    """flax's ``GroupNorm(dtype=)`` (``models/blocks.py::GroupNorm``) on the
    rank's part ``[B, C, ...]`` of each slab: the fp32 sums of x and x^2
    summed over the sp group, the one-pass mean and variance (flax's
    ``max(E[x^2] - mean^2, 0)``), the affine in fp32, then the cast."""
    from .. import ops
    b, c = x.shape[:2]
    xg = x.float().reshape(b, norm.num_groups, -1)
    sums = ops.gn_stats_plain(x, norm.num_groups)
    mean, rstd = ops.moments_from_sums(_AllReduce.apply(sums, g), xg.shape[2] * g.sp)
    y = ((xg - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * norm.weight.view(shape) + norm.bias.view(shape)
    return y.to(norm.compute_dtype)


def gather_tokens(t: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    """Every rank's tokens of ``t`` along ``dim`` in token order (the rows
    are contiguous in the flatten); backward the reduce-scatter (sum)."""
    return _Gather.apply(t, g, dim)


def dropout(drop: nn.Dropout, h: torch.Tensor, g: Groups, height: int) -> torch.Tensor:
    """``drop`` on a map of ``height`` rows; where it splits, the whole map's
    mask drawn (the same on every rank of an sp group) and the rank's rows of
    it taken."""
    if not g.splits(height) or not drop.training or drop.p == 0:
        return drop(h)
    shape = list(h.shape)
    shape[2] *= g.sp
    mask = F.dropout(torch.ones(shape, dtype=h.dtype, device=h.device), drop.p, True)
    return h * own(mask, g, 2)


def shard_rows(module: nn.Module, g: Groups, height: int) -> list:
    """Lay ``module`` out over the sp group for inputs of ``height`` rows:
    where that height splits, each of its UNets, ShiftUNets and semantic
    encoders runs split (their ``sp``). Returns the modules laid out: the
    gradients of their parameters are the ranks' partial sums. Where the
    input does not split, no map below it does either, and the module runs
    whole on every rank, as a module without them (MLPSkipNet, the
    classifier) does: its gradients are whole on every rank."""
    if not g.splits(height):
        return []
    laid = [m for m in module.modules() if hasattr(type(m), "sp")]
    for m in laid:
        m.sp = g
    return laid


def piece_index(g: Groups):
    """``training.fsdp.local_pieces``'s ``index`` under ``sp`` and
    ``fsdp+sp``: a split dim is the FSDP plan's data dim (this rank's data
    index); the ranks of an sp group hold the same pieces, and its first
    writes them (a whole leaf: rank 0)."""
    def index(want, split_dims):
        at = {d: g.data_index for d in split_dims}
        return at, g.sp_index == 0 and (bool(split_dims) or g.data_index == 0)
    return index


def grad_reducer(numel: int, device, g: Groups, partial: bool = True):
    """The train step's ``reduce([loss] + grads)`` through a buffer of
    ``numel`` elements made here, one all-reduce; None in one process.
    Where ``partial`` (the models ran split: ``shard_rows`` laid some out),
    the gradients are the ranks' partial sums and the loss is whole on
    every rank: the world's mean of ``sp * grad`` (the sp group's sum
    averaged over the data group; ``sp`` a power of two scales exactly) and
    of the loss. Else every rank's gradients are whole, and the world's mean
    of them is the data group's."""
    world_mean = pdist.mean_all_reducer(numel, device)
    if world_mean is None or not partial:
        return world_mean
    scale = float(g.sp)

    def reduce(tensors):
        torch._foreach_mul_(list(tensors[1:]), scale)
        world_mean(tensors)
    return reduce


def grad_sum(numel: int, device, g: Groups, partial: bool = True):
    """``sum(grads)``: partial gradients summed over the sp group in place,
    one all-reduce through a buffer of ``numel`` elements (``fsdp+sp``'s
    pre-reduction, before the FSDP plan's over the data group); None where
    the gradients are whole on every rank (not ``partial``) or no sp group
    exists."""
    if not partial or g.sp == 1 or g.sp_group is None:
        return None
    return pdist.mean_all_reducer(numel, device, g.sp_group, mean=False)


__all__ = ["Groups", "ONE", "sp_groups", "all_reduce", "own", "whole", "rows", "enter", "leave",
           "resample", "conv", "chain", "group_norm", "gather_tokens", "dropout",
           "shard_rows", "piece_index", "grad_reducer", "grad_sum"]
