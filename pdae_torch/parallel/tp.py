"""Tensor parallelism (``param_sharding: tp`` and ``fsdp+tp``, the service's
``tp_size``): the port of ``pdae_tpu``'s ``[data, model]`` mesh
(``parallel/mesh.py``'s ``make_tp_mesh`` and ``tp_sharding``), with the math
and the activations split as GSPMD splits them there.

**The grid.** Rank ``r`` of a world ``W`` has data index ``r // tp`` and
model index ``r % tp`` (``reshape(W // tp, tp)``). The *model group* holds
the ``tp`` consecutive ranks of one data index, the *data group* the ranks
that share a model index; both are subgroups of the tensor group, on its
backend (``dist.new_tensor_group``).

**At rest.** ``shard_module`` lays a module out by ``pdae_tpu``'s rule
(``mesh.tp_dim``) on each parameter's flax leaf, found with the probe map of
``training/fsdp.py`` (``layout``): a sharded parameter is replaced by the
rank's block of it, a tensor of its own; vectors, small leaves and leaves
with no dividing dim stay whole. A whole state dict still loads into the
module (a pre-hook cuts each sharded tensor to the block).

**The math.** A layer whose weight is sharded on its out dim runs
column-parallel: the whole input times the block gives the rank's out
channels, plus the rank's slice of the bias. One sharded on its in dim runs
row-parallel: the rank's slice of the input channels times the block gives a
partial sum, summed over the model group, then the whole bias is added. No
sharded parameter is gathered. A GroupNorm(+AdaGN)+SiLU chain whose groups
divide by ``tp`` runs its kernel on the rank's channel block with ``groups //
tp`` groups; the attention of ``models/blocks.py`` runs on the rank's heads
where the qkv block holds whole heads. Between a column-parallel layer and
the next op that needs every channel, the activation is the rank's channel
block, gathered at that op; the residual stream is whole on every rank of a
model group.

**The backward.** The collectives are ``torch.autograd.Function``s: a
gather's backward takes the rank's slice of the gradient, a slice's backward
gathers the gradients, the input of a column-parallel layer sums its
gradient over the model group (fused with the gather before it into one
reduce-scatter), and the partial sums' reduction passes its gradient
through. A parameter's gradient then has one of three roles: ``block`` (the
rank's block, complete), ``whole`` (used on whole activations: the same on
every rank of the model group) and ``sliced`` (a whole vector of which the
rank used its slice: a column-parallel bias, a split chain's scale and bias;
its gradient is zero outside the slice and is summed over the model group).
``Layout.reducer`` sums the ``sliced`` ones over the model group, then
averages every gradient and the loss over the data group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import dist as pdist
from .mesh import tp_coords, tp_dim


@dataclasses.dataclass
class Groups:
    """This rank's place on the ``[data, model]`` grid and its two groups
    (None where no tensor group exists: a world of one)."""
    tp: int
    dp: int
    model_index: int
    data_index: int
    model_group: object = None
    data_group: object = None


_GROUPS: Dict[int, Groups] = {}


def tp_groups(tp_size: Optional[int] = None) -> Groups:
    """The grid of ``tp_size`` model ranks (None: the whole world) over the
    processes, and its model and data groups, made once per size on every
    rank in the same order (``new_group`` is collective). Raises
    ``pdae_tpu``'s ``ValueError`` where ``tp_size`` does not divide the
    world."""
    rank, world = pdist.process_index(), pdist.process_count()
    tp = world if tp_size is None else int(tp_size)
    data_index, model_index = tp_coords(rank, world, tp)
    if tp in _GROUPS:
        return _GROUPS[tp]
    groups = Groups(tp, world // tp, model_index, data_index)
    if pdist.tensor_backend() is not None:
        whole = pdist.tensor_group()
        model = [whole if tp == world else pdist.new_tensor_group(range(d * tp, (d + 1) * tp))
                 for d in range(world // tp)]
        data = [whole if tp == 1 else pdist.new_tensor_group(range(m, world, tp))
                for m in range(tp)]
        groups.model_group, groups.data_group = model[data_index], data[model_index]
    _GROUPS[tp] = groups
    return groups


# --------------------------------------------------------------------- #
# collectives over the model group, through the host over gloo
# --------------------------------------------------------------------- #

def _all_gather(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order."""
    return pdist.all_gather_dim(x, g.model_group, g.tp, dim)


def _all_reduce(x: torch.Tensor, g: Groups) -> torch.Tensor:
    """The sum of every model rank's ``x``."""
    return pdist.all_reduce_sum(x, g.model_group)


def _reduce_scatter(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every model rank's
    ``x``."""
    return pdist.reduce_scatter_dim(x, g.model_group, g.tp, g.model_index, dim)


def own(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, contiguous."""
    blk = x.shape[dim] // g.tp
    return x.narrow(dim, g.model_index * blk, blk).contiguous()


class _Gather(torch.autograd.Function):
    """Block -> whole: forward all-gather, backward the rank's slice."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return own(grad, ctx.g, ctx.dim), None, None


class _GatherIn(torch.autograd.Function):
    """Block -> whole input of a column-parallel layer: forward all-gather,
    backward the sum of the ranks' partial gradients, scattered: one
    reduce-scatter."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.g, ctx.dim), None, None


class _Slice(torch.autograd.Function):
    """Whole -> block: forward the rank's slice (contiguous), backward the
    all-gather of the slices' gradients."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return own(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.g, ctx.dim), None, None


class _CopyIn(torch.autograd.Function):
    """The whole input of a column-parallel layer: forward the identity,
    backward the sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None


class _ReduceOut(torch.autograd.Function):
    """The partial sums of a row-parallel layer: forward their sum over the
    model group, backward the identity."""

    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    return _Gather.apply(x, g, dim)


def split(x: torch.Tensor, g: Groups, dim: int) -> torch.Tensor:
    return _Slice.apply(x, g, dim)


# --------------------------------------------------------------------- #
# the layers' split forwards
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class Split:
    """What a layer of a sharded module does: ``kind`` is ``col``/``row``
    (a conv, Linear or Embedding), ``gn`` (a chain on the channel block) or
    ``block`` (a ResBlock or AttentionBlock, whose forward splits its
    insides)."""
    groups: Groups
    kind: str


def _apply(layer, x, weight, bias):
    """``layer``'s op with the given weight and bias (its compute dtype)."""
    if isinstance(layer, nn.Embedding):
        return F.embedding(x, weight)
    dt = layer.compute_dtype
    b = None if bias is None else bias.to(dt)
    if isinstance(layer, nn.Linear):
        return F.linear(x.to(dt), weight.to(dt), b)
    return layer._conv_forward(x.to(dt), weight.to(dt), b)


def dense(layer, x: torch.Tensor, block: bool, keep_block: bool, dim: int,
          groups: Optional[Groups] = None):
    """``(y, y is a block)``: a conv (channel ``dim`` 1), Linear (-1) or
    Embedding of a sharded module on ``x`` (the rank's channel block, to be
    gathered over ``groups`` for a whole layer, where ``block``); a
    column-parallel layer's output stays the block where ``keep_block``,
    every other output is whole."""
    spec = getattr(layer, "tp", None)
    if spec is None:
        if block:
            x = gather(x, groups, dim)
        return layer(x), False
    g = spec.groups
    bias = getattr(layer, "bias", None)
    if spec.kind == "col":
        if isinstance(layer, nn.Embedding):
            x_in = x
        else:
            x_in = _GatherIn.apply(x, g, dim) if block else _CopyIn.apply(x, g)
        if bias is not None:
            n = bias.shape[0] // g.tp
            bias = bias.narrow(0, g.model_index * n, n)
        y = _apply(layer, x_in, layer.weight, bias)
        out_dim = -1 if isinstance(layer, (nn.Linear, nn.Embedding)) else 1
        if keep_block:
            return y, True
        return gather(y, g, out_dim), False
    x_in = x if block else split(x, g, dim)
    y = _ReduceOut.apply(_apply(layer, x_in, layer.weight, None), g)
    if bias is not None:
        bias = bias.to(layer.compute_dtype)
        y = y + (bias if isinstance(layer, nn.Linear) else
                 bias.view(-1, *([1] * (y.ndim - 2))))
    return y, False


def gn_chain(chain, x: torch.Tensor, block: bool, scale=None, shift=None, z_scale=None,
             z_shift=None, groups: Optional[Groups] = None):
    """``(h, h is a block)``: a GroupNorm(+AdaGN)+SiLU chain of a sharded
    module. Where its groups divide by ``tp`` (``chain.tp``) the kernel runs
    on the rank's channel block with ``groups // tp`` groups, its scale and
    bias sliced; ``scale``/``shift``/``z_*`` are then the rank's channels.
    Otherwise the chain runs whole (``x`` gathered over ``groups`` first
    where it is a block) and the AdaGN inputs are whole."""
    from .. import ops
    spec = getattr(chain, "tp", None)
    if spec is None:
        if block:
            x = gather(x, groups, 1)
        return chain(x, scale, shift, z_scale, z_shift), False
    g = spec.groups
    if not block:
        x = split(x, g, 1)
    n = chain.weight.shape[0] // g.tp
    w = chain.weight.narrow(0, g.model_index * n, n)
    b = chain.bias.narrow(0, g.model_index * n, n)
    return ops.gn_adagn_silu(x, w, b, scale, shift, z_scale, z_shift,
                             chain.groups // g.tp), True


def dropout(drop: nn.Dropout, h: torch.Tensor, block: bool, g: Groups) -> torch.Tensor:
    """``drop`` on ``h``; on a channel block, the mask of the whole
    activation drawn (every rank of a model group draws the same, from its
    data index's seed) and the rank's slice of it taken."""
    if not block or not drop.training or drop.p == 0:
        return drop(h)
    shape = list(h.shape)
    shape[1] *= g.tp
    mask = F.dropout(torch.ones(shape, dtype=h.dtype, device=h.device), drop.p, True)
    return h * own(mask, g, 1)


# --------------------------------------------------------------------- #
# the layout of a module
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class Info:
    """A parameter of a sharded module: its ``role`` (module docstring), the
    torch dim its block splits (None: whole), its whole shape, and its flax
    leaf's path, whole shape and split dim."""
    role: str
    torch_dim: Optional[int]
    shape: tuple
    flax_path: str
    flax_shape: tuple
    flax_dim: Optional[int]


def tp_rule(tp: int, min_size: int) -> Callable:
    """``training.fsdp.layout``'s ``rule`` for ``mesh.tp_dim``: the one dim,
    no other to try."""
    def rule(group, name, shape):
        dim = tp_dim(shape, tp, min_size)
        return dim, ([] if dim is None else [dim])
    return rule


def shard_module(module: nn.Module, to_tree: Callable, g: Groups,
                 min_size: int) -> Dict[nn.Parameter, Info]:
    """Lay ``module`` out over the model group (module docstring): each
    sharded parameter replaced by the rank's block, the layers told their
    split (``.tp``), a whole state dict still loadable. ``to_tree`` maps its
    state dict to the flax tree. Returns ``{parameter: Info}`` of every
    parameter. A leaf whose rule dim matches no torch dim (the encoder's
    ``final_dense`` sharded on its ``H*W*C`` dim) raises."""
    from ..models.blocks import AttentionBlock, GNSiluChain, ResBlock
    from ..training.fsdp import layout
    named = dict(module.named_parameters())
    if g.tp == 1:
        return {p: Info("whole", None, tuple(p.shape), "", (), None)
                for p in named.values()}
    leaves, exceptions = layout({"m": named}, {"m": to_tree}, g.tp, min_size,
                                tp_rule(g.tp, min_size))
    if exceptions:
        raise ValueError(f"tensor parallelism cannot split {exceptions[0][0]} on its flax "
                         f"dim {exceptions[0][1]}: no torch dim carries it")
    owners = {}       # every name of a parameter, duplicates too -> (module, attr)
    for mname, sub in module.named_modules(remove_duplicate=False):
        for pname, _ in sub.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = (sub, pname)
    infos: Dict[str, Info] = {}
    cut: Dict[str, tuple] = {}      # state-dict key -> (torch dim, block)
    for lf in leaves:
        p = named[lf.name]
        infos[lf.name] = Info("whole", lf.torch_dim, tuple(p.shape), lf.flax_path,
                              lf.flax_shape, lf.flax_dim)
        if lf.torch_dim is None:
            continue
        infos[lf.name].role = "block"
        blk = p.shape[lf.torch_dim] // g.tp
        with torch.no_grad():
            block = nn.Parameter(p.detach().narrow(lf.torch_dim, g.model_index * blk, blk)
                                 .clone(memory_format=torch.contiguous_format),
                                 requires_grad=p.requires_grad)
        sub, pname = owners[lf.name]
        setattr(sub, pname, block)
        for key, (o, a) in owners.items():
            if o is sub and a == pname:
                cut[key] = (lf.torch_dim, blk, tuple(p.shape))
    for mname, sub in module.named_modules():
        prefix = f"{mname}." if mname else ""
        w = infos.get(prefix + "weight")
        if isinstance(sub, (ResBlock, AttentionBlock)):
            sub.tp = Split(g, "block")
        elif isinstance(sub, GNSiluChain):
            if sub.groups % g.tp == 0:
                sub.tp = Split(g, "gn")
                for leaf in ("weight", "bias"):
                    infos[prefix + leaf].role = "sliced"
        elif w is not None and w.role == "block":
            if not hasattr(sub, "tp"):
                raise TypeError(f"{mname}: a {type(sub).__name__} cannot run split")
            col = w.torch_dim == (1 if isinstance(sub, nn.Embedding) else 0)
            if isinstance(sub, nn.Embedding) and not col:
                raise ValueError(f"{mname}: an embedding split over its rows")
            sub.tp = Split(g, "col" if col else "row")
            if col and prefix + "bias" in infos:
                infos[prefix + "bias"].role = "sliced"

    def cut_whole(state_dict, prefix, *args):
        for key, (d, blk, shape) in cut.items():
            t = state_dict.get(prefix + key)
            if t is not None and tuple(t.shape) == shape:
                state_dict[prefix + key] = t.narrow(d, g.model_index * blk, blk)
    module._register_load_state_dict_pre_hook(cut_whole)
    return {p: infos[name] for name, p in module.named_parameters()}


class Layout:
    """The tensor-parallel layout of the modules of a trainer or a service:
    ``add`` each module as it is sharded; then ``local`` cuts a whole tensor
    to a parameter's block, ``gather`` makes whole copies, and ``reducer``
    builds the train step's gradient reduction."""

    def __init__(self, groups: Groups, min_size: int):
        self.groups, self.min_size = groups, min_size
        self.infos: Dict[nn.Parameter, Info] = {}

    def add(self, module: nn.Module, to_tree: Callable) -> None:
        self.infos.update(shard_module(module, to_tree, self.groups, self.min_size))

    def info(self, p) -> Info:
        return self.infos[p]

    def local(self, p, whole: torch.Tensor) -> torch.Tensor:
        """The rank's block of ``whole`` (shaped as ``p``'s whole tensor)."""
        info = self.infos.get(p)
        if info is None or info.torch_dim is None or tuple(whole.shape) != info.shape:
            return whole
        blk = info.shape[info.torch_dim] // self.groups.tp
        return whole.narrow(info.torch_dim, self.groups.model_index * blk, blk)

    def whole_shape(self, p) -> tuple:
        info = self.infos.get(p)
        return tuple(p.shape) if info is None else info.shape

    def gather(self, tensors: Sequence[torch.Tensor], params: Sequence) -> List[torch.Tensor]:
        """Whole copies of ``tensors``, each held as the block of the
        parameter at its place in ``params``: one all-gather over the model
        group. Collective."""
        dims = [self.infos[p].torch_dim if p in self.infos else None for p in params]
        return pdist.gather_full(list(tensors), dims, self.groups.model_group)

    def model_sum(self, params: Sequence, device) -> Optional[Callable]:
        """``sum(grads)``: the ``sliced`` ones of ``grads`` (in ``params``'
        order) summed over the model group, in place, through one buffer
        made here; None where none is sliced."""
        mine = [i for i, p in enumerate(params) if self.infos[p].role == "sliced"]
        if not mine or self.groups.tp == 1 or self.groups.model_group is None:
            return None
        reduce = pdist.mean_all_reducer(sum(params[i].numel() for i in mine), device,
                                        self.groups.model_group, mean=False)

        def sum_(grads):
            reduce([grads[i] for i in mine])
        return sum_

    def reducer(self, params: Sequence, device) -> Optional[Callable]:
        """The ``reduce([loss] + grads)`` of the train step under ``tp``:
        the ``sliced`` gradients summed over the model group, then the loss
        and every gradient averaged over the data group. Collective;
        capturable over NCCL."""
        model = self.model_sum(params, device)
        data = pdist.mean_all_reducer(1 + sum(p.numel() for p in params), device,
                                      self.groups.data_group)
        if model is None and data is None:
            return None

        def reduce(tensors):
            if model is not None:
                model(tensors[1:])
            if data is not None:
                data(tensors)
        return reduce

    def fsdp_rule(self, params: Dict[str, Dict]) -> Callable:
        """The rule of the FSDP plan over the data group under ``fsdp+tp``
        (``training.fsdp.layout``'s ``rule``; ``params`` as the plan takes
        them, the tp blocks): the data dim of ``pdae_tpu``'s
        ``fsdp_tp_sharding`` on the leaf's whole shape, the tp dim
        excluded."""
        from .mesh import fsdp_tp_dims
        g = self.groups

        def rule(group, name, shape):
            info = self.infos[params[group][name]]
            whole = list(shape)
            if info.flax_dim is not None:
                whole[info.flax_dim] *= g.tp
            _, dim = fsdp_tp_dims(whole, g.dp, g.tp, self.min_size)
            if dim is None:
                return None, []
            order = sorted(range(len(whole)), key=lambda i: whole[i], reverse=True)
            return dim, [d for d in order if d != info.flax_dim and whole[d] % g.dp == 0]
        return rule

    def piece_index(self, fsdp: bool):
        """``training.fsdp.local_pieces``'s ``index`` under ``tp`` (or
        ``fsdp+tp``): a split dim is the rule's tp dim (this rank's model
        index) or else the data dim (its data index); a piece is written by
        the ranks of index 0 on every axis it is not split over."""
        g = self.groups

        def index(want, split_dims):
            model = tp_dim(want, g.tp, self.min_size)
            if fsdp:
                from .mesh import fsdp_tp_dims
                model = fsdp_tp_dims(want, g.dp, g.tp, self.min_size)[0]
            at, on_model, on_data = {}, False, False
            for d in split_dims:
                if d == model:
                    at[d], on_model = g.model_index, True
                else:
                    at[d], on_data = g.data_index, True
            writes = (on_model or g.model_index == 0) and (on_data or g.data_index == 0)
            return at, writes
        return index


__all__ = ["Groups", "tp_groups", "Split", "Info", "Layout", "shard_module", "dense",
           "gn_chain", "dropout", "gather", "split", "own", "tp_rule"]
