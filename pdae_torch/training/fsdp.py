"""FSDP over the tensor group (``runner_config.param_sharding: fsdp``): the
port of ``pdae_tpu``'s FSDP placement (``training/base.py``'s
``_tree_shardings`` and ``_place_frozen``, ``parallel/mesh.py``'s
``fsdp_shardings``) for a trainer's trained tensors and its frozen modules.

**The rule.** A tensor is held sharded when its leaf in the flax layout, the
layout of the checkpoints and of ``pdae_tpu``'s train state, passes
``pdae_tpu``'s rule (``parallel.fsdp_dim``): at least ``fsdp_min_size``
elements (2**15 by default), and a dim that is at least the world size and
divisible by it, the largest such dim, ties to the lower one. Every process
then holds the block of that dim that its rank gives it, and nothing more of
it: a trained tensor's master value (the optimizer's parameter), its EMA and
both Adam moments; a frozen tensor's value. The other tensors stay whole on
every process, as in JAX.

**The layout map.** The flax leaf of a torch tensor is read off the maps of
``utils/convert.py`` themselves (``encoder_tree``, ``unet_tree``, ...): a
probe tensor of element indices goes through the trainer's map once, and the
flax dim the rule picks is matched to the torch dim whose index it carries
(a conv's ``[kh,kw,I,O]`` dim 3 is the torch ``[O,I,kh,kw]`` dim 0, a
Linear's ``[I,O]`` dim 0 the torch dim 1). A rank's block of a matched dim is
then a block of the torch tensor, and the flax layout of the torch block is
the block of the flax leaf, so a rank writes its pieces of a sharded
checkpoint without a gather. One leaf has no such dim: the encoder's
``final_dense`` kernel ``[H*W*C, out]``, whose dim 0 is strided across the
torch ``[out, C*H*W]`` weight (a reshape and a permute). Of it the plan
shards the largest dim the rule allows that does match, its ``out`` (torch
dim 0), and lists it in ``exceptions`` (``frozen_exceptions`` for a frozen
encoder's); ``pdae_tpu`` shards its dim 0.

**Blocks at rest, gathered per use (ZeRO-3).** A sharded tensor's
``nn.Parameter`` stays in its module under its name, so the module's code,
its state-dict keys and the tensor-parallel layout's keys are unchanged, but
between uses it holds no data of its own: a NaN scalar expanded to its shape.
Its module's class gains a property of that name, so every read of the
tensor (the module's own forward, or a parent's split forward reading a
child's weight, ``parallel/tp.py`` and ``parallel/sp.py``) all-gathers the
whole tensor from the ranks' blocks there and then, for that use alone: at
most the tensors of the ops in flight are whole. A read where the module's
entry holds another tensor (``torch.func.functional_call``'s EMA weights in
an eval, or ``whole_frozen``'s copies) returns that tensor. A trained
tensor's read under autograd goes through ``_Gather``, whose backward hands
the whole gradient to the parameter, so the step's
``torch.autograd.grad(loss, params)`` gives the gradients of the whole
tensors as with one process. What autograd saves of a gathered tensor for
the backward (a conv's weight, a Linear's transposed weight) is not kept:
inside ``saving()`` a saved-tensor hook keeps only its name and view, and
the backward all-gathers it again where it reads it; a checkpointed region
(``remat``) reads its tensors again when it recomputes. In a bf16 step the
models' cast copies of the trained weights are what autograd saves, and
those stay until the backward.

**The step** (``training/steps.py``): the forward and backward run on the
gathered whole tensors, as with one process. Then the gradients of the
sharded tensors are reduce-scattered into this rank's blocks as a mean over
the processes of ``group`` (``reduce_grads``), and the loss and the other
gradients are all-reduced over ``whole_group``, as under ``replicated``; Adam
and the EMA run on the masters, which are the blocks. Under ``mesh_layout:
hier`` the plan shards over a host's row (``parallel/hier.py``) and the
reduce-scattered blocks are then averaged over the column of the other
hosts' same ranks (``replica_group``), so only blocks cross hosts. The
step's collectives go through flat fp32 buffers made with the plan, and
every kind ran once then, so the communicator exists before a CUDA graph
captures them; the per-use all-gathers are captured with the step. A sum of
two values does not depend on their order, and a gather is exact, so at
world 2 the step gives the bits of the ``replicated`` step, and at world 1
those of one process.
"""

from __future__ import annotations

import dataclasses
import contextlib
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..parallel import dist as pdist
from ..utils.sharded_checkpoint import flatten_dict


@dataclasses.dataclass
class Leaf:
    """One trained tensor under the plan. ``flax_dim`` (of ``flax_shape``)
    and ``torch_dim`` are the dim split over the world, None where the
    tensor stays whole; ``offset`` is its block's place in the flat
    buffers."""
    group: str
    name: str
    flax_path: str
    flax_shape: Tuple[int, ...]
    flax_dim: Optional[int]
    torch_dim: Optional[int]
    block: int = 0
    offset: int = 0


def _carries(leaf: np.ndarray, base: int, d: int, shape: Tuple[int, ...], t: int) -> bool:
    """Whether the flax dim ``d`` of the probe ``leaf`` (the torch element
    indices, from ``base``) indexes the torch dim ``t`` of ``shape``
    everywhere: then a block of one is a block of the other."""
    if leaf.shape[d] != shape[t]:
        return False
    stride = int(np.prod(shape[t + 1:], dtype=np.int64))
    along = ((leaf - base) // stride) % shape[t]
    want = np.arange(leaf.shape[d]).reshape([-1 if i == d else 1 for i in range(leaf.ndim)])
    return bool((along == want).all())


def fsdp_rule(world: int, min_size: int) -> Callable:
    """``rule(group, name, flax shape) -> (the rule's dim, the dims to try
    in order)``: ``parallel.fsdp_dim``, then every dim that divides
    ``world`` from the largest (``layout`` takes the first that carries a
    torch dim)."""
    def rule(group, name, shape):
        dim = parallel.fsdp_dim(shape, world, min_size)
        if dim is None:
            return None, []
        order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
        return dim, [d for d in order if shape[d] >= world and shape[d] % world == 0]
    return rule


def layout(params: Dict[str, Dict[str, torch.Tensor]], to_trees: Dict[str, Callable],
           world: int, min_size: int, rule: Optional[Callable] = None
           ) -> Tuple[List[Leaf], List[Tuple[str, int, int]]]:
    """The plan's leaves in ``params``' order, and its exceptions
    ``(flax path, the rule's dim, the dim used or None)``: each group's
    tensors go through ``to_trees[group]`` as probes of their element
    indices, which give each tensor's flax path and shape and which flax
    dims carry a torch dim. ``rule`` (default ``fsdp_rule(world,
    min_size)``) names each leaf's dim and the dims to try."""
    rule = fsdp_rule(world, min_size) if rule is None else rule
    leaves, exceptions = [], []
    for group, named in params.items():
        probes, base, offset = {}, {}, 0
        for name, p in named.items():
            probes[name] = torch.arange(offset, offset + p.numel(), dtype=torch.int64
                                        ).reshape(p.shape)
            base[name] = offset
            offset += p.numel()
        starts = np.array(sorted(base.values()), dtype=np.int64)
        by_start = {v: k for k, v in base.items()}
        found = {}
        for path, leaf in flatten_dict(to_trees[group](probes)).items():
            leaf = np.asarray(leaf)
            first = int(leaf.min())
            name = by_start[int(starts[np.searchsorted(starts, first, side="right") - 1])]
            shape = tuple(named[name].shape)
            want, order = rule(group, name, leaf.shape)
            flax_dim = torch_dim = None
            if want is not None:
                for d in order:
                    t = next((t for t in range(len(shape)) if _carries(
                        leaf, base[name], d, shape, t)), None)
                    if t is not None:
                        flax_dim, torch_dim = d, t
                        break
                if flax_dim != want:
                    exceptions.append((f"{group}/{path}", want, flax_dim))
            found[name] = Leaf(group, name, path, tuple(leaf.shape), flax_dim, torch_dim)
        missing = sorted(set(named) - set(found))
        if missing:
            raise KeyError(f"{group}: the flax map gives no leaf for {missing}")
        leaves.extend(found[name] for name in named)
    return leaves, exceptions


class _Gather(torch.autograd.Function):
    """A sharded trained tensor's whole value for one use: forward, the
    all-gather of the ranks' blocks (the placeholder ``p`` is the autograd
    input and carries no data); backward, the whole gradient, handed to
    ``p``."""

    @staticmethod
    def forward(ctx, p, plan, key):
        return plan._whole(key)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Saved:
    """What ``saving()`` keeps of a gathered tensor autograd saves: the
    tensor's key and the view of it that was saved."""
    __slots__ = ("key", "size", "stride", "offset")

    def __init__(self, key, t: torch.Tensor):
        self.key, self.size, self.stride, self.offset = (
            key, t.size(), t.stride(), t.storage_offset())


def _held_property(attr: str) -> property:
    def get(module):
        value = module._parameters[attr]
        p, plan, key = module._fsdp_held[attr]
        return plan._use(p, key) if value is p else value
    return property(get)


_HELD_CLASSES: Dict[tuple, type] = {}


def _hold_class(cls: type, attrs) -> type:
    """``cls`` with a property for each of ``attrs`` (the module
    docstring), made once per class and names."""
    key = (cls, frozenset(attrs))
    if key not in _HELD_CLASSES:
        _HELD_CLASSES[key] = type(cls.__name__, (cls,),
                                  {a: _held_property(a) for a in sorted(attrs)})
    return _HELD_CLASSES[key]


class FsdpPlan:
    """The FSDP layout of a trainer's trained tensors ``params`` (``{group:
    {name: Parameter}}``; ``to_trees[group]`` maps a group's state dict to
    its flax tree) and frozen tensors ``frozen`` (the same, mapped by
    ``frozen_trees``) over the tensor group, and its collectives (module
    docstring). ``masters`` are keyed as ``params``. ``modules`` hold every
    one of these parameters (each sharded one is held as its block from
    here on)."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]],
                 to_trees: Dict[str, Callable], min_size: int, device, group=None,
                 place: Optional[Tuple[int, int]] = None, rule: Optional[Callable] = None,
                 pre_reduce: Optional[Callable] = None, modules: Sequence[nn.Module] = (),
                 frozen: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 frozen_trees: Optional[Dict[str, Callable]] = None, whole_group=None,
                 replica_group=None):
        """``group``/``place`` (rank, world in it): the processes the plan
        shards over, by default the tensor group; ``rule`` as ``layout``
        takes it; ``pre_reduce(grads)``, where given, runs on the gradients
        before the plan's collectives (``fsdp+tp``: the model group's sums);
        ``whole_group`` (by default ``group``): the processes the loss and
        the whole tensors' gradients are averaged over; ``replica_group``
        (``hier``: the column): the processes that hold the same blocks,
        over which the reduce-scattered blocks are then averaged."""
        self.rank, self.world = (parallel.process_index(), parallel.process_count()
                                 ) if place is None else place
        self.group, self.pre_reduce = group, pre_reduce
        self.params = params
        self.frozen = dict(frozen or {})
        clash = set(self.frozen) & set(params)
        if clash:
            raise ValueError(f"frozen groups {sorted(clash)} are named as trained ones")
        every = {**params, **self.frozen}
        leaves, exceptions = layout(every, {**to_trees, **(frozen_trees or {})}, self.world,
                                    min_size, rule)
        self.leaves = [lf for lf in leaves if lf.group in params]
        self.frozen_leaves = [lf for lf in leaves if lf.group in self.frozen]
        self.exceptions = [e for e in exceptions if e[0].split("/")[0] in params]
        self.frozen_exceptions = [e for e in exceptions if e[0].split("/")[0] in self.frozen]
        self._by_name = {(lf.group, lf.name): lf for lf in leaves}
        self.sharded = [lf for lf in self.leaves if lf.torch_dim is not None]
        self.frozen_sharded = [lf for lf in self.frozen_leaves if lf.torch_dim is not None]
        offset = 0
        for lf in self.sharded + self.frozen_sharded:
            lf.block = every[lf.group][lf.name].shape[lf.torch_dim] // self.world
        for lf in self.sharded:
            lf.offset = offset
            offset += params[lf.group][lf.name].numel() // self.world
        self.shard_numel = offset
        with torch.no_grad():
            self.masters = {g: dict(named) for g, named in params.items()}
            self._blocks: Dict[tuple, torch.Tensor] = {}
            for lf in self.sharded + self.frozen_sharded:
                block = self.local(lf.group, lf.name, every[lf.group][lf.name].detach()).clone(
                    memory_format=torch.contiguous_format)
                self._blocks[(lf.group, lf.name)] = block
                if lf.group in params:
                    self.masters[lf.group][lf.name] = block
        self.gathers = 0                 # whole tensors gathered (uses and re-reads)
        self._saving = 0
        self._live = weakref.WeakValueDictionary()   # storage address -> gathered tensor
        self._hold(every, modules)
        whole = sum(params[lf.group][lf.name].numel() for lf in self.leaves
                    if lf.torch_dim is None)
        self._whole_numel = 1 + whole
        self._reduce = parallel.mean_all_reducer(
            1 + whole, device, group if whole_group is None else whole_group)
        # the flat buffers, made here once; one collective of each kind runs
        # now, so the communicator exists before any capture
        self._wide = torch.zeros(self.world * self.shard_numel, dtype=torch.float32,
                                 device=device)
        self._grads = torch.zeros(self.shard_numel, dtype=torch.float32, device=device)
        self._replica = None
        if self.sharded and replica_group is not None:
            self._replica = parallel.mean_all_reducer(self.shard_numel, device,
                                                      replica_group)
        if self.sharded or self.frozen_sharded:
            probe = torch.zeros(self.world + 1, dtype=torch.float32, device=device)
            parallel.reduce_scatter_mean_(probe[:1], probe[1:], group)
            parallel.all_gather_into_(probe[1:], probe[:1], group)

    # -- placement -------------------------------------------------------- #

    def _hold(self, every: Dict[str, Dict[str, torch.Tensor]], modules) -> None:
        """Each sharded tensor's parameter emptied to its placeholder, and
        its module given the property that gathers it (module docstring)."""
        owners = {}
        for module in modules:
            for m in module.modules():
                for attr, p in m._parameters.items():
                    if p is not None:
                        owners.setdefault(id(p), (m, attr))
        by_module: Dict[int, list] = {}
        for lf in self.sharded + self.frozen_sharded:
            p = every[lf.group][lf.name]
            if id(p) not in owners:
                raise ValueError(f"{lf.group}/{lf.name}: no module given holds it")
            m, attr = owners[id(p)]
            by_module.setdefault(id(m), [m, {}])[1][attr] = (p, self, (lf.group, lf.name))
        self.held = []
        with torch.no_grad():
            for m, attrs in by_module.values():
                m.__class__ = _hold_class(type(m), attrs)
                m.__dict__.setdefault("_fsdp_held", {}).update(attrs)
                for attr, (p, _, key) in attrs.items():
                    p.data = self._placeholder(p)
                    self.held.append((m, attr, p, key))

    _nans: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def _placeholder(cls, p: torch.Tensor) -> torch.Tensor:
        key = (p.device, p.dtype)
        if key not in cls._nans:
            cls._nans[key] = torch.full((), float("nan"), dtype=p.dtype, device=p.device)
        return cls._nans[key].expand(p.shape)

    def local(self, group: str, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``whole`` (a tensor shaped as the tensor
        ``group``/``name``), or ``whole`` where it is not sharded."""
        lf = self._by_name[(group, name)]
        if lf.torch_dim is None:
            return whole
        return whole.narrow(lf.torch_dim, self.rank * lf.block, lf.block)

    def _whole(self, key) -> torch.Tensor:
        """The whole tensor ``key`` gathered from every rank's block, a new
        tensor. Collective; capturable over NCCL."""
        lf = self._by_name[key]
        self.gathers += 1
        return pdist.all_gather_dim(self._blocks[key], self.group, self.world, lf.torch_dim)

    def _use(self, p: torch.Tensor, key) -> torch.Tensor:
        """The read of a held tensor (``_held_property``)."""
        if p.requires_grad and torch.is_grad_enabled():
            w = _Gather.apply(p, self, key)
        else:
            w = self._whole(key)
        if self._saving:
            w._fsdp_key = key
            self._live[w.untyped_storage().data_ptr()] = w
        return w

    def _pack(self, t: torch.Tensor):
        w = self._live.get(t.untyped_storage().data_ptr())
        return t if w is None else _Saved(w._fsdp_key, t)

    def _unpack(self, saved):
        if type(saved) is not _Saved:
            return saved
        return self._whole(saved.key).as_strided(saved.size, saved.stride, saved.offset)

    @contextlib.contextmanager
    def saving(self):
        """The forward of a step: what autograd saves of a gathered tensor is
        gathered again in the backward (module docstring)."""
        self._saving += 1
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
                yield
        finally:
            self._saving -= 1

    @contextlib.contextmanager
    def whole_frozen(self):
        """The frozen modules' sharded tensors whole in their modules for the
        block's duration (an eval), then freed: one all-gather each.
        Collective."""
        held = [(m, attr, p, key) for m, attr, p, key in self.held if key[0] in self.frozen]
        try:
            for m, attr, p, key in held:
                m._parameters[attr] = self._whole(key)
            yield
        finally:
            for m, attr, p, key in held:
                m._parameters[attr] = p

    def load_module(self, module: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
        """``module.load_state_dict(state_dict, strict=True)`` (whole
        tensors) into a module the plan holds tensors of: a held tensor is
        loaded whole for the call, then its block kept."""
        mine = {id(m) for m in module.modules()}
        held = [(p, key) for m, _, p, key in self.held if id(m) in mine]
        with torch.no_grad():
            for p, _ in held:
                p.data = torch.empty(p.shape, dtype=p.dtype, device=p.device)
            try:
                module.load_state_dict(state_dict, strict=True)
                for p, key in held:
                    self._blocks[key].copy_(self.local(*key, p.data))
            finally:
                for p, _ in held:
                    p.data = self._placeholder(p)

    def _blocks_of(self, flat: torch.Tensor, lf: Leaf) -> torch.Tensor:
        """``[world, *block shape]``: every rank's block of ``lf`` in the
        wide buffer ``flat``."""
        shape = list(self.params[lf.group][lf.name].shape)
        shape[lf.torch_dim] = lf.block
        n = self.shard_numel
        return flat.view(self.world, n)[:, lf.offset:lf.offset + int(np.prod(shape))].view(
            self.world, *shape)

    def _split(self, t: torch.Tensor, lf: Leaf) -> torch.Tensor:
        """``t`` (whole) as ``[world, *block shape]``, a view."""
        return t.unflatten(lf.torch_dim, (self.world, lf.block)).movedim(lf.torch_dim, 0)

    def held_bytes(self) -> Dict[str, int]:
        """Bytes of parameters this rank holds: the trained and frozen
        tensors' blocks, and those kept whole."""
        def nbytes(ts):
            return int(sum(t.numel() * t.element_size() for t in ts))
        return {"trained_blocks": nbytes(self._blocks[(lf.group, lf.name)]
                                         for lf in self.sharded),
                "trained_whole": nbytes(self.params[lf.group][lf.name] for lf in self.leaves
                                        if lf.torch_dim is None),
                "frozen_blocks": nbytes(self._blocks[(lf.group, lf.name)]
                                        for lf in self.frozen_sharded),
                "frozen_whole": nbytes(self.frozen[lf.group][lf.name]
                                       for lf in self.frozen_leaves if lf.torch_dim is None)}

    def buffer_bytes(self) -> Dict[str, int]:
        """Bytes of the step's flat buffers, by name."""
        out = {"wide": self._wide.numel() * 4, "grads": self._grads.numel() * 4}
        if self._reduce is not None:
            out["whole_reduce"] = self._whole_numel * 4
        if self._replica is not None:
            out["replica_reduce"] = self.shard_numel * 4
        return out

    # -- the step's collectives --------------------------------------------- #

    def reduce_grads(self, loss: torch.Tensor, grads: Sequence[torch.Tensor]):
        """(loss, grads of the masters): ``grads`` (of the whole parameters,
        in ``params``' order) reduce-scattered into this rank's blocks as a
        mean where the tensor is sharded (then averaged over
        ``replica_group``), all-reduced with the loss where it is whole.
        Collective; capturable over NCCL."""
        if self.pre_reduce is not None:
            self.pre_reduce(grads)
        pairs = list(zip(self.leaves, grads))
        if self._reduce is not None:
            self._reduce([loss] + [g for lf, g in pairs if lf.torch_dim is None])
        if not self.sharded:
            return loss, list(grads)
        with torch.no_grad():
            torch._foreach_copy_([self._blocks_of(self._wide, lf) for lf, g in pairs
                                  if lf.torch_dim is not None],
                                 [self._split(g, lf) for lf, g in pairs
                                  if lf.torch_dim is not None])
            parallel.reduce_scatter_mean_(self._grads, self._wide, self.group)
            if self._replica is not None:
                self._replica([self._grads])
        return loss, [g if lf.torch_dim is None else self._block_of(self._grads, lf)
                      for lf, g in pairs]

    def _block_of(self, flat: torch.Tensor, lf: Leaf) -> torch.Tensor:
        """This rank's block of ``lf`` in the narrow buffer ``flat``, a view
        shaped as its master."""
        shape = self.masters[lf.group][lf.name].shape
        return flat[lf.offset:lf.offset + int(np.prod(shape))].view(shape)

    def gather(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole copies of tensors held as the masters are (``params``'
        order, repeated: EMA, then moments, ...), on every rank. Collective."""
        dims = [lf.torch_dim for lf in self.leaves]
        dims = dims * (len(tensors) // len(dims))
        return parallel.gather_full(list(tensors), dims, self.group)


def local_pieces(tree: Dict, skeleton: Dict[str, Dict], rank: int, world: int,
                 index: Optional[Callable] = None) -> Dict[str, List]:
    """The pieces of a sharded save this rank writes, from ``tree`` (its
    checkpoint tree in the flax layout, built from its blocks) and
    ``skeleton`` (each path's global ``{shape, dtype}``). By default a leaf
    that is smaller than its global shape in one dim is this rank's block of
    it (``world`` times smaller there, starting at ``rank`` blocks), and a
    leaf of the global shape is whole on every rank and rank 0 writes it.
    ``index(global shape, split dims) -> ({dim: block index}, whether this
    rank writes the piece)`` places the blocks of a leaf split in several
    dims (``fsdp+tp``), or held on several ranks (``tp``'s replicas)."""
    out = {}
    for path, leaf in flatten_dict(tree).items():
        if isinstance(leaf, dict):
            continue
        data = np.asarray(leaf)
        want = tuple(skeleton[path]["shape"])
        split = [d for d in range(data.ndim) if data.ndim == len(want)
                 and data.shape[d] != want[d]]
        if data.ndim != len(want) or any(want[d] % data.shape[d] for d in split):
            raise ValueError(f"{path}: a block {data.shape} of {want}")
        if index is None:
            if len(split) > 1 or (split and data.shape[split[0]] * world != want[split[0]]):
                raise ValueError(f"{path}: a block {data.shape} of {want} over {world} "
                                 "processes")
            at, writes = {d: rank for d in split}, bool(split) or rank == 0
        else:
            at, writes = index(want, split)
        start = [0] * data.ndim
        for d, i in at.items():
            start[d] = i * data.shape[d]
        out[path] = [{"start": start, "data": data}] if writes else []
    return out
