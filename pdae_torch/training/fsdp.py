"""FSDP over the tensor group (``runner_config.param_sharding: fsdp``): the
port of ``pdae_tpu``'s FSDP placement (``training/base.py``'s
``_tree_shardings``, ``parallel/mesh.py``'s ``fsdp_shardings``) for a
trainer's trained tensors.

**The rule.** A trained tensor is held sharded when its leaf in the flax
layout, the layout of the checkpoints and of ``pdae_tpu``'s train state,
passes ``pdae_tpu``'s rule (``parallel.fsdp_dim``): at least
``fsdp_min_size`` elements (2**15 by default), and a dim that is at least the
world size and divisible by it, the largest such dim, ties to the lower one.
Every process then holds the block of that dim that its rank gives it: its
master value, its EMA and both Adam moments. The other tensors stay whole on
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
dim 0), and lists it in ``exceptions``; ``pdae_tpu`` shards its dim 0.

**The step** (``training/steps.py``): the forward and backward run on the
whole parameters, as with one process. Then the gradients of the sharded
tensors are reduce-scattered into this rank's blocks as a mean over the
processes (``reduce_grads``), and the loss and the other gradients are
all-reduced, as under ``replicated``; Adam and the EMA run on the masters (a
sharded tensor's master is a leaf tensor of its own, the block; a whole
tensor's is the parameter itself); then an all-gather writes the updated
blocks back into the whole parameters (``gather_params``). Both collectives
go through flat fp32 buffers made with the plan, before any step is
captured, and each ran once then, so the communicator exists before a CUDA
graph captures them. A sum of two values does not depend on their order, so
at world 2 the step gives the bits of the ``replicated`` step, and at world
1 those of one process.

**What stays whole.** The frozen modules (the ShiftUNet trunk, the frozen
encoder and decoder of the latent and manipulation stages) stay whole on
every process, and rank 0 writes them in a sharded checkpoint. ``pdae_tpu``
shards frozen trees at rest too (``_place_frozen``), but the port's step reads
them whole every step and they never change, so sharding them would add an
all-gather a step and save no step's work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
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


class FsdpPlan:
    """The FSDP layout of a trainer's trained tensors ``params`` (``{group:
    {name: Parameter}}``; ``to_trees[group]`` maps a group's state dict to
    its flax tree) over the tensor group, and its collectives (module
    docstring). ``masters`` are keyed as ``params``."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]],
                 to_trees: Dict[str, Callable], min_size: int, device, group=None,
                 place: Optional[Tuple[int, int]] = None, rule: Optional[Callable] = None,
                 pre_reduce: Optional[Callable] = None):
        """``group``/``place`` (rank, world in it): the processes the plan
        shards over, by default the tensor group; ``rule`` as ``layout``
        takes it; ``pre_reduce(grads)``, where given, runs on the gradients
        before the plan's collectives (``fsdp+tp``: the model group's sums)."""
        self.rank, self.world = (parallel.process_index(), parallel.process_count()
                                 ) if place is None else place
        self.group, self.pre_reduce = group, pre_reduce
        self.params = params
        self.leaves, self.exceptions = layout(params, to_trees, self.world, min_size, rule)
        self._by_name = {(lf.group, lf.name): lf for lf in self.leaves}
        self.sharded = [lf for lf in self.leaves if lf.torch_dim is not None]
        offset = 0
        for lf in self.sharded:
            lf.block = params[lf.group][lf.name].shape[lf.torch_dim] // self.world
            lf.offset = offset
            offset += params[lf.group][lf.name].numel() // self.world
        self.shard_numel = offset
        with torch.no_grad():
            self.masters = {g: dict(named) for g, named in params.items()}
            for lf in self.sharded:
                self.masters[lf.group][lf.name] = self.local(
                    lf.group, lf.name, params[lf.group][lf.name].detach()).clone(
                        memory_format=torch.contiguous_format)
        whole = sum(params[lf.group][lf.name].numel() for lf in self.leaves
                    if lf.torch_dim is None)
        self._reduce = parallel.mean_all_reducer(1 + whole, device, group)
        # the flat buffers, made here once; one collective of each kind runs
        # now, so the communicator exists before any capture
        self._wide = torch.zeros(self.world * self.shard_numel, dtype=torch.float32,
                                 device=device)
        self._grads = torch.zeros(self.shard_numel, dtype=torch.float32, device=device)
        self._send = torch.zeros(self.shard_numel, dtype=torch.float32, device=device)
        if self.sharded:
            parallel.reduce_scatter_mean_(self._grads[:1], self._wide[:self.world], group)
            parallel.all_gather_into_(self._wide[:self.world], self._send[:1], group)

    # -- placement -------------------------------------------------------- #

    def local(self, group: str, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``whole`` (a tensor shaped as the trained
        tensor ``group``/``name``), or ``whole`` where it is not sharded."""
        lf = self._by_name[(group, name)]
        if lf.torch_dim is None:
            return whole
        return whole.narrow(lf.torch_dim, self.rank * lf.block, lf.block)

    def _blocks(self, flat: torch.Tensor, lf: Leaf) -> torch.Tensor:
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

    # -- the step's collectives --------------------------------------------- #

    def reduce_grads(self, loss: torch.Tensor, grads: Sequence[torch.Tensor]):
        """(loss, grads of the masters): ``grads`` (of the whole parameters,
        in ``params``' order) reduce-scattered into this rank's blocks as a
        mean where the tensor is sharded, all-reduced with the loss where it
        is whole. Collective; capturable over NCCL."""
        if self.pre_reduce is not None:
            self.pre_reduce(grads)
        pairs = list(zip(self.leaves, grads))
        if self._reduce is not None:
            self._reduce([loss] + [g for lf, g in pairs if lf.torch_dim is None])
        if not self.sharded:
            return loss, list(grads)
        with torch.no_grad():
            torch._foreach_copy_([self._blocks(self._wide, lf) for lf, g in pairs
                                  if lf.torch_dim is not None],
                                 [self._split(g, lf) for lf, g in pairs
                                  if lf.torch_dim is not None])
            parallel.reduce_scatter_mean_(self._grads, self._wide, self.group)
        return loss, [g if lf.torch_dim is None else self._block_of(self._grads, lf)
                      for lf, g in pairs]

    def _block_of(self, flat: torch.Tensor, lf: Leaf) -> torch.Tensor:
        """This rank's block of ``lf`` in the narrow buffer ``flat``, a view
        shaped as its master."""
        shape = self.masters[lf.group][lf.name].shape
        return flat[lf.offset:lf.offset + int(np.prod(shape))].view(shape)

    def gather_params(self) -> None:
        """The whole parameters rewritten from every rank's updated blocks:
        one all-gather. Collective; capturable over NCCL."""
        if not self.sharded:
            return
        with torch.no_grad():
            torch._foreach_copy_([self._block_of(self._send, lf) for lf in self.sharded],
                                 [self.masters[lf.group][lf.name] for lf in self.sharded])
            parallel.all_gather_into_(self._wide, self._send, self.group)
            for lf in self.sharded:
                self._split(self.params[lf.group][lf.name], lf).copy_(
                    self._blocks(self._wide, lf))

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
