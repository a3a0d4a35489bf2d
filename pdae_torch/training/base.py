"""Base trainer: run dir, config snapshot, data plumbing, logging,
checkpoint cadence and the step loop. The port of ``pdae_tpu/training/base.py``:
one process on one device, or data-parallel over ``torchrun`` processes.

Run dir layout as the JAX package's: ``checkpoints/`` (``latest.ckpt`` and
``save-{N}k.ckpt``), ``samples/``, ``config.yml`` (written as JSON text),
``metrics.jsonl`` and ``tb/`` where ``torch.utils.tensorboard`` imports.

Resume is bitwise: the checkpoint restores params, EMA, Adam moments and the
step; the batch stream is fast-forwarded to the batch an uninterrupted run
would take at that step; and every random draw of a step comes from a
generator seeded with (seed, step) (``utils/rng.py``).

A checkpoint is taken without waiting for the disk: ``save`` copies every
tensor the step updates in place to the host before it returns, and a
background thread relays the copies out to the flax layout, serialises and
writes them; a write that failed re-raises at the next save or at the end of
``train``.

With ``train_dataset_config.device_resident`` the step-consumed keys of the
whole corpus are moved to the device once (``training/resident.py``) and each
step gathers its rows there: ``resident_sampling: epoch`` (the default) takes
the host loader's index rows, so the batches are bit-equal to the host path's,
``uniform`` draws them with replacement from a generator seeded with (seed,
``DATA_STREAM_TAG``, step). Either way step N takes row N of its stream, on a
resume too. ``transfer_uint8`` datasets give uint8 ``x_0``, which the steps
normalise on the device.

``runner_config.compute_dtype`` (or the reference's
``optimizer_config.enable_amp``) sets the models' compute dtype over fp32
parameters (``_compute_dtype``), and ``runner_config.remat`` the training
forward's rematerialisation (``steps.remat_wrap``), as in ``pdae_tpu``.

``runner_config.steps_per_dispatch: K`` runs the loop chunk by chunk, on
``pdae_tpu``'s schedule (``_chunk_schedule``: a chunk that realigns a
resumed run to a multiple of K, then K at a time, then the tail), and the
cadences (display, saves, evals, a signal's stop) are read at chunk ends,
which they must divide. On the card a chunk of c steps runs as c replays of
one train step captured into a CUDA graph, with no host synchronisation
inside the chunk (``training/dispatch.py``: the port of JAX's scanned
multi-step programs); with K = 1, or on the CPU (which a caller must ask
for), each step is an eager call of ``train_step``. Both paths draw from
generators re-seeded per step and give the same bits.

Data-parallel training (``param_sharding: replicated``, the default, under
``torchrun``; the process group joined first, ``parallel.init_distributed``):
every process holds the whole state, loads its rank's shard of each batch
(``Loader``'s ``process_index``/``process_count``: the global batch is
``batch_size * num_iterations * world``, the reference's per-process batch),
draws its rows of the global ``t``, noise, indices and coins, and averages
the gradients and the loss over the tensor group before the update (the
train steps' ``rows`` and ``reduce``), so params, EMA and Adam moments stay
bit-equal on every rank. The primary alone writes ``config.yml``, the
checkpoints, ``metrics.jsonl``, TensorBoard, the eval grids and the loop's
lines; every rank reads the same checkpoint on a resume. An eval splits its
images over the ranks (``_eval_shard``) and the primary gathers them. The
ranks stop together: every ``min(display_steps, save_latest_every_steps)``
steps, at a chunk end, they gather their stop flags (a signal, or a failed
background write on the primary) over gloo and all leave at that step; a
write's error is raised after every rank has left. On the card a gloo tensor
group cannot be captured, so ``steps_per_dispatch`` > 1 needs NCCL there.

FSDP (``param_sharding: fsdp`` under ``torchrun``, ``fsdp_min_size``): each
rank holds only its block of every trained tensor that ``pdae_tpu``'s rule
shards (its master, EMA and Adam moments; ``training/fsdp.py``) and of every
such frozen tensor (the representation trunk, the latent and manipulation
stages' frozen encoder and decoder: ``_place_frozen``'s placement); the step
all-gathers each tensor where it is used and reduce-scatters the gradients. A
``full`` save gathers the state first (on the card; collective) and the
primary writes it; the eval gathers the EMA and the frozen modules on every
rank for its duration. In one process, or without a tensor group, ``fsdp``
is the one-process layout, as every process function is then the identity.
``mesh_layout`` (``pdae_tpu``'s, resolved by ``mesh_layout()``): ``flat``
shards over the world; ``hier`` lays the ranks out on a ``[rows, cols]``
host grid (``hier_shape``, else a host is the ranks of one
``LOCAL_WORLD_SIZE``; ``parallel/hier.py``), shards over a host's row, and
averages the blocks' gradients over the column; ``auto`` is ``hier`` for
``fsdp`` over more than one host of more than one rank each, as ``pdae_tpu``
picks it for processes of several chips each, else ``flat``. Under
``replicated`` the layout changes nothing, as in ``pdae_tpu``. The batch
shards over the whole world in rank order under either layout.

``checkpoint_format: sharded`` writes ``pdae_tpu``'s directory layout
(``utils/sharded_checkpoint.py``): every rank its pieces of the sharded
tensors (under ``hier`` the ranks of row 0), rank 0 the leaves that are
whole everywhere, the primary the
manifest last, after every shard file is on disk; with one process the
background writer does it, with several the write is synchronous (its
barrier is a collective), and a failed write stops the ranks by consensus as
a failed full write does. A save switches between the formats both ways
without a moment in which the run has no checkpoint (a file is replaced
through ``latest.ckpt.swap``, which a resume completes), and a resume reads
either format at any world size, each rank keeping its part.

Tensor parallelism (``param_sharding: tp``, ``tp_size`` model ranks, by
default the whole world; ``parallel/tp.py``): rank r has data index ``r //
tp_size`` and model index ``r % tp_size``; every module (the frozen ones
too) holds the rank's block of each parameter that ``pdae_tpu``'s rule
shards, and its forward runs split over the model group. The batch shards
over the data group: the loader, the resident corpus's index rows and every
global draw (t, noise, indices, coins, dropout) take the data index's rows,
so every rank of a model group sees the same rows. The step sums the
gradients of the whole vectors a rank used a slice of over the model group,
then averages every gradient and the loss over the data group. ``fsdp+tp``
adds the FSDP plan over the data group on the dims of ``pdae_tpu``'s
``fsdp_tp_sharding``, inside each tp block. A ``full`` save gathers over both
groups; a ``sharded`` one writes each rank's replica-0 pieces, a start on
every dim.

Spatial parallelism (``param_sharding: sp``, ``sp_size`` ranks per image,
by default the whole world; ``parallel/sp.py``): rank r has data index ``r //
sp_size`` and sp index ``r % sp_size``; the parameters, EMA and moments stay
whole on every rank, and the UNets, ShiftUNets and encoders (the frozen ones
too) run on the rank's rows of every map whose height splits. The batch
shards over the data group as under ``tp``. The gradients of modules that
run split are each rank's partial sums: the step sums them over the sp
group and averages over the data group (one all-reduce over the world of
``sp * grad``); those of a module that runs whole on every rank (MLPSkipNet,
the classifier, or any model when the images' height does not divide by
``sp_size``, so that no map splits) are averaged over the world as they
are. ``fsdp+sp`` adds
the FSDP plan over the data group, with the sp group's sum before it. Both
checkpoint formats write as under ``replicated`` and ``fsdp``.

``runner_config.profile_dir`` traces the whole step loop of each ``train``
call on the primary rank with ``torch.profiler`` (the host's ops, and the
card's kernels where there is one), as ``pdae_tpu`` traces it with
``jax.profiler``: started just before the loop, stopped and written in its
``finally``, an exception mid-loop included, under ``profile_dir`` in the
layout of ``torch.profiler.tensorboard_trace_handler`` (TensorBoard's
profiler plugin reads it; each file is a Chrome trace). With
``steps_per_dispatch`` > 1 the trace holds the step's capture into the CUDA
graph and every replay's kernels.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from .. import parallel, resolve_device
from ..data import Loader, build_dataset, prefetch_to_device
from ..data.pipeline import batch_to_device
from ..utils import (is_sharded_checkpoint, load_checkpoint, load_yaml,
                     save_checkpoint, save_yaml, snapshot_path)
from ..utils.config import overlay_eval_dataset_config
from ..utils.image import png_bytes
from ..utils.rng import DROPOUT, INIT, TRAIN, StepGenerator, stream_seed
from ..utils.sharded_checkpoint import (cleanup_stale_shards, manifest_skeleton,
                                        write_manifest, write_shard_file)
from ..parallel import hier as hier_parallel
from ..parallel import sp as spatial_parallel
from ..parallel import tp as tensor_parallel
from .fsdp import FsdpPlan, local_pieces
from .state import TrainState, adam_moments, flat_params, host_copy, make_optimizer


class Meters:
    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    def add(self, name, dt, n: int = 1):
        """``dt`` seconds spent over ``n`` steps."""
        self.totals[name] += dt
        self.counts[name] += n

    def summary(self):
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class Logger:
    """metrics.jsonl, and TensorBoard where ``torch.utils.tensorboard``
    imports; with ``enabled`` false (a process other than the primary) it
    writes nothing."""

    def __init__(self, run_path: str, purge_step: int = 0, enabled: bool = True):
        self._tb = self._jsonl = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            os.makedirs(os.path.join(run_path, "tb"), exist_ok=True)
            self._tb = SummaryWriter(os.path.join(run_path, "tb"), purge_step=purge_step)
        self._jsonl = open(os.path.join(run_path, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float]):
        if self._jsonl is None:
            return
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps({"step": step, **values}) + "\n")
        self._jsonl.flush()

    def image(self, step: int, name: str, img_hwc_uint8: np.ndarray):
        """The image as a TensorBoard image summary, PNG-encoded by
        ``utils.image.png_bytes`` (``SummaryWriter.add_image`` would import
        PIL to encode it)."""
        if self._tb is None:
            return
        from tensorboard.compat.proto.summary_pb2 import Summary
        h, w, c = img_hwc_uint8.shape
        image = Summary.Image(height=h, width=w, colorspace=c,
                              encoded_image_string=png_bytes(img_hwc_uint8))
        self._tb.file_writer.add_summary(
            Summary(value=[Summary.Value(tag=name, image=image)]), step)


def _ours_ckpt_dir(p: str) -> bool:
    """A directory a save may replace: a sharded checkpoint (a JAX run's), a
    torn one (shard files without the manifest), or an empty one."""
    if is_sharded_checkpoint(p):
        return True
    try:
        entries = os.listdir(p)
    except OSError:
        return False
    return all(e == "manifest.msgpack" or e.endswith(".tmp")
               or (e.startswith("shard-") and e.endswith(".msgpack")) for e in entries)


PARAM_SHARDINGS = ("replicated", "fsdp", "tp", "sp", "fsdp+tp", "fsdp+sp")


def check_runner_config(config: dict) -> None:
    """Raise for values of the runner options that neither package takes,
    and for a torchrun launch whose process group was not joined."""
    rc = config.get("runner_config") or {}
    sharding = rc.get("param_sharding", "replicated")
    if sharding not in PARAM_SHARDINGS:
        raise ValueError(f"runner_config.param_sharding must be one of "
                         f"{', '.join(repr(m) for m in PARAM_SHARDINGS)}, got {sharding!r}")
    layout = rc.get("mesh_layout", "auto")
    if layout not in ("auto", "flat", "hier"):
        raise ValueError(f"runner_config.mesh_layout must be 'auto', 'flat' or 'hier', "
                         f"got {layout!r}")
    if layout == "hier" and "tp" in sharding.split("+"):
        raise ValueError("mesh_layout 'hier' applies to fsdp; tp builds its own [data, "
                         "model] mesh")
    if layout == "hier" and "sp" in sharding.split("+"):
        raise ValueError("mesh_layout 'hier' applies to fsdp; sp builds its own [data, sp] "
                         "mesh")
    if rc.get("checkpoint_format", "full") not in ("full", "sharded"):
        raise ValueError(f"runner_config.checkpoint_format must be 'full' or 'sharded', "
                         f"got {rc['checkpoint_format']!r}")
    if rc.get("compute_dtype") not in (None, "float32", "bfloat16"):
        raise ValueError(f"runner_config.compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {rc['compute_dtype']!r}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and parallel.process_count() != world:
        raise RuntimeError(f"WORLD_SIZE={world}, but this process has not joined the "
                           "process group: call pdae_torch.parallel.init_distributed() "
                           "before building the trainer (python -m pdae_torch.train does)")


def mesh_layout(config: dict, world: int, local_world: int):
    """``(layout, (rows, cols))``: ``runner_config.mesh_layout`` resolved as
    ``pdae_tpu/training/base.py`` resolves it, with a host the ranks of one
    ``local_world`` (torchrun's ``LOCAL_WORLD_SIZE``): ``auto`` is ``hier``
    where ``fsdp`` spans more than one host of more than one rank each, else
    ``flat``; the grid is ``hier_shape`` where set (it must cover the world),
    else the hosts (``parallel.hier_shape``), and ``None`` under ``flat``."""
    rc = config.get("runner_config") or {}
    layout = rc.get("mesh_layout", "auto")
    if layout == "auto":
        fsdp = rc.get("param_sharding", "replicated") == "fsdp"
        layout = "hier" if fsdp and 1 < local_world < world else "flat"
    if layout != "hier":
        return layout, None
    return layout, parallel.hier_shape(world, local_world, rc.get("hier_shape"))


def has_dropout(*modules) -> bool:
    return any(isinstance(m, nn.Dropout) and m.p > 0
               for module in modules for m in module.modules())


def init_on_cpu(seed: int, salt: int, build):
    """``build()`` with the global RNG seeded from (seed, ``INIT``, salt) on
    the CPU, so a model's init is the same on every machine; the global RNG
    is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(stream_seed(seed, INIT, salt))
        return build()


class _Bound(nn.Module):
    def __init__(self, modules, fn):
        super().__init__()
        self.mods, self.fn = nn.ModuleDict(modules), fn

    def forward(self, *args):
        return self.fn(*self.mods.values(), *args)


def with_weights(modules: Dict[str, nn.Module], weights: Dict[str, Dict], fn, *args):
    """``fn(*modules.values(), *args)`` with ``weights`` (module name ->
    parameter name -> tensor: the EMA) in place of those parameters for the
    one call (``torch.func.functional_call``, once for a whole sampling
    loop); the modules' own tensors are never touched. A module registered
    under two names (MLPSkipNet's ``linear_emb``, also ``cond_layers.1``)
    is one entry: ``tie_weights`` would swap it under each name and put back
    the first swap's tensor under the second, leaving the EMA in place."""
    flat = {f"mods.{m}.{k}": v for m, named in weights.items() for k, v in named.items()}
    return torch.func.functional_call(_Bound(modules, fn), flat, args, tie_weights=False)


class BaseTrainer:
    """Drive a train step over an endless batch stream on one device, in one
    process or as one rank of a data-parallel run (the module's docstring).

    ``device``: ``cuda`` unless the caller names another (``cuda:LOCAL_RANK``
    under torchrun); without a card it must be given."""

    def __init__(self, config: Optional[dict] = None, config_path: Optional[str] = None,
                 run_path: str = "./runs/dev", resume: Optional[str] = None,
                 seed: int = 0, device=None):
        assert config is not None or config_path is not None
        self.config = config if config is not None else load_yaml(config_path)
        check_runner_config(self.config)
        self.device = resolve_device(device)
        self.run_path = run_path
        self.seed = seed
        self.runner_config = self.config["runner_config"]
        self.dataloader_config = self.config.get("dataloader_config", {})
        self.save_seconds = []      # (loop's wait, background write) per save
        self._save_thread = None
        self._save_error = None
        self._dropout = False       # the trained modules have dropout (_build says)
        self.ema_every = int(self.runner_config.get("ema_every", 1))
        self._dispatch = None       # the card's captured step (training/dispatch.py)
        self.rank, self.world = parallel.process_index(), parallel.process_count()
        self.primary = self.rank == 0
        self._stop_local = False    # a failed write asks the ranks to stop
        self._save_error_deferred = None
        rc = self.runner_config
        self.param_sharding = rc.get("param_sharding", "replicated")
        self.checkpoint_format = rc.get("checkpoint_format", "full")
        # leaves smaller than this stay whole under fsdp
        self.fsdp_min_size = int(rc.get("fsdp_min_size", parallel.FSDP_MIN_SIZE))
        self.plan = None            # the FSDP plan (_shard_state)
        self._frozen = {}           # the frozen tensors the plan holds (_freeze)
        # FSDP's host grid under mesh_layout hier (the batch still shards
        # over the whole world)
        self.mesh_layout, grid = mesh_layout(
            self.config, self.world, int(os.environ.get("LOCAL_WORLD_SIZE", self.world)))
        self.hier_groups = None
        if grid is not None and self.param_sharding == "fsdp":
            self.hier_groups = hier_parallel.hier_groups(*grid)
        self._skeleton_cache = None
        # tensor parallelism: the layout of the sharded modules, and the
        # batch's shard by data index (every rank's own without tp)
        self.tp_layout = None
        self.data_rank, self.data_world = self.rank, self.world
        if "tp" in self.param_sharding.split("+"):
            groups = tensor_parallel.tp_groups(int(rc.get("tp_size", self.world)))
            self.tp_layout = tensor_parallel.Layout(groups, self.fsdp_min_size)
            self.data_rank, self.data_world = groups.data_index, groups.dp
        # spatial parallelism: the sp groups, and the parameters of the
        # modules that run split (their gradients are partial sums)
        self.sp_groups = None
        self._split_params = set()
        if "sp" in self.param_sharding.split("+"):
            self.sp_groups = spatial_parallel.sp_groups(int(rc.get("sp_size", self.world)))
            self.data_rank, self.data_world = (self.sp_groups.data_index,
                                               self.sp_groups.dp)

        if self.primary:
            os.makedirs(os.path.join(run_path, "checkpoints"), exist_ok=True)
            os.makedirs(os.path.join(run_path, "samples"), exist_ok=True)
            save_yaml(self.config, os.path.join(run_path, "config.yml"))

        self._build_datasets()
        self._build()          # subclass: models, state, step
        # one generator per stream, re-seeded before every step (utils/rng.py)
        from .resident import DATA_STREAM_TAG
        self._train_gen = StepGenerator(seed, TRAIN, self.device)
        self._data_gen = StepGenerator(seed, DATA_STREAM_TAG, self.device)

        self.start_step = 0
        latest = os.path.join(run_path, "checkpoints", "latest.ckpt")
        if resume:
            path = resume if os.path.exists(resume) else latest
            if not os.path.exists(path) and os.path.exists(path + ".swap"):
                # a save replacing a sharded directory stopped between
                # dropping the directory and renaming the new file in
                os.replace(path + ".swap", path)
            raw = load_checkpoint(path)
            self.load_state_dict(raw)
            self.start_step = int(raw["step"])
        self.logger = Logger(run_path, purge_step=self.start_step, enabled=self.primary)

    # -- data ----------------------------------------------------------- #

    def _build_datasets(self):
        self.train_dataset = build_dataset(self.config["train_dataset_config"])
        self.eval_dataset = build_dataset(overlay_eval_dataset_config(self.config))
        dl = self.dataloader_config.get("train", {})
        # the batch of one optimizer step on this process: batch_size *
        # num_iterations micro-batches (gradient accumulation), its rank's
        # shard of the global batch
        self.micro_batch = int(dl.get("batch_size", 32))
        self.num_iterations = int(self.runner_config.get("num_iterations", 1))
        self.loader = Loader(self.train_dataset,
                             batch_size=self.micro_batch * self.num_iterations,
                             shuffle=True, seed=self.seed,
                             num_workers=int(dl.get("num_workers", 4)),
                             process_index=self.data_rank, process_count=self.data_world)
        ds_cfg = self.config["train_dataset_config"]
        self.device_resident = bool(ds_cfg.get("device_resident", False))
        self.resident_sampling = str(ds_cfg.get("resident_sampling", "epoch"))
        if self.resident_sampling not in ("epoch", "uniform"):
            raise ValueError(f"train_dataset_config.resident_sampling must be 'epoch' or "
                             f"'uniform', got {self.resident_sampling!r}")
        self._resident_cache = None

    def _step_batch_keys(self):
        """The batch keys the step reads (None: all); the rest stay on the
        host."""
        return None

    def _batch_iterator(self, start_step: int = 0) -> Iterator[dict]:
        """The batch stream on the device, fast-forwarded so that step N takes
        the batch an uninterrupted run would: gathered from the resident
        corpus, or loaded on the host and prefetched."""
        if self.device_resident:
            return self._resident_batches(start_step)
        epoch, offset = divmod(start_step, self.loader.batches_per_epoch())
        return prefetch_to_device(
            self.loader.infinite(start_epoch=epoch, skip_batches=offset),
            self.device, size=2, keys=self._step_batch_keys())

    # -- device-resident data -------------------------------------------- #

    def _resident_device_data(self) -> Dict[str, torch.Tensor]:
        """The step-consumed keys of the whole corpus on the device (images
        NCHW, in the dtype the dataset collates), made once per trainer."""
        if self._resident_cache is None:
            from .resident import materialize_step_arrays
            host = materialize_step_arrays(self.train_dataset, self._step_batch_keys())
            mb = sum(a.nbytes for a in host.values()) / 2 ** 20
            print(f"device-resident corpus: {len(self.train_dataset)} items, "
                  f"{mb:.1f} MB on {self.device}", flush=True)
            self._resident_cache = batch_to_device(host, self.device)
        return self._resident_cache

    def _resident_sample(self, indices: Optional[torch.Tensor] = None) -> dict:
        """A batch gathered on the device from the resident corpus: the rows
        at ``indices`` (``epoch``) or at uniform draws (``uniform``), then,
        where the dataset augments, a horizontal flip of each row by a coin;
        the draws come from the data stream's generator as it is seeded."""
        from .resident import sample_batch
        return sample_batch(self._resident_device_data(), self._data_gen.generator,
                            self.loader.batch_size, len(self.train_dataset),
                            flip=bool(getattr(self.train_dataset, "augmentation", False)),
                            indices=indices, rows=(self.data_rank, self.data_world))

    def _resident_batches(self, start_step: int) -> Iterator[dict]:
        """Step N's batch gathered on the device from the resident corpus,
        at row N of the host loader's index stream (``epoch``) or at uniform
        draws (``uniform``), with the data generator seeded with (seed,
        ``DATA_STREAM_TAG``, N)."""
        rows = (self._resident_index_chunks(start_step, 1, None)
                if self.resident_sampling == "epoch" else None)
        step = start_step
        while True:
            indices = None
            if rows is not None:
                indices = torch.from_numpy(next(rows)[0]).to(self.device, torch.int64)
            self._data_gen.at(step)
            yield self._resident_sample(indices)
            step += 1

    def _resident_index_chunks(self, start_step: int, k: int,
                               max_steps: Optional[int]) -> Iterator[np.ndarray]:
        """The ``epoch`` index stream as int32 ``[c, B]`` host arrays, one a
        chunk of ``_chunk_schedule``: row N is the host loader's batch N, this
        rank's columns of the global row (``resident.epoch_global_indices``),
        as ``pdae_tpu`` ships them."""
        from .resident import epoch_global_indices
        epoch, offset = divmod(start_step, self.loader.batches_per_epoch())

        def rows():
            e, off = epoch, offset
            while True:
                table = epoch_global_indices(self.loader, e)
                for i in range(off, len(table)):
                    yield table[i]
                off, e = 0, e + 1

        it = rows()
        cols = slice(self.data_rank * self.loader.batch_size,
                     (self.data_rank + 1) * self.loader.batch_size)
        for c in self._chunk_schedule(start_step, k, max_steps):
            yield np.stack([next(it)[cols] for _ in range(c)])

    @staticmethod
    def _chunk_schedule(start_step: int, k: int, max_steps: Optional[int]) -> Iterator[int]:
        """Chunk sizes covering (start_step, max_steps]: first up to the next
        multiple of ``k`` (a resume may start anywhere), then ``k`` at a
        time, then the tail; ``pdae_tpu``'s schedule."""
        s = start_step
        while max_steps is None or s < max_steps:
            c = k - s % k if s % k else k
            if max_steps is not None:
                c = min(c, max_steps - s)
            yield c
            s += c

    @contextlib.contextmanager
    def seeded(self, step: int):
        """Every stream of step ``step`` seeded, so a resumed run, and a
        replay of the captured step, draws what an uninterrupted eager run
        draws there: the train and data streams' generators and, where the
        trained modules have dropout (``self._dropout``), the global RNG
        with (seed, ``DROPOUT``, step, data index), restored after the step:
        rank 0 draws what one process draws, the other data indices masks of
        their own, and the ranks of a model group the same masks."""
        self._train_gen.at(step)
        self._data_gen.at(step)
        if not self._dropout:
            yield
            return
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(stream_seed(self.seed, DROPOUT, step, self.data_rank))
            yield

    # -- subclass hooks -------------------------------------------------- #

    def _compute_dtype(self) -> torch.dtype:
        """The models' compute dtype: ``runner_config.compute_dtype`` where
        set, else bf16 where ``optimizer_config.enable_amp`` asks for it (bf16
        compute over fp32 params in place of the reference's AMP and
        GradScaler), else fp32, which is what ``pdae_tpu``'s trainer picks
        off a TPU."""
        name = self.runner_config.get("compute_dtype")
        if name is None:
            amp = (self.config.get("optimizer_config") or {}).get("enable_amp")
            return torch.bfloat16 if amp else torch.float32
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]

    def _build(self):
        raise NotImplementedError

    def _shard_module(self, module: nn.Module, to_tree) -> None:
        """Under tensor parallelism, ``module`` laid out over the model
        group (``parallel/tp.py``; ``to_tree`` maps its state dict to the flax
        tree): its sharded parameters become the rank's blocks. Under spatial
        parallelism its UNets and encoders run on the rank's rows
        (``parallel/sp.py``) where the images' height splits. Call it before
        the module's parameters go into the state."""
        if self.tp_layout is not None:
            self.tp_layout.add(module, to_tree)
        if self.sp_groups is not None:
            size = int(self.config["train_dataset_config"]["image_size"])
            for m in spatial_parallel.shard_rows(module, self.sp_groups, size):
                self._split_params.update(id(p) for p in m.parameters())

    def _partial_grads(self, params) -> bool:
        """Whether the gradients of ``params`` are each rank's partial sums
        over the sp group: some of them run split (a module whose input does
        not split runs whole on every rank, and its gradients are whole)."""
        return any(id(p) in self._split_params for p in params)

    def _sp_sum(self, params) -> Optional[Any]:
        """``sum(grads)``: the gradients summed over the sp group in place
        (the pre-reduction of ``fsdp+sp``), where they are partial sums;
        else None."""
        return spatial_parallel.grad_sum(sum(p.numel() for p in params), self.device,
                                         self.sp_groups, self._partial_grads(params))

    def _freeze(self, group: str, module: nn.Module, to_tree,
                params: Optional[Dict[str, nn.Parameter]] = None) -> None:
        """Hand a frozen module (``to_tree`` maps its state dict to the flax
        tree; ``params``: its frozen parameters by name, by default all) to
        the FSDP plan, which holds the sharded ones as blocks; call it before
        ``_shard_state``."""
        self._frozen[group] = (dict(module.named_parameters()) if params is None else params,
                               to_tree, module)

    def _shard_state(self, params: Dict[str, Dict], to_trees: Dict[str, Any],
                     modules=()) -> None:
        """The trained ``params`` (``{group: {name: Parameter}}``, the
        rank's tp blocks under tensor parallelism) laid out: under ``fsdp``,
        ``fsdp+tp`` or ``fsdp+sp`` with a tensor group the FSDP plan
        (``to_trees[group]`` maps a group's state dict to its flax tree; over
        a host's row under ``hier``, over the data group under ``fsdp+tp`` and
        ``fsdp+sp``) of them (``modules`` hold them) and of the frozen
        modules' tensors (``_freeze``), then the optimizer
        (``optimizer_config``) over the masters and the ``TrainState``."""
        self.optimizer_config = self.config["optimizer_config"]
        if parallel.tensor_backend() is not None and "fsdp" in self.param_sharding.split("+"):
            held = {"modules": list(modules) + [m for _, _, m in self._frozen.values()],
                    "frozen": {g: named for g, (named, _, _) in self._frozen.items()},
                    "frozen_trees": {g: tree for g, (_, tree, _) in self._frozen.items()}}
            if self.param_sharding == "fsdp" and self.hier_groups is not None:
                g = self.hier_groups
                self.plan = FsdpPlan(params, to_trees, self.fsdp_min_size, self.device,
                                     g.row_group, (g.col, g.cols),
                                     whole_group=parallel.tensor_group(),
                                     replica_group=g.col_group if g.rows > 1 else None,
                                     **held)
            elif self.param_sharding == "fsdp":
                self.plan = FsdpPlan(params, to_trees, self.fsdp_min_size, self.device,
                                     **held)
            elif self.param_sharding == "fsdp+tp":
                g = self.tp_layout.groups
                self.plan = FsdpPlan(
                    params, to_trees, self.fsdp_min_size, self.device, g.data_group,
                    (g.data_index, g.dp), self.tp_layout.fsdp_rule({**params,
                                                                    **held["frozen"]}),
                    self.tp_layout.model_sum(flat_params(params), self.device), **held)
            else:
                g = self.sp_groups
                self.plan = FsdpPlan(params, to_trees, self.fsdp_min_size, self.device,
                                     g.data_group, (g.data_index, g.dp),
                                     pre_reduce=self._sp_sum(flat_params(params)), **held)
        masters = params if self.plan is None else self.plan.masters
        self.optimizer = make_optimizer(self.optimizer_config, flat_params(masters))
        self.state = TrainState.create(params, self.optimizer, plan=self.plan,
                                       tp=self.tp_layout)

    def _data_parallel(self) -> dict:
        """The ``rows``, ``reduce`` and ``plan`` arguments of
        ``make_*_train_step``: this rank's place among the data shards, and
        the mean all-reduce of the gradients and the loss through one flat
        buffer made here (None in one process; under tensor parallelism the
        layout's reducer), or the FSDP plan in its place."""
        rows = (self.data_rank, self.data_world)
        if self.plan is not None:
            return {"rows": rows, "reduce": None, "plan": self.plan}
        params = flat_params(self.state.params)
        if self.tp_layout is not None:
            return {"rows": rows, "reduce": self.tp_layout.reducer(params, self.device),
                    "plan": None}
        numel = 1 + sum(p.numel() for p in params)
        if self.sp_groups is not None:
            return {"rows": rows, "plan": None,
                    "reduce": spatial_parallel.grad_reducer(numel, self.device,
                                                            self.sp_groups,
                                                            self._partial_grads(params))}
        return {"rows": rows, "reduce": parallel.mean_all_reducer(numel, self.device),
                "plan": None}

    @property
    def step(self) -> int:
        raise NotImplementedError

    def _step(self, batch, ema: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device batch, drawing from the generators
        as they are seeded; ``ema`` as ``steps._update`` takes it. Returns
        the step's losses, on the device."""
        raise NotImplementedError

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One eager step on a device batch, at the live step."""
        with self.seeded(self.step):
            return self._step(batch)

    def _graph_body(self, inputs: Dict[str, torch.Tensor], ema: bool):
        """The step a CUDA graph captures: ``_step`` on the static
        ``inputs`` (the batch, or the resident corpus's index row)."""
        if self.device_resident:
            return self._step(self._resident_sample(inputs.get("indices")), ema=ema)
        return self._step(inputs, ema=ema)

    def evaluate(self, step: int):
        pass

    def _eval_shard(self, total: int) -> slice:
        """This rank's share of ``total`` eval images: the rows
        ``parallel.dispatch_num_samples_for_process`` gives it, after the
        lower ranks' (the reference's split, gathered in rank order)."""
        count = parallel.dispatch_num_samples_for_process
        rank, world = self.data_rank, self.data_world
        offset = sum(count(total, rank=r, world=world) for r in range(rank))
        return slice(offset, offset + count(total, rank=rank, world=world))

    def _gather_eval_images(self, local_imgs: np.ndarray) -> Optional[np.ndarray]:
        """The data shards' eval images concatenated in order on the
        primary (under tensor parallelism, those of each model group's first
        rank); None on the others. Collective: every rank calls it."""
        parts = parallel.gather_objects([np.asarray(local_imgs)])
        step = self.world // self.data_world
        return np.concatenate(parts[::step], axis=0) if self.primary else None

    def _eval_ema(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The EMA of the trained tensors, keyed as ``state.params``: whole,
        under FSDP gathered on every rank, on the card (collective); under
        tensor parallelism the rank's tp blocks, which the split forward
        takes."""
        ema = self.state.ema_params
        if self.plan is None:
            return ema
        names = [(g, k) for g in ema for k in ema[g]]
        whole = self.plan.gather([ema[g][k] for g, k in names])
        out = {g: {} for g in ema}
        for (g, k), t in zip(names, whole):
            out[g][k] = t
        return out

    def _whole_frozen(self):
        """The frozen modules whole for the block's duration (an eval), under
        FSDP gathered on every rank (collective); as they are without a
        plan."""
        return contextlib.nullcontext() if self.plan is None else self.plan.whole_frozen()

    def _load_module(self, module: nn.Module, state_dict: Dict[str, Any]) -> None:
        """``module.load_state_dict(state_dict, strict=True)``, under FSDP
        into the blocks of the tensors the plan holds."""
        if self.plan is None:
            module.load_state_dict(state_dict, strict=True)
        else:
            self.plan.load_module(module, state_dict)

    def _frozen_snapshot(self) -> Dict[str, Any]:
        """What a snapshot holds besides the trained state (the
        representation trainer's trunk tree)."""
        return {}

    def snapshot_state(self, full: bool = False) -> Dict[str, Any]:
        """Host copies of the trained state, taken now (the step updates
        tensors in place), in one copy (``state.host_copy``): ``count`` and,
        each ``{group: {name: tensor}}``, ``params``, ``ema``, ``mu`` and
        ``nu``. Under FSDP this rank's blocks, or with ``full`` the whole
        tensors, gathered on the card (collective)."""
        masters, ema = self.state.masters, self.state.ema_params
        names = [(g, k) for g in masters for k in masters[g]]
        live = [masters[g][k] for g, k in names]
        count, mu, nu = adam_moments(self.optimizer, live)
        held = [ema[g][k] for g, k in names] + mu + nu
        if full and self.plan is not None:
            whole = self.plan.gather(live + held)
            live, held = whole[:len(names)], whole[len(names):]
        if full and self.tp_layout is not None:
            params = [self.state.params[g][k] for g, k in names]
            whole = self.tp_layout.gather(live + held, params * 4)
            live, held = whole[:len(names)], whole[len(names):]
        copies = host_copy(live + held)
        n = len(names)
        out = {"count": count}
        for i, cat in enumerate(("params", "ema", "mu", "nu")):
            out[cat] = {g: {} for g in masters}
            for (g, k), t in zip(names, copies[i * n:(i + 1) * n]):
                out[cat][g][k] = t
        return {**out, **self._frozen_snapshot()}

    def checkpoint_tree(self, snapshot) -> Dict[str, Any]:
        """The checkpoint's trees (flax layout, numpy) from a snapshot."""
        raise NotImplementedError

    def load_state_dict(self, raw) -> None:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        """The checkpoint's trees, whole (collective under FSDP)."""
        return self.checkpoint_tree(self.snapshot_state(full=True))

    def _skeleton(self) -> Dict[str, Dict]:
        """The checkpoint's manifest skeleton, each leaf's global ``{shape,
        dtype}`` keyed by path, made once from the whole parameters (whole
        on every rank; under FSDP or tensor parallelism host zeros of the
        whole shapes)."""
        if self._skeleton_cache is None:
            params = self.state.params
            names = [(g, k) for g in params for k in params[g]]
            if self.tp_layout is not None:
                copies = [torch.zeros(self.tp_layout.whole_shape(params[g][k]))
                          for g, k in names]
            elif self.plan is not None:
                copies = [torch.zeros(params[g][k].shape) for g, k in names]
            else:
                copies = host_copy([params[g][k] for g, k in names])
            whole = {g: {} for g in params}
            for (g, k), t in zip(names, copies):
                whole[g][k] = t
            snap = {"count": 0, "params": whole, "ema": whole, "mu": whole, "nu": whole,
                    **self._frozen_snapshot()}
            self._skeleton_cache = manifest_skeleton(
                {"step": np.asarray(0, np.int32), **self.checkpoint_tree(snap)})
        return self._skeleton_cache

    def _template(self) -> Dict[str, Any]:
        """The checkpoint's tree with leaves of its shapes (zero-size
        broadcasts), for ``restore_into``."""
        tree: Dict[str, Any] = {}
        for path, desc in self._skeleton().items():
            *parents, leaf = path.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = {} if desc.get("empty") else np.broadcast_to(
                np.float32(0), tuple(desc["shape"]))
        return tree

    # -- checkpointing --------------------------------------------------- #

    def save(self, step: int, snapshot: bool = False):
        """Checkpoint ``latest.ckpt`` (and ``save-{N}k.ckpt`` when
        ``snapshot``) in ``checkpoint_format``. ``full``: on the primary alone
        (under FSDP after a gather of the state, which every rank joins). The
        host copy happens here; the relayout, the serialisation and the
        atomic writes run in a background thread. ``sharded``:
        ``_save_sharded``."""
        paths = [os.path.join(self.run_path, "checkpoints", "latest.ckpt")]
        if snapshot:
            paths.append(snapshot_path(self.run_path, step))
        if self.checkpoint_format == "sharded":
            return self._save_sharded(step, paths)
        t0 = time.perf_counter()
        gathered = self.plan is not None or self.tp_layout is not None
        if gathered:
            snap = self.snapshot_state(full=True)
        if not self.primary:
            return
        if not gathered:
            snap = self.snapshot_state()
        self._join_save()
        record = [0.0, None]

        def tree():
            return {"step": np.asarray(step, np.int32), **self.checkpoint_tree(snap)}

        file_paths = []
        for p in paths:
            if os.path.isdir(p):
                # a sharded checkpoint of a JAX run: write the file beside it
                # first, then drop the directory and rename, so no moment
                # leaves the run without a checkpoint
                if not _ours_ckpt_dir(p):
                    raise ValueError(f"checkpoint target {p} is a directory but not "
                                     "a sharded checkpoint; refusing to overwrite")
                save_checkpoint(p + ".swap", tree())
                shutil.rmtree(p)
                os.replace(p + ".swap", p)
            else:
                file_paths.append(p)
        record[0] = time.perf_counter() - t0
        self.save_seconds.append(record)
        if not file_paths:
            return

        def write():
            w0 = time.perf_counter()
            sd = tree()
            for p in file_paths:
                save_checkpoint(p, sd)
            record[1] = time.perf_counter() - w0

        self._spawn_save(write)

    def _sharded_targets(self, paths) -> list:
        """``(path, directory to write)`` of a sharded save: a directory in
        place (it must be a sharded checkpoint, a torn one or empty), a new
        one at the path, or, over a file (a ``full`` save), the sibling
        ``path.swap``, renamed over the file once its manifest is written."""
        out = []
        for p in paths:
            if os.path.isdir(p):
                if not _ours_ckpt_dir(p):
                    raise ValueError(f"checkpoint target {p} is a directory but not "
                                     "a sharded checkpoint; refusing to overwrite")
                out.append((p, p))
            else:
                out.append((p, p + ".swap" if os.path.exists(p) else p))
        return out

    @staticmethod
    def _clear_swap(targets) -> None:
        """Drop what an interrupted save left at a ``.swap`` target."""
        for p, target in targets:
            if target == p or not os.path.lexists(target):
                continue
            if os.path.isdir(target):
                if not _ours_ckpt_dir(target):
                    raise ValueError(f"{target} is a directory but not a sharded "
                                     "checkpoint; refusing to overwrite")
                shutil.rmtree(target)
            else:
                os.unlink(target)

    def _finish_sharded(self, targets, skeleton, tag: str) -> None:
        """The primary's end of a sharded save: the manifest in each target,
        a ``.swap`` target renamed over the file it replaces, and the shard
        files no manifest lists removed."""
        for p, target in targets:
            write_manifest(target, skeleton, tag, self.world)
            if target != p:
                os.unlink(p)
                os.replace(target, p)
            cleanup_stale_shards(p)

    def _save_sharded(self, step: int, paths) -> None:
        """``checkpoint_format: sharded``: every rank writes the pieces it
        holds of the checkpoint's leaves in the flax layout, with no gather
        (``fsdp.local_pieces``: its blocks of the sharded tensors; on rank 0
        the leaves whole everywhere), into ``shard-<step>-<rank>-of-<world>``;
        the primary writes the manifest last, after every rank's file is on
        disk, then drops stale shard files (``pdae_tpu``'s
        ``_save_sharded``). One process: the host copy here, the rest in the
        background writer. Several: synchronous, since the barrier before
        the manifest is a collective; a rank whose write failed asks for the
        consensus stop and raises once every rank has left the loop, and no
        manifest is written."""
        t0 = time.perf_counter()
        targets = self._sharded_targets(paths)
        snap = self.snapshot_state()
        skeleton = self._skeleton()
        tag = str(int(step))
        self._join_save()
        record = [0.0, None]
        self.save_seconds.append(record)

        def write_pieces():
            tree = {"step": np.asarray(step, np.int32), **self.checkpoint_tree(snap)}
            index = (None if self.tp_layout is None else
                     self.tp_layout.piece_index(self.plan is not None))
            if self.sp_groups is not None:
                index = spatial_parallel.piece_index(self.sp_groups)
            if self.hier_groups is not None:
                index = hier_parallel.piece_index(self.hier_groups)
            pieces = local_pieces(tree, skeleton, self.rank, self.world, index)
            for _, target in targets:
                os.makedirs(target, exist_ok=True)
                write_shard_file(target, pieces, tag, self.rank, self.world)

        if self.world == 1:
            record[0] = time.perf_counter() - t0

            def write():
                w0 = time.perf_counter()
                self._clear_swap(targets)
                write_pieces()
                self._finish_sharded(targets, skeleton, tag)
                record[1] = time.perf_counter() - w0

            self._spawn_save(write)
            return
        err = None
        try:
            if self.primary:
                self._clear_swap(targets)
        except Exception as e:           # reported below, after the barrier
            err = e
        parallel.sync_global_devices("sharded_ckpt_targets")
        w0 = time.perf_counter()
        if err is None:
            try:
                write_pieces()
            except Exception as e:
                err = e
        written = all(parallel.gather_objects([err is None]))
        if written and self.primary:
            try:
                self._finish_sharded(targets, skeleton, tag)
            except Exception as e:
                err = e
        # the next save reads the targets as the primary left them
        parallel.sync_global_devices("sharded_ckpt_done")
        record[:] = [time.perf_counter() - t0, time.perf_counter() - w0]
        if err is not None:
            # raising here would leave the other ranks in their next
            # collective: ask for the consensus stop, raise after the loop
            self._save_error_deferred = ("sharded", err)
            self._stop_local = True
            print(f"sharded checkpoint write failed on rank {self.rank} ({err!r}); "
                  "stopping by consensus", flush=True)

    def _spawn_save(self, fn):
        """Run ``fn`` in a background thread; an exception is kept and
        re-raised by the next ``_join_save``."""
        def runner():
            try:
                fn()
            except BaseException as e:   # re-raised on join
                self._save_error = e

        self._save_error = None
        self._save_thread = threading.Thread(target=runner, daemon=False)
        self._save_thread.start()

    def _join_save(self):
        t = self._save_thread
        if t is not None:
            t.join()
            self._save_thread = None
            err, self._save_error = self._save_error, None
            if err is None:
                return
            if self.world == 1:
                raise RuntimeError("background checkpoint write failed") from err
            # raising on the primary alone would leave the other ranks in
            # their next collective: ask for the consensus stop and raise
            # once every rank has left the loop
            self._save_error_deferred = ("background", err)
            self._stop_local = True
            print(f"checkpoint write failed ({err!r}); stopping by consensus", flush=True)

    # -- loop ------------------------------------------------------------ #

    def _replays(self, k: int) -> bool:
        """Whether chunks of ``k`` steps run from a captured graph: on the
        card, for ``k`` > 1."""
        return k > 1 and self.device.type == "cuda"

    def _chunk_runner(self, start_step: int, k: int, max_steps: Optional[int]):
        """``run(c) -> (per-step losses, seconds spent loading)``: the next
        ``c`` steps from ``start_step``. With ``k`` > 1 on the card each step
        is a replay of the captured step (``dispatch.GraphDispatch``), fed
        the host batch or, from a resident corpus, the epoch stream's index
        row; else an eager ``train_step`` on the batch stream."""
        if self._replays(k):
            from .dispatch import GraphDispatch
            if parallel.tensor_backend() == "gloo":
                raise ValueError(f"runner_config.steps_per_dispatch={k} on the card needs an "
                                 "NCCL tensor group: a gloo all-reduce cannot be captured "
                                 "into a CUDA graph (set steps_per_dispatch: 1 for gloo)")
            if self._dispatch is None:
                self._dispatch = GraphDispatch(self)
            graph = self._dispatch
            if self.device_resident:
                rows = (self._resident_index_chunks(start_step, k, max_steps)
                        if self.resident_sampling == "epoch" else None)

                def run(c):
                    t0 = time.perf_counter()
                    idx = None
                    if rows is not None:
                        idx = torch.from_numpy(next(rows).astype(np.int64))
                        if self.device.type == "cuda":
                            idx = idx.pin_memory()
                        idx = idx.to(self.device, non_blocking=True)
                    load = time.perf_counter() - t0
                    return [graph.step({} if idx is None else {"indices": idx[i]})
                            for i in range(c)], load
                return run
            source = graph.step
        else:
            source = self.train_step
        it = self._batch_iterator(start_step)

        def run(c):
            out, load = [], 0.0
            for _ in range(c):
                t0 = time.perf_counter()
                batch = next(it)
                load += time.perf_counter() - t0
                out.append(source(batch))
            return out, load
        return run

    def _start_profiler(self):
        """The loop's trace under ``runner_config.profile_dir``, started, on
        the primary rank (None elsewhere, or without the option)."""
        path = self.runner_config.get("profile_dir")
        if not path or not self.primary:
            return None
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(str(path)))
        profiler.start()
        return profiler

    def train(self, max_steps: Optional[int] = None, save_on_exit: bool = True) -> int:
        rc = self.runner_config
        display = int(rc.get("display_steps", 100))
        eval_every = int(rc.get("evaluate_every_steps", 5000))
        save_latest = int(rc.get("save_latest_every_steps", 1000))
        save_snap = int(rc.get("save_checkpoint_every_steps", 10000))
        k = int(rc.get("steps_per_dispatch", 1))
        if k > 1:
            # the cadences are read at chunk ends, so they must land on them
            for name, val in (("display_steps", display),
                              ("evaluate_every_steps", eval_every),
                              ("save_latest_every_steps", save_latest),
                              ("save_checkpoint_every_steps", save_snap)):
                if val % k:
                    raise ValueError(f"runner_config.{name}={val} must be a multiple "
                                     f"of steps_per_dispatch={k}")
        # continue from the live step, not the resume-time one: a second
        # train() call picks up where the first stopped
        step = self.step
        meters = Meters()
        losses = collections.defaultdict(list)
        chunks = self._chunk_schedule(step, k, max_steps)
        run_chunk = self._chunk_runner(step, k, max_steps)
        last_saved = step
        # several processes stop by consensus at a chunk end: a signal may
        # reach one rank alone, and every rank must leave at the same step
        multiproc = self.world > 1
        consensus_every = min(display, save_latest)
        stop = {"local": False, "flag": False}

        def _graceful(signum, frame):
            stop["local"] = True
            if not multiproc:
                stop["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _graceful)
            except ValueError:       # not the main thread
                pass
        t_end = time.perf_counter()
        window_steps = 0
        first_window = True     # the first window holds the warm-up
        profiler = None
        try:
            profiler = self._start_profiler()
            while (max_steps is None or step < max_steps) and not stop["flag"]:
                c = next(chunks)
                metrics, load_s = run_chunk(c)
                step += c
                window_steps += c
                # device scalars every step; one host sync per display window
                for m in metrics:
                    for name, v in m.items():
                        losses[name].append(v)
                meters.add("load_data", load_s, n=c)
                if step % display == 0:
                    avg = {name: float(np.mean([float(x) for x in v]))
                           for name, v in losses.items()}
                    window = time.perf_counter() - t_end
                    rate = 0.0 if first_window else window_steps / window
                    self.logger.scalars(step, {
                        **avg, "steps_per_sec": rate,
                        "time/step": window / max(window_steps, 1),
                        "time/load_data": meters.summary().get("load_data", 0.0)})
                    if self.primary:
                        print(f"step {step}: " + " ".join(f"{n}={v:.5f}"
                                                          for n, v in avg.items())
                              + f" ({rate:.2f} it/s)", flush=True)
                    losses.clear()
                    meters.reset()
                    first_window = False
                    window_steps = 0
                    t_end = time.perf_counter()
                if multiproc and step % consensus_every == 0:
                    stop["flag"] = any(parallel.gather_objects(
                        [stop["local"] or self._stop_local]))
                if step % save_latest == 0 or step % save_snap == 0:
                    # one save covers both cadences
                    self.save(step, snapshot=step % save_snap == 0)
                    last_saved = step
                if step % eval_every == 0:
                    self.evaluate(step)
            # the final save, on a normal exit only: after an exception the
            # last good checkpoint must stay as it is
            if step != last_saved and save_on_exit:
                self.save(step)
        finally:
            try:
                if profiler is not None:
                    profiler.stop()       # writes the trace
            finally:
                for sig, handler in old_handlers.items():
                    signal.signal(sig, handler)
                self._join_save()
        deferred, self._save_error_deferred = self._save_error_deferred, None
        if deferred is not None:
            kind, err = deferred
            raise RuntimeError(f"{kind} checkpoint write failed (the run stopped "
                               "by consensus)") from err
        return step
