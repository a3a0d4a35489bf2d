"""Base trainer: run dir, config snapshot, data plumbing, logging,
checkpoint cadence and the step loop. The port of ``pdae_tpu/training/base.py``
for one process on one device.

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
Not ported yet, and refused by name rather than ignored: sharded params and
checkpoints and profiler traces. ``steps_per_dispatch``
keeps the JAX trainer's cadence check, and each step still runs as one call:
eager torch has no fused multi-step program.
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

from .. import resolve_device
from ..data import Loader, build_dataset, prefetch_to_device
from ..data.pipeline import batch_to_device
from ..utils import (is_sharded_checkpoint, load_checkpoint, load_yaml,
                     save_checkpoint, save_yaml, snapshot_path)
from ..utils.config import overlay_eval_dataset_config
from ..utils.image import png_bytes
from ..utils.rng import DROPOUT, INIT, generator, stream_seed


class Meters:
    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    def add(self, name, dt):
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self):
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class Logger:
    """metrics.jsonl, and TensorBoard where ``torch.utils.tensorboard``
    imports."""

    def __init__(self, run_path: str, purge_step: int = 0):
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            os.makedirs(os.path.join(run_path, "tb"), exist_ok=True)
            self._tb = SummaryWriter(os.path.join(run_path, "tb"), purge_step=purge_step)
        self._jsonl = open(os.path.join(run_path, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float]):
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


def refuse_unported(config: dict) -> None:
    """Raise, naming the ROADMAP item that will lift it, for every option of
    the JAX trainer that the port does not run yet."""
    rc = config.get("runner_config") or {}
    world = int(os.environ.get("WORLD_SIZE", "1"))
    checks = [
        (world > 1, f"WORLD_SIZE={world}: data-parallel training across processes", 15),
        (rc.get("param_sharding", "replicated") != "replicated",
         f"runner_config.param_sharding={rc.get('param_sharding')!r}", 15),
        (rc.get("checkpoint_format", "full") == "sharded",
         "runner_config.checkpoint_format='sharded'", 15),
        (bool(rc.get("profile_dir")), "runner_config.profile_dir", 6),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue 1 "
                                      f"item {item})")
    if rc.get("checkpoint_format", "full") not in ("full", "sharded"):
        raise ValueError(f"runner_config.checkpoint_format must be 'full' or 'sharded', "
                         f"got {rc['checkpoint_format']!r}")
    if rc.get("compute_dtype") not in (None, "float32", "bfloat16"):
        raise ValueError(f"runner_config.compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {rc['compute_dtype']!r}")


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
    loop); the modules' own tensors are never touched."""
    flat = {f"mods.{m}.{k}": v for m, named in weights.items() for k, v in named.items()}
    return torch.func.functional_call(_Bound(modules, fn), flat, args)


class BaseTrainer:
    """Drive a train step over an endless batch stream on one device.

    ``device``: ``cuda`` unless the caller names another; without a card it
    must be given."""

    def __init__(self, config: Optional[dict] = None, config_path: Optional[str] = None,
                 run_path: str = "./runs/dev", resume: Optional[str] = None,
                 seed: int = 0, device=None):
        assert config is not None or config_path is not None
        self.config = config if config is not None else load_yaml(config_path)
        refuse_unported(self.config)
        self.device = resolve_device(device)
        self.run_path = run_path
        self.seed = seed
        self.runner_config = self.config["runner_config"]
        self.dataloader_config = self.config.get("dataloader_config", {})
        self.save_seconds = []      # (loop's wait, background write) per save
        self._save_thread = None
        self._save_error = None
        self._dropout = False       # the trained modules have dropout (_build says)

        os.makedirs(os.path.join(run_path, "checkpoints"), exist_ok=True)
        os.makedirs(os.path.join(run_path, "samples"), exist_ok=True)
        save_yaml(self.config, os.path.join(run_path, "config.yml"))

        self._build_datasets()
        self._build()          # subclass: models, state, step

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
        self.logger = Logger(run_path, purge_step=self.start_step)

    # -- data ----------------------------------------------------------- #

    def _build_datasets(self):
        self.train_dataset = build_dataset(self.config["train_dataset_config"])
        self.eval_dataset = build_dataset(overlay_eval_dataset_config(self.config))
        dl = self.dataloader_config.get("train", {})
        # the batch of one optimizer step: batch_size * num_iterations
        # micro-batches (gradient accumulation)
        self.micro_batch = int(dl.get("batch_size", 32))
        self.num_iterations = int(self.runner_config.get("num_iterations", 1))
        self.loader = Loader(self.train_dataset,
                             batch_size=self.micro_batch * self.num_iterations,
                             shuffle=True, seed=self.seed,
                             num_workers=int(dl.get("num_workers", 4)))
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

    def _resident_batches(self, start_step: int) -> Iterator[dict]:
        """Step N's batch gathered on the device from the resident corpus:
        at row N of the host loader's index stream (``epoch``) or at
        uniform draws (``uniform``), then, where the dataset augments, a
        horizontal flip of each row by a coin; the draws come from a
        generator seeded with (seed, ``DATA_STREAM_TAG``, N)."""
        from .resident import DATA_STREAM_TAG, epoch_global_indices, sample_batch
        data = self._resident_device_data()
        n, size = len(self.train_dataset), self.loader.batch_size
        flip = bool(getattr(self.train_dataset, "augmentation", False))
        bpe = self.loader.batches_per_epoch()
        epoch, row = divmod(start_step, bpe)
        table = None
        step = start_step
        while True:
            indices = None
            if self.resident_sampling == "epoch":
                if table is None:
                    table = torch.from_numpy(epoch_global_indices(self.loader, epoch))
                indices = table[row].to(self.device, torch.int64)
                row += 1
                if row == bpe:
                    table, epoch, row = None, epoch + 1, 0
            gen = generator(self.seed, DATA_STREAM_TAG, step, self.device)
            yield sample_batch(data, gen, size, n, flip=flip, indices=indices)
            step += 1

    @contextlib.contextmanager
    def seeded_dropout(self, step: int):
        """Where the trained modules have dropout (``self._dropout``), the
        step runs with the global RNG seeded with (seed, ``DROPOUT``, step),
        restored after it, so a resumed run draws the same masks."""
        if not self._dropout:
            yield
            return
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(stream_seed(self.seed, DROPOUT, step))
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

    @property
    def step(self) -> int:
        raise NotImplementedError

    def train_step(self, batch) -> Dict[str, Any]:
        raise NotImplementedError

    def evaluate(self, step: int):
        pass

    def snapshot_state(self) -> Any:
        """Host copies of the state, taken now (the step updates tensors in
        place)."""
        raise NotImplementedError

    def checkpoint_tree(self, snapshot) -> Dict[str, Any]:
        """The checkpoint's trees (flax layout, numpy) from a snapshot."""
        raise NotImplementedError

    def load_state_dict(self, raw) -> None:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return self.checkpoint_tree(self.snapshot_state())

    # -- checkpointing --------------------------------------------------- #

    def save(self, step: int, snapshot: bool = False):
        """Checkpoint ``latest.ckpt`` (and ``save-{N}k.ckpt`` when
        ``snapshot``). The host copy happens here; the relayout, the
        serialisation and the atomic writes run in a background thread."""
        t0 = time.perf_counter()
        snap = self.snapshot_state()
        self._join_save()
        paths = [os.path.join(self.run_path, "checkpoints", "latest.ckpt")]
        if snapshot:
            paths.append(snapshot_path(self.run_path, step))
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
            if err is not None:
                raise RuntimeError("background checkpoint write failed") from err

    # -- loop ------------------------------------------------------------ #

    def train(self, max_steps: Optional[int] = None, save_on_exit: bool = True) -> int:
        rc = self.runner_config
        display = int(rc.get("display_steps", 100))
        eval_every = int(rc.get("evaluate_every_steps", 5000))
        save_latest = int(rc.get("save_latest_every_steps", 1000))
        save_snap = int(rc.get("save_checkpoint_every_steps", 10000))
        k = int(rc.get("steps_per_dispatch", 1))
        if k > 1:
            # the JAX trainer scans k steps into one program and its
            # cadences must land on chunk ends; the port keeps the check so
            # that a config one package refuses the other refuses too
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
        it = self._batch_iterator(step)
        last_saved = step
        stop = {"flag": False}

        def _graceful(signum, frame):
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
        try:
            while (max_steps is None or step < max_steps) and not stop["flag"]:
                t0 = time.perf_counter()
                batch = next(it)
                t1 = time.perf_counter()
                metrics = self.train_step(batch)
                step += 1
                window_steps += 1
                # device scalars every step; one host sync per display window
                for name, v in metrics.items():
                    losses[name].append(v)
                meters.add("load_data", t1 - t0)
                if step % display == 0:
                    avg = {name: float(np.mean([float(x) for x in v]))
                           for name, v in losses.items()}
                    window = time.perf_counter() - t_end
                    rate = 0.0 if first_window else window_steps / window
                    self.logger.scalars(step, {
                        **avg, "steps_per_sec": rate,
                        "time/step": window / max(window_steps, 1),
                        "time/load_data": meters.summary().get("load_data", 0.0)})
                    print(f"step {step}: " + " ".join(f"{n}={v:.5f}" for n, v in avg.items())
                          + f" ({rate:.2f} it/s)", flush=True)
                    losses.clear()
                    meters.reset()
                    first_window = False
                    window_steps = 0
                    t_end = time.perf_counter()
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
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            self._join_save()
        return step
