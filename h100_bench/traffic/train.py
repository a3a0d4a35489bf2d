"""Traffic ``train``: the representation learner's training loop,
``RepresentationLearningTrainer.train``, as a trainer runs it.

Set-up builds one trainer from the cell's configuration (the SYNTHETIC
corpus through the trainer's own host loader, no DPM checkpoint), puts the
benchmark's seeded weights into its encoder, its decoder (trunk and
gradient branch) and their EMA, and drives it through its first chunk of
``runner_config.steps_per_dispatch`` (K) steps with ``train(max_steps=...)``,
the window's own call: step 1 (the graph dispatcher's eager warm-up), then
the capture and the replays up to step K.
The first gradient is read from Adam's first moment after step 1; Adam's
first moment, each trained leaf's change and the EMA's change after step
3, once two replays have run. The window is one ``train()`` call, stopped
after the chunk in flight once ``--seconds`` have passed, by the SIGINT
the trainer handles.

A traced run traces the window's first ``trace_steps`` steps (whole
chunks; the trace of a whole window of replays outgrows a run's time
limit) and trains on untraced to the window's end.

Parameters (the workload file): ``batch_size`` (sets the trainer's),
``runner_config`` (keys set over the configuration's: the eval and save
cadences, so that the window holds train steps alone), ``trace_steps``,
``limits``.
"""

from __future__ import annotations

import copy
import gc
import os
import shutil
import signal
import tempfile
import threading
import time

import torch

from .. import counts
from ..geometry import geometry
from ..reference.train import train_readings
from ..weights import make_weights


def trainer_config(config: dict, workload: dict) -> dict:
    """The trainer's config: the configuration's sections, with the
    workload's batch and runner keys."""
    keys = ("train_dataset_config", "eval_dataset_config", "diffusion_config",
            "encoder_config", "decoder_config", "dataloader_config", "optimizer_config",
            "runner_config")
    out = copy.deepcopy({k: config[k] for k in keys})
    out["trained_ddpm_config"] = config["denoise_fn_config"]
    out["dataloader_config"]["train"]["batch_size"] = int(workload["batch_size"])
    out["runner_config"].update(workload.get("runner_config", {}))
    return out


def leaf_gaps(mine: dict, ref: dict, keep) -> list:
    """|mine - ref| of each leaf in ``keep``, against the larger of its
    reference norm and the median leaf's."""
    median = float(torch.tensor([ref[k] for k in keep]).median())
    return [abs(mine[k] - ref[k]) / max(ref[k], median) for k in keep]


def compare(program: dict, reference: dict) -> dict:
    """The numbers ``correct`` is decided on: the worst leaf's gap of each
    norm, and the median leaf's gap of Adam's first moment after the
    replays, which the program's precision moves on every leaf and which is
    steadier from seed to seed than the worst leaf. Leaves whose first
    gradient in the reference is under a thousandth of the median leaf's
    move under Adam by rounding alone and are left out of the leaf gaps."""
    grads = reference["grad_norms"]
    median = float(torch.tensor(list(grads.values())).median())
    keep = [k for k, g in grads.items() if g >= 1e-3 * median]
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))
    gaps = {"loss_gap": loss}
    for name, key in (("grad", "grad_norms"), ("moment", "moment_norms"),
                      ("delta", "delta_norms"), ("ema", "ema_norms")):
        each = leaf_gaps(program[key], reference[key], keep)
        gaps[f"{name}_gap"] = max(each)
        if name == "moment":
            gaps["moment_median_gap"] = float(torch.tensor(each).median())
    return gaps


class Cell:

    def __init__(self, config, workload, seed, device, setup):
        self.config, self.workload, self.seed = config, workload, int(seed)
        self.device, self.setup_times = device, setup
        self.geometry = geometry(config)
        self.batch = int(workload["batch_size"])
        self.losses = []
        self.run_path = None
        self.trace, self.traced = None, 0

    # -- set-up ----------------------------------------------------------- #

    def _record_losses(self, trainer):
        """Keep every step's loss as the trainer's chunks return it, and
        mark each chunk in a trace."""
        runner = trainer._chunk_runner

        def chunk_runner(*args):
            run = runner(*args)

            def recorded(c):
                trace = self.trace
                if trace is not None and self.traced == 0:
                    trace.begin()
                with torch.profiler.record_function("bench.chunk"):
                    metrics, load = run(c)
                self.losses.extend(m["prediction_loss"] for m in metrics)
                if trace is not None and trace.open:
                    self.traced += c
                    if self.traced >= int(self.workload["trace_steps"]):
                        trace.end()
                return metrics, load
            return recorded
        trainer._chunk_runner = chunk_runner

    def _named_trained(self):
        st = self.trainer.state
        return {f"{g}.{k}": p for g, named in st.params.items() for k, p in named.items()}

    def _moment_norms(self) -> dict:
        """Each trained leaf's Adam first moment's norm over ``1 - beta1``
        (after one step: the gradient's); 0 for a leaf the optimizer never
        stepped."""
        from pdae_torch.training.state import flat_params
        state = self.trainer.optimizer.state
        beta1 = self.geometry["optimizer"]["adam_betas"][0]
        masters = flat_params(self.trainer.state.masters)
        return {k: float(state[p]["exp_avg"].double().norm()) / (1 - beta1)
                if "exp_avg" in state.get(p, {}) else 0.0
                for k, p in zip(self._named_trained(), masters)}

    def setup(self):
        with self.setup_times.part("program_imports"):
            from pdae_torch.ops import _build
            from pdae_torch.training import RepresentationLearningTrainer

        on_card = self.device.type == "cuda"
        if on_card:
            with self.setup_times.part("nvcc"):
                _build.build()
        self.run_path = tempfile.mkdtemp(prefix="h100_bench_train_")
        with self.setup_times.part("trainer_build"):
            cfg = trainer_config(self.config, self.workload)
            chunk = int(cfg["runner_config"]["steps_per_dispatch"])
            self.trainer = tr = RepresentationLearningTrainer(
                config=cfg, run_path=self.run_path, seed=self.seed, device=self.device)
        with self.setup_times.part("weights"):
            w = make_weights(self.geometry, self.seed, self.device)
            with torch.no_grad():
                for prefix, model in (("encoder.", tr.encoder), ("decoder.", tr.decoder)):
                    named = dict(model.named_parameters())
                    mine = {k[len(prefix):] for k in w if k.startswith(prefix)}
                    if set(named) != mine:
                        raise KeyError(f"{prefix} leaves differ from the reference's: "
                                       f"{sorted(set(named) ^ mine)[:5]}")
                    for k, p in named.items():
                        p.copy_(w[prefix + k])
                for g, named in tr.state.ema_params.items():
                    for k, e in named.items():
                        e.copy_(tr.state.params[g][k])
            start = {k: p.detach().clone() for k, p in self._named_trained().items()}
            del w
        self._record_losses(tr)
        with self.setup_times.part("first_steps"):
            tr.train(max_steps=1, save_on_exit=False)
            self.grad_norms = self._moment_norms()
            tr.train(max_steps=3, save_on_exit=False)
            self.moment_norms = self._moment_norms()
            self.delta_norms = {k: float((p.detach() - start[k]).double().norm())
                                for k, p in self._named_trained().items()}
            self.ema_norms = {f"{g}.{k}": float((e - start[f"{g}.{k}"]).double().norm())
                              for g, named in tr.state.ema_params.items()
                              for k, e in named.items()}
            del start
            self.first_losses = [float(x) for x in self.losses[:3]]
            tr.train(max_steps=chunk, save_on_exit=False)
            if on_card:
                # set-up's own buffers go back to the card: what the window
                # holds is the trainer's state, its graph's pool and its batches
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()

    # -- window ----------------------------------------------------------- #

    def window(self, seconds: float, trace=None) -> dict:
        tr = self.trainer
        self.trace = trace
        step0, seen = tr.step, len(self.losses)
        stop = threading.Timer(seconds, os.kill, (os.getpid(), signal.SIGINT))
        t0 = time.perf_counter()
        stop.start()
        try:
            step = tr.train(save_on_exit=False)
        finally:
            stop.cancel()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        span = time.perf_counter() - t0
        if trace is not None and trace.open:
            trace.end()
        self.trace = None
        steps = step - step0
        losses = torch.stack(self.losses[seen:]).float()
        failed = int((~torch.isfinite(losses)).sum())
        return {"metrics": {"train_imgs_per_s": steps * self.batch / span},
                "attempted": steps, "failed": failed, "traced_units": self.traced}

    # -- check ------------------------------------------------------------ #

    def check(self) -> dict:
        """The program's first steps against the plain reference's, and the
        frozen trunk against the weights it was given."""
        limits = self.workload["limits"]
        w = make_weights(self.geometry, self.seed, self.device)
        trunk_moved = 0
        with torch.no_grad():
            for k, p in self.trainer.decoder.named_parameters():
                if k.split(".")[0] not in ("label_emb", "shift_middle_block",
                                           "shift_output_blocks", "shift_out"):
                    trunk_moved += int((p != w["decoder." + k]).sum())
        program = {"losses": self.first_losses, "grad_norms": self.grad_norms,
                   "moment_norms": self.moment_norms, "delta_norms": self.delta_norms,
                   "ema_norms": self.ema_norms}
        self.close()
        reference = train_readings(self.geometry, self.batch, w, self.seed, self.device)
        gaps = compare(program, reference)
        gaps["trunk_moved"] = float(trunk_moved)
        return {k: (v, float(limits[k])) for k, v in gaps.items()}

    def counts(self) -> dict:
        return counts.train_step(self.geometry, self.batch)

    def close(self):
        """Free the trainer and its device memory, and its run directory."""
        self.trainer = None
        self.losses = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.run_path:
            shutil.rmtree(self.run_path, ignore_errors=True)
            self.run_path = None
