"""Data-parallel training in the port (``param_sharding: replicated`` over
torchrun processes), live on the CPU: two ranks over a gloo tensor group
(``tests/_torch_ddp_worker.py``, started with torchrun's environment) against
one process over the same global batch, in the ranks' row order.

Held here, at tiny geometries (16px gray, b4 a rank):

* the representation trainer (4 steps, a save at 2, an eval grid), the
  regular one (class conditions, ``num_iterations: 2``: micro-batch i of the
  global batch is the ranks' micro-batches i, rank 0's first), the latent
  one on a resident corpus by epoch rows (``precomputed`` z) and by uniform
  draws (the encoder in the step, flip coins on) and the manipulation one
  (host loader, its eval on the primary alone), each against one process:
  losses rtol ``LOSS_RTOL``; the last step's reduced gradients and the Adam
  moments within ``SCALED_ATOL`` times the tensor's own largest value (plus
  1e-8); params and EMA within ``PARAM_ATOL``, Adam eps 1e-5 as in
  ``tests/test_torch_training.py`` (a gradient that is rounding noise turns
  into a whole step at eps 1e-8);
* the two ranks' params, EMA, moments, gradients and count bit-equal, and
  the world-2 run resumed from its step-2 file bit-equal to the one that ran
  through;
* only rank 0 writing ``config.yml``, ``checkpoints/``, ``metrics.jsonl`` and
  ``samples/``; the eval grid (2 images on rank 0, 1 on rank 1) within
  ``GRID_LEVELS`` uint8 levels of one process's;
* a SIGTERM to rank 1 alone stops both ranks at the next consensus step (4),
  with the primary's checkpoint written there; a failed background write on
  the primary stops both at a consensus step, then raises on the primary;
* the two-rank step with injected draws against ``pdae_tpu``'s one-process
  representation step over the global batch, within
  ``tests/test_torch_training.py``'s parity tolerances;
* in one process, the draws of ``t``, noise, resident indices and coins are
  the ones the loss and ``sample_batch`` made before, bit for bit, and the
  ranks' cuts concatenate to one process's draws of the global batch;
* the refusals: a gloo group's chunks are never captured, and a torchrun
  world that did not join the group is refused.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (TRAINER_DPM, TRAINER_DS, TRAINER_OPT, TRAINER_RUNNER,
                           patch_tiny_encoders, tiny_pdae_config)
from _torch_sampler_files import read_png
from pdae_torch import parallel
from pdae_torch.data import Loader, build_dataset
from pdae_torch.data.pipeline import batch_to_device
from pdae_torch.diffusion import GaussianDiffusion
from pdae_torch.train import pick_trainer
from pdae_torch.training import resident
from pdae_torch.training.state import accumulate_grads
from pdae_torch.utils import encoder_state_dict, load_checkpoint, unet_state_dict
from pdae_tpu.training import partition as jax_partition
from test_stage34_sharded import build_stage34_artifacts, latent_cfg, manip_cfg
from test_torch_training import (DIFFUSION, EMA_DECAY, LATENT, OPT, SIZE, TINY_DPM, _Jax,
                                 _assert_groups_close)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD, MB = 2, 4                 # ranks, a rank's micro-batch
LOSS_RTOL = 1e-5
SCALED_ATOL = 1e-4               # gradients and Adam moments, times max|reference|
PARAM_ATOL = 1e-6                # params and EMA (lr 1e-3, 4-5 steps)
GRID_LEVELS = 1                  # uint8 levels of the eval grids
EPS_OPT = {**TRAINER_OPT, "adam_eps": 1e-5}
QUIET = {"display_steps": 1, "evaluate_every_steps": 100000,
         "save_latest_every_steps": 100000, "save_checkpoint_every_steps": 100000}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch_size(cfg, b):
    cfg = copy.deepcopy(cfg)
    cfg["dataloader_config"]["train"]["batch_size"] = b
    cfg["optimizer_config"] = {**cfg["optimizer_config"], "adam_eps": 1e-5}
    return cfg


def _configs(root):
    """{job: config} of the world-2 runs, MB a rank."""
    rep = tiny_pdae_config(**{**QUIET, "save_latest_every_steps": 2})
    rep["optimizer_config"] = dict(EPS_OPT)
    rep["dataloader_config"]["eval"]["num_generations"] = 3
    regular = {"train_dataset_config": {**TRAINER_DS, "length": 24},
               "eval_dataset_config": {},
               "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
               "denoise_fn_config": {**TRAINER_DPM, "num_class": 10},
               "dataloader_config": {"train": {"num_workers": 1, "batch_size": MB},
                                     "eval": {"num_generations": 2}},
               "optimizer_config": dict(EPS_OPT),
               "runner_config": {**TRAINER_RUNNER, **QUIET, "num_iterations": 2,
                                 "ema_every": 2}}
    out = {"representation": rep, "regular": regular}
    for name, sampling, source in (("latent_epoch", "epoch", "precomputed"),
                                   ("latent_uniform", "uniform", "encode")):
        cfg = latent_cfg(root, extra={**QUIET, "latent_train_source": source})
        cfg["train_dataset_config"].update(device_resident=True, transfer_uint8=True,
                                           resident_sampling=sampling)
        out[name] = cfg
    out["manipulation"] = manip_cfg(root, extra=dict(QUIET))
    out["sigterm"] = {**regular, "runner_config": {**regular["runner_config"],
                                                   "num_iterations": 1, "display_steps": 2}}
    return {name: _batch_size(cfg, MB) for name, cfg in out.items()}


STEPS = {"representation": 4, "regular": 4, "latent_epoch": 5, "latent_uniform": 4,
         "manipulation": 4}


def _jobs(root, configs, parity_inputs):
    jobs = [{"kind": "parity", "name": "parity", "inputs": parity_inputs, "latent": LATENT,
             "size": SIZE, "dpm": TINY_DPM, "optimizer": OPT, "diffusion": DIFFUSION,
             "ema_decay": EMA_DECAY}]
    for name, steps in STEPS.items():
        job = {"kind": "trainer", "name": name, "config": configs[name], "steps": steps,
               "root": str(root / name)}
        if name == "representation":
            job.update(copy_at=2, copy_to=str(root / "rep_step2.ckpt"),
                       eval={"ddim_style": "ddim10"})
        if name == "latent_uniform":
            job["augment"] = True
        if name == "manipulation":
            job["eval"] = {"encode_style": "ddim5", "decode_style": "ddim5", "class_id": 1}
        jobs.append(job)
    jobs.append({"kind": "trainer", "name": "representation_resume",
                 "config": configs["representation"], "steps": 4,
                 "root": str(root / "representation_resume"),
                 "resume": str(root / "rep_step2.ckpt")})
    jobs.append({"kind": "trainer", "name": "sigterm", "config": configs["sigterm"],
                 "steps": 40, "sigterm_at": 3, "root": str(root / "sigterm")})
    failing = copy.deepcopy(configs["sigterm"])
    failing["runner_config"]["save_latest_every_steps"] = 2
    jobs.append({"kind": "trainer", "name": "fail_writes", "config": failing, "steps": 40,
                 "fail_writes": True, "root": str(root / "fail_writes")})
    return jobs


def _run_world2(root, jobs, worker="_torch_ddp_worker.py"):
    spec = root / "spec.json"
    with open(spec, "w") as f:
        json.dump({"jobs": jobs, "out_dir": str(root)}, f)
    port = str(_free_port())
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, worker), str(spec),
             str(root / f"rank{rank}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    outs = []
    for rank in range(WORLD):
        with open(root / f"rank{rank}.json") as f:
            outs.append(json.load(f))
    return outs, logs


def _parity_inputs(root, jx):
    """The global batch (8 rows), the JAX step over it, and the port's
    weights and inputs written for the workers."""
    rs = np.random.RandomState(21)
    b = WORLD * MB
    x = rs.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    t = rs.randint(0, 1000, (b,)).astype(np.int32)
    noise = rs.randn(b, SIZE, SIZE, 3).astype(np.float32)
    state, loss, grads = jx.step(jx.new_state(), jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(noise))
    path = str(root / "parity_inputs.pt")
    torch.save({"encoder": encoder_state_dict(jx.params["encoder"]),
                "decoder": unet_state_dict(jax_partition.merge_params(jx.frozen,
                                                                      jx.params["shift"])),
                "x": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                "t": torch.from_numpy(t),
                "noise": torch.from_numpy(noise.transpose(0, 3, 1, 2).copy())}, path)
    return path, {"loss": float(loss), "grads": jax.device_get(grads),
                  "params": jax.device_get(state.params)}


# -- one process over the global batch -------------------------------------- #

def _host_global_batches(cfg, keys, steps):
    """Each step's global batch: micro-batch i is the ranks' micro-batches i,
    rank 0's first, from loaders of both ranks (the trainer's seed 0)."""
    ds = build_dataset(cfg["train_dataset_config"])
    iters = int(cfg["runner_config"].get("num_iterations", 1))
    loaders = [Loader(ds, MB * iters, shuffle=True, seed=0, num_workers=1, process_index=r,
                      process_count=WORLD).infinite() for r in range(WORLD)]
    out = []
    for _ in range(steps):
        parts = [next(it) for it in loaders]
        out.append({k: np.concatenate([p[k][i * MB:(i + 1) * MB] for i in range(iters)
                                       for p in parts]) for k in keys})
    return out


def _epoch_global_rows(cfg, steps):
    ds = build_dataset(cfg["train_dataset_config"])
    loader = Loader(ds, MB, shuffle=True, seed=0, num_workers=1, process_count=WORLD)
    rows, epoch = [], 0
    while len(rows) < steps:
        rows.extend(resident.epoch_global_indices(loader, epoch))
        epoch += 1
    return rows


def _control(name, cfg, steps, run):
    """The one-process trainer of job ``name`` over the world-2 run's global
    batches, trained to ``steps``."""
    trainer = pick_trainer(cfg)(config=_batch_size(cfg, WORLD * MB), run_path=str(run),
                                device="cpu")
    if name.startswith("latent_epoch"):
        rows = _epoch_global_rows(cfg, steps)

        def chunks(start, k, max_steps):
            assert k == 1
            for s in range(start, steps):
                yield np.stack([rows[s]])
        trainer._resident_index_chunks = chunks
    elif name == "latent_uniform":
        trainer.train_dataset.augmentation = True
    else:
        keys = trainer._step_batch_keys()
        batches = _host_global_batches(cfg, keys, steps)
        trainer._batch_iterator = lambda start: (batch_to_device(b, "cpu", keys)
                                                 for b in batches[start:])
    losses, inner = [], trainer._chunk_runner

    def runner(*args):
        run_chunk = inner(*args)

        def wrapped(c):
            out, load = run_chunk(c)
            losses.extend(float(next(iter(m.values()))) for m in out)
            return out, load
        return wrapped

    trainer._chunk_runner = runner
    trainer.train(max_steps=steps)
    return trainer, losses


def _state(trainer):
    out = {}
    for g, named in trainer.state.params.items():
        for k, p in named.items():
            opt = trainer.optimizer.state[p]
            out[f"{g}.{k}"] = [t.detach() for t in (p, trainer.state.ema_params[g][k],
                                                    opt["exp_avg"], opt["exp_avg_sq"],
                                                    p.grad)]
    return out


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    build_stage34_artifacts(root)
    configs = _configs(root)
    jx = _Jax()
    inputs, jax_want = _parity_inputs(root, jx)
    outs, logs = _run_world2(root, _jobs(root, configs, inputs))
    dumps = {name: [torch.load(root / f"{name}_rank{r}.pt") for r in range(WORLD)]
             for name in list(STEPS) + ["representation_resume", "sigterm", "parity",
                                        "fail_writes"]}
    controls = {}
    with pytest.MonkeyPatch.context() as mp:
        # the workers' primary writes no TensorBoard either
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        patch_tiny_encoders(mp)
        for name, steps in STEPS.items():
            trainer, losses = _control(name, configs[name], steps, root / "w1" / name)
            if name == "representation":
                trainer.evaluate(steps, ddim_style="ddim10")
            controls[name] = {"losses": losses, "state": _state(trainer),
                              "step": trainer.step, "run": root / "w1" / name}
    yield {"root": root, "outs": outs, "logs": logs, "dumps": dumps, "controls": controls,
           "jax": jax_want}


# -- the live tests ---------------------------------------------------------- #

@pytest.mark.parametrize("name", list(STEPS) + ["representation_resume", "sigterm",
                                                 "fail_writes"])
def test_the_ranks_end_bit_equal(live, name):
    a, b = live["dumps"][name]
    assert a["count"] == b["count"]
    assert a["losses"] == b["losses"]
    assert sorted(a["tensors"]) == sorted(b["tensors"])
    for key, ts in a["tensors"].items():
        for x, y in zip(ts, b["tensors"][key]):
            assert torch.equal(x, y), key


@pytest.mark.parametrize("name", list(STEPS))
def test_world_two_trains_what_one_process_trains(live, name):
    got, want = live["dumps"][name][0], live["controls"][name]
    assert got["count"] == want["step"] == STEPS[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert sorted(got["tensors"]) == sorted(want["state"])
    for key, ts in want["state"].items():
        for i, (x, w) in enumerate(zip(got["tensors"][key], ts)):
            if i in (0, 1):       # params, EMA
                atol = PARAM_ATOL
            else:                 # moments, the last reduced gradient
                atol = SCALED_ATOL * float(w.abs().max()) + 1e-8
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{name} {key} [{i}]")


def test_a_world_two_resume_is_bit_equal(live):
    through, resumed = live["dumps"]["representation"], live["dumps"]["representation_resume"]
    assert [r["representation_resume"]["step"] for r in live["outs"]] == [4, 4]
    assert resumed[0]["losses"] == through[0]["losses"][2:]
    for r in range(WORLD):
        for key, ts in through[r]["tensors"].items():
            for x, y in zip(ts, resumed[r]["tensors"][key]):
                assert torch.equal(x, y), (r, key)


def test_only_the_primary_writes(live):
    r0, r1 = live["outs"]
    assert r0["representation"]["files"] == ["checkpoints/latest.ckpt", "config.yml",
                                             "metrics.jsonl", "samples/sample0k.png"]
    assert r0["manipulation"]["files"] == r0["representation"]["files"]
    for name in list(STEPS) + ["representation_resume", "sigterm"]:
        assert r1[name]["files"] == [], name
        assert "metrics.jsonl" in r0[name]["files"], name
    with open(live["root"] / "representation" / "rank0" / "metrics.jsonl") as f:
        logged = [json.loads(line)["prediction_loss"] for line in f]
    np.testing.assert_allclose(logged, live["dumps"]["representation"][0]["losses"],
                               rtol=1e-6)
    # every rank evaluated; the manipulation eval ran on the primary alone
    assert [r["representation"]["eval_spans"] for r in live["outs"]] == [1, 1]
    assert [r["manipulation"]["eval_spans"] for r in live["outs"]] == [1, 0]


def test_the_eval_grid_equals_one_process(live):
    got = read_png(live["root"] / "representation" / "rank0" / "samples" / "sample0k.png")
    want = read_png(live["controls"]["representation"]["run"] / "samples" / "sample0k.png")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GRID_LEVELS


def test_a_sigterm_to_one_rank_stops_both_at_the_consensus_step(live):
    assert [r["sigterm"]["stopped_at"] for r in live["outs"]] == [4, 4]
    ckpt = live["root"] / "sigterm" / "rank0" / "checkpoints" / "latest.ckpt"
    assert int(load_checkpoint(str(ckpt))["step"]) == 4
    with open(live["root"] / "sigterm" / "rank0" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [2, 4]


def test_a_failed_write_on_the_primary_stops_both_ranks_then_raises(live):
    """Rank 0's write of step 2 fails in its background thread; the save at
    4 finds it, the ranks agree to stop at the next consensus (6), and rank 0
    raises once both have left the loop."""
    r0, r1 = (r["fail_writes"] for r in live["outs"])
    assert r1["stopped_at"] == r1["step"] == 6 and r1["error"] is None
    assert r0["stopped_at"] is None and r0["step"] == 6
    assert "background checkpoint write failed (the run stopped by consensus)" in r0["error"]


def test_two_ranks_match_the_jax_step_over_the_global_batch(live):
    """Reduced gradients and post-step params of the two-rank port against
    JAX's one-process step over the 8 rows (injected t and noise):
    ``tests/test_torch_training.py``'s tolerances."""
    want = live["jax"]
    for r in range(WORLD):
        got = live["dumps"]["parity"][r]
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)

        def grouped(flat):
            out = {"encoder": {}, "shift": {}}
            for key, v in flat.items():
                g, k = key.split(".", 1)
                out[g][k] = v
            return out

        _assert_groups_close(grouped(got["grads"]), want["grads"], atol=1e-4, rtol=1e-3,
                             scaled=True)
        _assert_groups_close(grouped(got["params"]), want["params"], atol=2e-5)
    a, b = live["dumps"]["parity"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


# -- the draws in one process ------------------------------------------------ #

def _recording_loss(gd, kind, seen):
    """A loss that records the t and noise it is given (None where it draws
    them itself, as the real losses do)."""
    def loss_fn(x_b, generator, t, noise):
        seen.append((t, noise))
        if kind == "latent":
            d = x_b.shape[-1]
            return gd.latent_diffusion_train_one_batch(
                generator, lambda z, tt: 0.5 * z, lambda x: x, x_b, torch.zeros(d),
                torch.ones(d), t=t, noise=noise)["prediction_loss"]
        return gd.regular_train_one_batch(generator, lambda x, tt, c: 0.5 * x, x_b,
                                          t=t, noise=noise)["prediction_loss"]
    return loss_fn


def _draw(gd, kind):
    if kind == "latent":
        zero = torch.zeros(8)
        return lambda g, x_b, n: gd.train_draws(g, n, zero.shape, zero, latent=True)
    return lambda g, x_b, n: gd.train_draws(g, n, x_b.shape[1:], x_b)


def _seeded():
    return torch.Generator().manual_seed(1234)


@pytest.mark.parametrize("kind", ["image", "latent"])
def test_world_one_draws_are_the_losses_own(kind):
    """At rows (0, 1) each micro-batch gets the t and noise the loss drew for
    itself before (replayed here as the loss draws them), in the same order,
    and the loss and gradient are the same bits."""
    from pdae_torch.diffusion.gaussian import _randint, _randn
    gd = GaussianDiffusion({"timesteps": 20, "betas_type": "linear"})
    x = torch.randn(8, 8) if kind == "latent" else torch.randn(8, 1, 4, 4)
    w = torch.ones((), requires_grad=True)
    for iters in (1, 2):
        own, cut = [], []
        before = accumulate_grads(
            lambda *a: w * _recording_loss(gd, kind, own)(*a), [w], x, _seeded(), iters)
        after = accumulate_grads(
            lambda *a: w * _recording_loss(gd, kind, cut)(*a), [w], x, _seeded(), iters,
            draw=_draw(gd, kind), rows=(0, 1))
        assert torch.equal(before[0], after[0]) and torch.equal(before[1][0], after[1][0])
        assert len(own) == len(cut) == iters
        assert all(t is None and n is None for t, n in own)
        g = _seeded()
        for t, noise in cut:
            high = gd.latent_timesteps if kind == "latent" else gd.timesteps
            want_t = _randint(g, high, t.shape[0], x.device)
            want_noise = _randn(g, noise.shape, x)
            assert torch.equal(t, want_t) and torch.equal(noise, want_noise)


@pytest.mark.parametrize("kind", ["image", "latent"])
def test_the_ranks_cuts_concatenate_to_the_global_draw(kind):
    gd = GaussianDiffusion({"timesteps": 20, "betas_type": "linear"})
    shape = (8,) if kind == "latent" else (1, 4, 4)
    x = torch.randn((WORLD * 4,) + shape)
    w = torch.ones((), requires_grad=True)
    iters = 2
    whole = []
    accumulate_grads(lambda *a: w * _recording_loss(gd, kind, whole)(*a), [w], x,
                     _seeded(), iters, draw=_draw(gd, kind), rows=(0, 1))
    ranks = []
    for r in range(WORLD):
        seen = []
        local = torch.cat([x[i * 4 + r * 2:i * 4 + (r + 1) * 2] for i in range(iters)])
        accumulate_grads(lambda *a: w * _recording_loss(gd, kind, seen)(*a), [w], local,
                         _seeded(), iters, draw=_draw(gd, kind), rows=(r, WORLD))
        ranks.append(seen)
    for i in range(iters):
        for j in (0, 1):
            assert torch.equal(torch.cat([ranks[r][i][j] for r in range(WORLD)]),
                               whole[i][j])


def test_resident_draws_world_one_and_the_ranks_cuts():
    data = {"x_0": torch.arange(10 * 2 * 2 * 2, dtype=torch.float32).reshape(10, 2, 2, 2)}

    def gen():
        return torch.Generator().manual_seed(99)

    got = resident.sample_batch(data, gen(), 4, 10, flip=True)
    g = gen()
    idx = torch.randint(0, 10, (4,), generator=g)
    coin = torch.rand(4, generator=g) < 0.5
    x = data["x_0"].index_select(0, idx)
    assert torch.equal(got["x_0"], torch.where(coin[:, None, None, None], x.flip(3), x))
    whole = resident.sample_batch(data, gen(), 4, 10, flip=True)
    cuts = [resident.sample_batch(data, gen(), 2, 10, flip=True, rows=(r, 2))
            for r in range(2)]
    assert torch.equal(torch.cat([c["x_0"] for c in cuts]), whole["x_0"])
    # epoch mode: the indices are the rank's already, the coins its cut
    idx = torch.tensor([3, 1, 4, 1])
    whole = resident.sample_batch(data, gen(), 4, 10, flip=True, indices=idx)
    cuts = [resident.sample_batch(data, gen(), 2, 10, flip=True, indices=idx[2 * r:2 * r + 2],
                                  rows=(r, 2)) for r in range(2)]
    assert torch.equal(torch.cat([c["x_0"] for c in cuts]), whole["x_0"])


# -- refusals ----------------------------------------------------------------- #

def test_a_gloo_group_never_captures_a_chunk(tmp_path, monkeypatch):
    from pdae_torch.training import RegularDiffusionTrainer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _configs(tmp_path)["regular"]
    cfg["runner_config"].update(steps_per_dispatch=2, display_steps=2)
    tr = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / "run"), device="cpu")
    monkeypatch.setattr(type(tr), "_replays", lambda self, k: k > 1)
    monkeypatch.setattr(parallel, "tensor_backend", lambda: "gloo")
    with pytest.raises(ValueError, match="NCCL tensor group: a gloo all-reduce cannot be "
                                         "captured"):
        tr.train(max_steps=4)
    assert tr.step == 0


def test_a_torchrun_world_must_join_the_group_first(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="has not joined the process group"):
        pick_trainer(_configs(tmp_path)["regular"])(
            config=_configs(tmp_path)["regular"], run_path=str(tmp_path / "run"), device="cpu")
    assert not os.path.exists(tmp_path / "run")


def test_the_tensor_backend_is_named_never_guessed_from_a_failure(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert parallel.default_backend() == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.default_backend() == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert parallel.default_backend() == "gloo"
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        parallel.init_distributed(backend="mpi")
    assert parallel.tensor_backend() is None
    # one process issues no collective: no reducer without a group
    assert parallel.mean_all_reducer(10, "cpu") is None
