"""Tensor parallelism in the port (``param_sharding: tp`` and ``fsdp+tp``,
``PDAEService``'s ``tp_size``, ``serve --tp-size``), live on the CPU: gloo
ranks (``tests/_torch_tp_worker.py``, started with torchrun's environment)
at tiny geometries, one thread each.

Held here:

* the rules: ``parallel.tp_dim`` and ``parallel.fsdp_tp_dims`` equal the
  specs of ``pdae_tpu``'s ``tp_sharding`` and ``fsdp_tp_sharding`` on a grid
  of shapes, model sizes, data sizes and minimum sizes;
* the forwards at tp 2 (world 2) on the same seeded weights as ``pdae_tpu``'s
  modules, carried across by the export maps: the UNet, the ShiftUNet (its
  heads split, and with ``num_heads=1``, where the attention is gathered),
  the encoder and MLPSkipNet, at batch 3 and 1, within 2e-5, every rank
  holding its blocks;
* one representation step with given t and noise at tp 2 (world 2) and under
  ``fsdp+tp`` (tp 2 x data 2, world 4) against ``pdae_tpu``'s step over the
  same 8 rows (loss rtol 1e-5; each gradient within 1e-4 times the largest
  |gradient| of that tensor plus 1e-8, params within 2e-5: the tolerances of
  ``tests/test_torch_fsdp.py``'s parity) and against the port's one-process
  step within the same;
* the four trainers, 3 steps (4 for the representation trainer) under
  ``tp`` at world 2 and under ``fsdp+tp`` at world 4, against one process
  over the same global batch (``tests/test_torch_ddp.py``'s tolerances:
  losses rtol 1e-5; params and EMA 1e-6; moments 1e-4 times their largest
  |value| plus 1e-8), the ranks of a model group ending bit-equal; every
  tp-sharded parameter, EMA and moment held at its block's shape; a resume
  at step 2 from the ``full`` file and from the ``sharded`` directory
  bit-equal to the run without it; ``pdae_tpu``'s ``load_checkpoint``
  reading both formats to the same tree; the port resuming ``pdae_tpu``'s
  own tp-sharded directory;
* ``PDAEService(tp_size=2)`` on a batch of 1 and of 3 (and ``generate``,
  ``decode`` and ``manipulate``) against one process; the serve CLI under two
  processes answering an HTTP request.
"""

import base64
import copy
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TRAINER_DPM, init_flax, nchw, patch_tiny_encoders
from pdae_torch import parallel
from pdae_torch.data.pipeline import batch_to_device
from pdae_torch.diffusion import GaussianDiffusion
from pdae_torch.models import MLPSkipNet, SemanticEncoder, ShiftUNet, UNet
from pdae_torch.serving import PDAEService
from pdae_torch.train import pick_trainer
from pdae_torch.training import (TrainState, make_optimizer, make_representation_train_step,
                                 trainable_params)
from pdae_torch.training.state import flat_params
from pdae_torch.utils import (encoder_state_dict, encoder_tree, load_checkpoint,
                              mlp_skip_net_state_dict, save_checkpoint, save_yaml,
                              unet_state_dict, unet_tree)
from pdae_tpu.models import MLPSkipNet as JaxMLPSkipNet
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.parallel import fsdp_tp_sharding, make_tp_mesh, shard_tree_tp, tp_sharding
from pdae_tpu.utils import load_checkpoint as jax_load_checkpoint
from pdae_tpu.utils import save_sharded_checkpoint as jax_save_sharded
from test_stage34_sharded import build_stage34_artifacts
from test_torch_ddp import (LOSS_RTOL, MB, PARAM_ATOL, SCALED_ATOL, _configs, _control,
                            _free_port, _parity_inputs, _state)
from test_torch_serving import LATENT as SERVE_LATENT
from test_torch_serving import SMALL_CONFIG, _images, _small_artifacts
from test_torch_training import (DIFFUSION, EMA_DECAY, LATENT, OPT, SIZE, TINY_DPM, _Jax,
                                 _assert_groups_close)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
MIN_SIZE, MANIP_MIN_SIZE = 256, 64
FWD_ATOL = 2e-5
STEPS = {"representation": 4, "regular": 3, "latent_epoch": 3, "manipulation": 3}


# -- the rules ------------------------------------------------------------------ #

def _spec_dims(sharding):
    spec = tuple(sharding.spec)
    out = {}
    for i, s in enumerate(spec):
        if s is not None:
            out[s] = i
    return out


SHAPES = [(3, 3, 64, 64), (64, 64), (33, 35), (255,), (256,), (3, 3, 8, 3), (16, 30),
          (2, 2, 3, 5), (1, 1, 3, 256), (3, 86), (512, 40), (8,), (6, 4), (3, 3, 3, 3), ()]


@pytest.mark.parametrize("min_size", [1, 256, 2 ** 15])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tp_dim_equals_pdae_tpus_tp_sharding(shape, tp, min_size):
    mesh = make_tp_mesh(tp, devices=jax.devices()[:4])
    want = _spec_dims(tp_sharding(mesh, shape, min_size=min_size)).get("model")
    if len(shape) >= 1 and want is not None:
        want %= len(shape)
    assert parallel.tp_dim(shape, tp, min_size) == want


@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (2, 1), (4, 1), (1, 4), (2, 4)], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fsdp_tp_dims_equal_pdae_tpus_fsdp_tp_sharding(shape, grid):
    dp, tp = grid
    mesh = make_tp_mesh(tp, devices=jax.devices()[:dp * tp])
    for min_size in (1, 256):
        dims = _spec_dims(fsdp_tp_sharding(mesh, shape, min_size=min_size))
        want = (dims.get("model"), dims.get("data"))
        assert parallel.fsdp_tp_dims(shape, dp, tp, min_size) == want, min_size


def test_a_tp_size_that_does_not_divide_the_world_is_refused():
    with pytest.raises(ValueError, match="model_size=3 must divide the device count 4"):
        parallel.tp_coords(0, 4, 3)
    assert [parallel.tp_coords(r, 4, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                               (1, 1)]


# -- the live runs ---------------------------------------------------------------- #

def _start(root, jobs, world, tag, worker="_torch_tp_worker.py"):
    """Start ``world`` worker processes (of ``worker``) on ``jobs``;
    ``_finish`` waits."""
    spec = root / f"spec_{tag}.json"
    with open(spec, "w") as f:
        json.dump({"jobs": jobs, "out_dir": str(root)}, f)
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, worker), str(spec),
             str(root / f"{tag}_rank{rank}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return root, tag, procs


def _finish(started):
    root, tag, procs = started
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{tag} rank {rank} failed:\n{log[-6000:]}"
    outs = []
    for rank in range(len(procs)):
        with open(root / f"{tag}_rank{rank}.json") as f:
            outs.append(json.load(f))
    return outs


def _tp(cfg, mode="tp", min_size=MIN_SIZE, **extra):
    cfg = copy.deepcopy(cfg)
    cfg["runner_config"].update(param_sharding=mode, tp_size=2, fsdp_min_size=min_size,
                                **extra)
    return cfg


FWD_DPM = dict(TINY_DPM, base_channel=16)


def _forward_cases(root):
    """The models and inputs of the forward job (each model initialised in
    ``pdae_tpu`` and carried across by the export maps, run at batch 3 and
    at batch 1), and ``want()``, which gives ``pdae_tpu``'s outputs: its
    batch-3 forward, whose first row is the batch-1 expectation (every op
    of these models works per sample)."""
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    t = rs.randint(0, 1000, (3,)).astype(np.int32)
    z = rs.randn(3, LATENT).astype(np.float32)
    mlp = dict(input_channel=LATENT, model_channel=32, num_layers=3, time_emb_channel=8)
    enc = {"latent_dim": LATENT, "channels": [16, 32], "attn_after_stage": 2,
           "image_size": SIZE}
    models = {  # name: (JAX module, its inputs, port kind, port kwargs, to state dict)
        "unet": (JaxUNet(**FWD_DPM), (x, t), "unet", FWD_DPM, unet_state_dict),
        "shift": (JaxShiftUNet(latent_dim=LATENT, **FWD_DPM), (x, t, z), "shift",
                  dict(FWD_DPM, latent_dim=LATENT), unet_state_dict),
        "shift_heads1": (JaxShiftUNet(latent_dim=LATENT, **dict(FWD_DPM, num_heads=1)),
                         (x, t, z), "shift", dict(FWD_DPM, num_heads=1, latent_dim=LATENT),
                         unet_state_dict),
        "encoder": (JaxSemanticEncoder(LATENT, channels=(16, 32), attn_after_stage=2), (x,),
                    "encoder", enc, encoder_state_dict),
        "mlp": (JaxMLPSkipNet(**mlp), (z, t), "mlp", mlp, mlp_skip_net_state_dict)}
    cases, data, inits = [], {}, {}
    for seed, (name, (jm, args, kind, kwargs, to_sd)) in enumerate(models.items()):
        params = init_flax(jm, *[jnp.asarray(a[:1]) for a in args], seed=7 + seed)
        inits[name] = params
        for b in (3, 1):
            port_args = [nchw(a[:b]) if a.ndim == 4 else torch.from_numpy(a[:b])
                         for a in args]
            port_args = [a.long() if a.dtype == torch.int32 else a for a in port_args]
            data[f"{name}_b{b}"] = {"state": to_sd(params), "args": port_args}
            cases.append({"name": f"{name}_b{b}", "model": kind, "kwargs": kwargs})
    data["dropout"] = data["unet_b3"]      # the same weights, dropout 0.5 in the worker
    path = str(root / "forward_inputs.pt")
    torch.save(data, path)

    def want():
        out = {}
        for name, (jm, args, *_) in models.items():
            y = jax.jit(jm.apply)({"params": inits[name]}, *[jnp.asarray(a) for a in args])
            ys = [np.asarray(o) for o in (y if isinstance(y, tuple) else (y,))]
            ys = [o.transpose(0, 3, 1, 2) if o.ndim == 4 else o for o in ys]
            out[f"{name}_b3"], out[f"{name}_b1"] = ys, [o[:1] for o in ys]
        return out
    return {"kind": "forward", "name": "forward", "inputs": path, "cases": cases, "tp": 2,
            "min_size": 64, "dropout_dpm": FWD_DPM}, want


def _service_job(root):
    enc, dec, artifacts = _small_artifacts()
    config = dict(SMALL_CONFIG, tp_size=2, tp_min_size=MIN_SIZE)
    rs = np.random.RandomState(4)
    calls = {"encode_b3": ("encode", (_images(3, seed=1),), {}),
             "autoencode_b1": ("autoencode", (_images(1, seed=2),), {}),
             "autoencode_b3": ("autoencode", (_images(3, seed=3),), {}),
             "decode_b3": ("decode", (rs.randn(3, SERVE_LATENT).astype(np.float32),
                                      rs.randn(3, 64, 64, 3).astype(np.float32)), {}),
             "generate_b3": ("generate", (3,), {"seed": 5}),
             "manipulate_b1": ("manipulate", (_images(1, seed=6),), {"class_id": 2})}
    path = str(root / "service_inputs.pt")
    torch.save({"config": config, "encoder": enc, "decoder": dec,
                "latent": artifacts["latent_state"], "stats": artifacts["latent_stats"],
                "classifier": artifacts["classifier_state"], "calls": calls}, path)
    one = PDAEService(SMALL_CONFIG, enc, dec, device="cpu", **artifacts)
    want = {name: getattr(one, op)(*args, **kwargs) for name, (op, args, kwargs)
            in calls.items()}
    return {"kind": "service", "name": "service", "inputs": path}, want


def _trainer_jobs(root, configs, mode, world):
    jobs = []
    for name, steps in STEPS.items():
        min_size = MANIP_MIN_SIZE if name == "manipulation" else MIN_SIZE
        cfg = _tp(configs[name], mode, min_size)
        job = {"kind": "trainer", "name": f"{name}_{mode}", "config": cfg, "steps": steps,
               "root": str(root / f"{name}_{mode}")}
        if name == "representation":
            cfg["runner_config"]["save_latest_every_steps"] = 2
            job.update(copy_at=2, copy_to=str(root / f"rep_{mode}_step2.ckpt"),
                       eval={"ddim_style": "ddim10"} if mode == "tp" else None)
        jobs.append(job)
    sharded = _tp(configs["representation"], mode, checkpoint_format="sharded",
                  save_latest_every_steps=2)
    jobs.append({"kind": "trainer", "name": f"rep_sharded_{mode}", "config": sharded,
                 "steps": 4, "root": str(root / f"rep_sharded_{mode}"), "copy_at": 2,
                 "copy_to": str(root / f"rep_{mode}_step2.sharded")})
    for fmt in ("ckpt", "sharded"):
        jobs.append({"kind": "trainer", "name": f"rep_resume_{fmt}_{mode}",
                     "config": sharded if fmt == "sharded" else _tp(
                         configs["representation"], mode, save_latest_every_steps=2),
                     "steps": 4, "root": str(root / f"rep_resume_{fmt}_{mode}"),
                     "resume": str(root / f"rep_{mode}_step2.{fmt}")})
    return jobs


def _parity_job(inputs, world, fsdp):
    return {"kind": "parity", "name": f"parity_w{world}", "inputs": inputs, "latent": LATENT,
            "size": SIZE, "dpm": TINY_DPM, "optimizer": OPT, "diffusion": DIFFUSION,
            "ema_decay": EMA_DECAY, "min_size": MIN_SIZE, "tp": 2, "fsdp": fsdp}


def _one_process_step(inputs):
    """The port's representation step in one process over the 8 rows."""
    data = torch.load(inputs)
    encoder = SemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2, image_size=SIZE)
    decoder = ShiftUNet(latent_dim=LATENT, **TINY_DPM)
    encoder.load_state_dict(data["encoder"], strict=True)
    decoder.load_state_dict(data["decoder"], strict=True)
    params = trainable_params(encoder, decoder)
    optimizer = make_optimizer(OPT, flat_params(params))
    ts = TrainState.create(params, optimizer)
    step = make_representation_train_step(GaussianDiffusion(DIFFUSION), encoder, decoder,
                                          optimizer, ema_decay=EMA_DECAY, device="cpu")
    loss = step(ts, data["x"], t=data["t"], noise=data["noise"])
    return {"loss": float(loss),
            "grads": {f"{g}.{k}": p.grad for g, n in ts.params.items() for k, p in n.items()},
            "params": {f"{g}.{k}": p.detach() for g, n in ts.params.items()
                       for k, p in n.items()}}


def _jax_tp_directory(root, path):
    """``pdae_tpu``'s own tp-sharded directory of the world-2 run's step-2
    file: the tree laid out by ``shard_tree_tp`` on a 2-device tp mesh and
    written by ``save_sharded_checkpoint``."""
    tree = jax_load_checkpoint(path)
    mesh = make_tp_mesh(2, devices=jax.devices()[:2])
    out = str(root / "jax_tp.sharded")
    jax_save_sharded(out, shard_tree_tp(mesh, tree, min_size=MIN_SIZE))
    return out, tree


def _controls(root, configs, dp):
    """One process per trainer over the global batch of ``dp`` data ranks."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        patch_tiny_encoders(mp)
        for name, steps in STEPS.items():
            run = root / f"w1_dp{dp}" / name
            if dp == 1:
                cfg = configs[name]
                trainer = pick_trainer(cfg)(config=cfg, run_path=str(run), device="cpu")
                losses, inner = [], trainer._chunk_runner

                def runner(*args, inner=inner, losses=losses):
                    run_chunk = inner(*args)

                    def wrapped(c):
                        res, load = run_chunk(c)
                        losses.extend(float(next(iter(m.values()))) for m in res)
                        return res, load
                    return wrapped
                trainer._chunk_runner = runner
                trainer.train(max_steps=steps)
            else:
                trainer, losses = _control(name, configs[name], steps, run)
            out[name] = {"losses": losses, "state": _state(trainer), "step": trainer.step}
    return out


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    build_stage34_artifacts(root)
    configs = _configs(root)
    for cfg in configs.values():
        cfg["dataloader_config"]["eval"]["num_generations"] = 2
    jx = _Jax()
    inputs, jax_want = _parity_inputs(root, jx)
    forward, forward_want = _forward_cases(root)
    service, service_want = _service_job(root)
    jobs2 = [forward, _parity_job(inputs, 2, False), service] + _trainer_jobs(
        root, configs, "tp", 2)
    jobs4 = [_parity_job(inputs, 4, True)] + _trainer_jobs(root, configs, "fsdp+tp", 4)
    # the one-process references are computed while the ranks run
    t0 = time.perf_counter()
    started = _start(root, jobs2, 2, "w2")
    controls = {"tp": _controls(root, configs, 1)}
    forward_want = forward_want()
    outs = {"tp": _finish(started)}
    started = _start(root, jobs4, 4, "w4")
    controls["fsdp+tp"] = _controls(root, configs, 2)
    one = _one_process_step(inputs)
    outs["fsdp+tp"] = _finish(started)
    seconds = time.perf_counter() - t0

    def dumps(name, world):
        return [torch.load(root / f"{name}_rank{r}.pt", weights_only=False)
                for r in range(world)]
    jax_dir, jax_tree = _jax_tp_directory(root, str(root / "rep_tp_step2.ckpt"))
    yield {"root": root, "outs": outs, "dumps": dumps, "jax": jax_want,
           "forward_want": forward_want, "service_want": service_want,
           "controls": controls, "one": one, "seconds": seconds,
           "configs": configs, "jax_dir": jax_dir, "jax_tree": jax_tree}


# -- the forwards -------------------------------------------------------------------- #

FORWARD_CASES = [f"{m}_b{b}" for b in (3, 1) for m in ("unet", "shift", "shift_heads1",
                                                        "encoder", "mlp")]


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_the_tp_forward_matches_pdae_tpus_module(live, case):
    got = live["dumps"]("forward", 2)
    for r in range(2):
        out = got[r]["out"][case]
        outs = out if isinstance(out, tuple) else (out,)
        for o, w in zip(outs, live["forward_want"][case]):
            np.testing.assert_allclose(o.numpy(), w, rtol=0, atol=FWD_ATOL, err_msg=case)
        held = got[r]["held"][case]
        assert held and all(b[0] * 2 == w[0] or b[1] * 2 == w[1] or b != w
                            for b, w in held)
        assert all(np.prod(b) * 2 == np.prod(w) for b, w in held), case


def test_the_ranks_of_a_model_group_draw_one_dropout_mask(live):
    """Dropout above 0 on a channel block: both ranks give the same whole
    output (their masks are slices of one), and the mask acts."""
    a, b = (d["out"] for d in live["dumps"]("forward", 2))
    assert torch.equal(a["dropout_train"], b["dropout_train"])
    assert torch.equal(a["dropout_eval"], b["dropout_eval"])
    assert not torch.equal(a["dropout_train"], a["dropout_eval"])


# -- one step ------------------------------------------------------------------------ #

def _grouped(flat):
    out = {"encoder": {}, "shift": {}}
    for key, v in flat.items():
        g, k = key.split(".", 1)
        out[g][k] = v
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_one_tp_step_matches_the_jax_step_and_one_process(live, world):
    want, one = live["jax"], live["one"]
    got_all = live["dumps"](f"parity_w{world}", world)
    for got in got_all:
        assert got["sharded"] > 0
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        _assert_groups_close(_grouped(got["grads"]), want["grads"], atol=1e-4, rtol=1e-3,
                             scaled=True)
        _assert_groups_close(_grouped(got["params"]), want["params"], atol=2e-5)
        np.testing.assert_allclose(float(got["loss"]), one["loss"], rtol=1e-5)
        for key, g in one["grads"].items():
            atol = 1e-4 * float(g.abs().max()) + 1e-8
            np.testing.assert_allclose(got["grads"][key].numpy(), g.numpy(), rtol=1e-3,
                                       atol=atol, err_msg=key)
            np.testing.assert_allclose(got["params"][key].numpy(),
                                       one["params"][key].numpy(), rtol=0, atol=2e-5,
                                       err_msg=key)
    for got in got_all[1:]:
        assert all(torch.equal(got["params"][k], got_all[0]["params"][k])
                   for k in got["params"])


# -- the trainers --------------------------------------------------------------------- #

MODES = {"tp": 2, "fsdp+tp": 4}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(STEPS))
def test_tp_trains_what_one_process_trains(live, name, mode):
    world = MODES[mode]
    dumps = live["dumps"](f"{name}_{mode}", world)
    want = live["controls"][mode][name]
    for got in dumps:
        assert got["count"] == want["step"] == STEPS[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for key, ts in want["state"].items():
            for i, (x, w) in enumerate(zip(got["tensors"][key], ts[:4])):
                atol = PARAM_ATOL if i < 2 else SCALED_ATOL * float(w.abs().max()) + 1e-8
                np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=atol,
                                           err_msg=f"{name} {key} [{i}]")
    # the ranks of a model group end bit-equal, and so does every rank here
    for got in dumps[1:]:
        assert got["losses"] == dumps[0]["losses"]
        for key, ts in got["tensors"].items():
            assert all(torch.equal(x, y) for x, y in zip(ts, dumps[0]["tensors"][key])), key


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(STEPS))
def test_each_rank_holds_its_blocks_and_gathers_no_parameter(live, name, mode):
    """Every tp-sharded parameter is held at its block's shape, its EMA and
    moments at the master's (the block, or under ``fsdp+tp`` its data
    block); nothing of a block's size is whole."""
    for out in live["outs"][mode]:
        held = out[f"{name}_{mode}"]["held"]
        blocks = [h for h in held if h["role"] == "block"]
        assert blocks, name
        for h in blocks:
            assert h["param"] != h["whole"]
            assert int(np.prod(h["param"])) * 2 == int(np.prod(h["whole"]))
            n = int(np.prod(h["ema"]))
            assert n in (int(np.prod(h["param"])), int(np.prod(h["param"])) // 2)
            if mode == "tp":
                assert h["ema"] == h["param"]
            assert [int(np.prod(m)) for m in h["moments"]] == [n, n]
        if mode == "fsdp+tp" and name != "manipulation":
            # the classifier's one leaf [16, 5] is split on its 16 by tp; its
            # 5 does not divide the data axis, so it stays whole there
            assert any(int(np.prod(h["ema"])) * 2 == int(np.prod(h["param"])) for h in held)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fmt", ["ckpt", "sharded"])
def test_a_resume_at_step_two_is_bit_equal(live, mode, fmt):
    world = MODES[mode]
    through = live["dumps"](f"rep_sharded_{mode}" if fmt == "sharded"
                            else f"representation_{mode}", world)
    resumed = live["dumps"](f"rep_resume_{fmt}_{mode}", world)
    for r in range(world):
        assert resumed[r]["losses"] == through[r]["losses"][2:]
        for key, ts in through[r]["tensors"].items():
            for x, y in zip(ts, resumed[r]["tensors"][key]):
                assert torch.equal(x, y), (r, key)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("mode", list(MODES))
def test_pdae_tpu_reads_both_formats_to_the_same_tree(live, mode):
    root = live["root"]
    full = jax_load_checkpoint(str(root / f"rep_{mode}_step2.ckpt"))
    sharded = jax_load_checkpoint(str(root / f"rep_{mode}_step2.sharded"))
    _same(jax.device_get(sharded), jax.device_get(full))
    files = sorted(os.listdir(root / f"rep_{mode}_step2.sharded"))
    world = MODES[mode]
    assert files == ["manifest.msgpack"] + [
        f"shard-2-{r:05d}-of-{world:05d}.msgpack" for r in range(world)]


def test_the_port_resumes_pdae_tpus_tp_directory(live, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    patch_tiny_encoders(monkeypatch)
    cfg = live["configs"]["representation"]
    _same(load_checkpoint(live["jax_dir"]), jax.device_get(live["jax_tree"]))
    a = pick_trainer(cfg)(config=cfg, run_path=str(tmp_path / "a"), resume=live["jax_dir"],
                          device="cpu")
    b = pick_trainer(cfg)(config=cfg, run_path=str(tmp_path / "b"),
                          resume=str(live["root"] / "rep_tp_step2.ckpt"), device="cpu")
    assert a.step == b.step == 2
    _same(a.state_dict(), b.state_dict())
    # ckpt_tool to-full reads the port's own tp directory and JAX's
    from pdae_torch import ckpt_tool
    for name, src in (("port", live["root"] / "rep_tp_step2.sharded"),
                      ("jax", live["jax_dir"])):
        ckpt_tool.main(["to-full", str(src), str(tmp_path / f"{name}.ckpt")])
        _same(load_checkpoint(str(tmp_path / f"{name}.ckpt")),
              jax.device_get(live["jax_tree"]))


def test_the_tp_eval_grid_is_written_once(live):
    files = live["outs"]["tp"][0]["representation_tp"]["files"]
    assert "samples/sample0k.png" in files and "config.yml" in files


# -- the service --------------------------------------------------------------------- #

@pytest.mark.parametrize("call", ["encode_b3", "autoencode_b1", "autoencode_b3", "decode_b3",
                                  "generate_b3", "manipulate_b1"])
def test_the_tp_service_answers_as_one_process(live, call):
    want = live["service_want"][call]
    got = live["dumps"]("service", 2)
    for r in range(2):
        out = got[r]["out"][call]
        assert out.shape == want.shape
        if out.dtype == np.uint8:
            assert np.abs(out.astype(int) - want.astype(int)).max() <= 1, call
        else:
            np.testing.assert_allclose(out, want, rtol=0, atol=FWD_ATOL)
        assert got[r]["held"]


# -- the serve CLI --------------------------------------------------------------------- #

def _serve_files(root):
    """A PDAE run config and EMA checkpoint the serve CLI builds its service
    from (the shipped 64px encoder over ``SMALL_CONFIG``'s ShiftUNet, seeded
    weights), and a sampler config naming them."""
    enc, dec, _ = _small_artifacts()
    run = {"train_dataset_config": {"name": "SYNTHETIC", "image_size": 64,
                                    "image_channel": 3},
           "eval_dataset_config": {}, "diffusion_config": DIFFUSION,
           "trained_ddpm_config": {"denoise_fn_config": dict(SMALL_CONFIG[
               "trained_ddpm_config"], model="UNet")},
           "encoder_config": SMALL_CONFIG["encoder_config"],
           "decoder_config": {"model": "ShiftUNet", "latent_dim": SERVE_LATENT}}
    save_yaml(run, str(root / "pdae.yml"))
    save_checkpoint(str(root / "pdae.ckpt"), {"step": np.asarray(1, np.int32),
                                              "ema_encoder": encoder_tree(enc),
                                              "ema_decoder": unet_tree(dec)})
    return {"config_path": str(root / "pdae.yml"), "checkpoint_path": str(root / "pdae.ckpt"),
            "max_batch": 4, "encoder_ddim_style": "ddim2", "decoder_ddim_style": "ddim2"}


def test_serve_tp_size_two_answers_a_request(tmp_path):
    config = _serve_files(tmp_path)
    port = _free_port()
    http = _free_port()
    cfg = tmp_path / "serve.yml"
    cfg.write_text(json.dumps({**config, "tp_min_size": MIN_SIZE}))
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pdae_torch.serve", "--config", str(cfg), "--port",
             str(http), "--device", "cpu", "--tp-size", "2", "--coalesce-ms", "0"],
            cwd=os.path.dirname(HERE), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        url = f"http://127.0.0.1:{http}"
        for _ in range(600):
            try:
                urllib.request.urlopen(url + "/healthz", timeout=1)
                break
            except OSError:
                assert procs[0].poll() is None, procs[0].communicate()[0][-4000:]
                time.sleep(0.2)
        from pdae_torch.utils.image import png_bytes
        img = np.random.RandomState(0).randint(0, 256, (64, 64, 3), np.uint8)
        body = json.dumps({"images": [base64.b64encode(png_bytes(img)).decode()],
                           "encode_style": "ddim2", "decode_style": "ddim2"}).encode()
        req = urllib.request.Request(url + "/autoencode", data=body,
                                     headers={"Content-Type": "application/json"})
        reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
        assert len(reply["images"]) == 1
        from PIL import Image
        got = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["images"][0]))))
        assert got.shape == (64, 64, 3)
        procs[0].send_signal(signal.SIGINT)
        logs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[1].returncode == 0, logs[1][-4000:]
    assert "following" in logs[1]
    # the one-process service gives the same image within one uint8 level
    one = PDAEService.from_config(config, device="cpu")
    want = one.autoencode(img[None], encode_style="ddim2", decode_style="ddim2")[0]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
