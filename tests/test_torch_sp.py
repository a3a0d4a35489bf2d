"""Spatial parallelism in the port (``param_sharding: sp`` and ``fsdp+sp``,
``PDAEService``'s ``sp_size``, ``serve --sp-size``), live on the CPU: gloo
ranks (``tests/_torch_sp_worker.py``, started with torchrun's environment)
at tiny geometries, one thread each.

Held here:

* the grid: ``parallel.sp_coords`` equals ``make_sp_mesh``'s, and a size
  that does not divide the world raises ``pdae_tpu``'s ``ValueError``;
* the plain versions of the four split passes (the GN stats and apply
  passes, the backward's moments and dx passes: each run on row blocks whose
  sums are added, as the ranks add them) against ``pdae_tpu``'s closed-form
  ``_fwd`` and ``_bwd``, and the ``Tq != Tk`` attention and its backward
  against ``pdae_tpu``'s, fp32 rtol 1e-4 / atol 1e-5;
* the forwards at sp 2 (world 2) of the UNet, the ShiftUNet and the encoder
  at batch 4 and 1 on the same seeded weights as ``pdae_tpu``'s modules
  (carried across by the export maps), against ``pdae_tpu``'s forward under
  ``make_sp_mesh(2)`` (on the 8 CPU devices at batch 4), and a batch of 1
  at sp 4 (world 4) whose deepest level (2 rows) does not divide and stays
  whole, against ``pdae_tpu``'s forward under ``make_sp_mesh(4)``, all at
  fp32 rtol 1e-4 / atol 1e-5;
* one representation step with given t and noise at ``sp`` 2 (world 2),
  at ``fsdp+sp`` (sp 2 x data 2, world 4) and at sp 3 (world 3, where no
  map of the 16px models splits, so the gradients are whole on every rank;
  against ``pdae_tpu``'s step under ``make_sp_mesh(3)``) against
  ``pdae_tpu``'s step over the same 8 rows: loss rtol 1e-4, each gradient within 1e-5 times that
  tensor's largest |gradient| plus 1e-8 (rtol 1e-4), params atol 1e-5;
* the four trainers under ``sp`` (world 2) and ``fsdp+sp`` (world 4), and
  the representation trainer at sp 3 (world 3),
  against the port's ``replicated`` run over the same global batch
  (``tests/test_torch_ddp.py``'s tolerances), the ranks of an sp group
  bit-equal, parameters whole on every rank; a resume at step 2 from the
  ``full`` file and from the ``sharded`` directory bit-equal to the run
  without it; the validation errors;
* ``PDAEService(sp_size=2)`` on a batch of 1 and of 3 (and ``generate``,
  ``decode`` and ``manipulate``) against one process; the serve CLI under two
  processes answering an HTTP request.
"""

import base64
import copy
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_parity import init_flax, nchw, patch_tiny_encoders
from pdae_torch import ops, parallel
from pdae_torch.ops import attention as port_attention
from pdae_torch.ops.groupnorm_train import unfold_grads
from pdae_torch.serving import PDAEService
from pdae_torch.train import pick_trainer
from pdae_torch.utils import encoder_state_dict, unet_state_dict
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.ops import attention as jax_attention
from pdae_tpu.ops import groupnorm_train as jax_gn
from pdae_tpu.parallel import make_sp_mesh, replicated
from test_stage34_sharded import build_stage34_artifacts
from test_torch_ddp import (LOSS_RTOL, PARAM_ATOL, SCALED_ATOL, _configs, _free_port,
                            _parity_inputs)
from test_torch_serving import LATENT as SERVE_LATENT
from test_torch_serving import SMALL_CONFIG, _images, _small_artifacts
from test_torch_tp import STEPS, _controls, _finish, _serve_files, _start
from test_torch_training import (DIFFUSION, EMA_DECAY, LATENT, OPT, SIZE, TINY_DPM, _Jax,
                                 _assert_groups_close)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-5
MODES = {"sp": 2, "fsdp+sp": 4}
MIN_SIZE = 256
# a UNet whose deepest map (2 rows at 8px) does not divide over 4 ranks
DEEP_DPM = dict(TINY_DPM, base_channel=16, channel_multiplier=(1, 2, 2),
                attention_resolutions=(4,))


# -- the grid and the validation --------------------------------------------------- #

@pytest.mark.parametrize("grid", [(2, 2), (4, 2), (4, 4), (8, 2), (8, 4), (4, 1)], ids=str)
def test_sp_coords_equal_make_sp_mesh(grid):
    world, sp = grid
    devices = jax.devices()[:world]
    mesh = make_sp_mesh(sp, devices=devices)
    for rank, d in enumerate(devices):
        where = np.argwhere(mesh.devices == d)[0]
        assert parallel.sp_coords(rank, world, sp) == tuple(int(i) for i in where)
    with pytest.raises(ValueError, match=f"sp_size=3 must divide the device count {world}"):
        parallel.sp_coords(0, world, 3)


def test_sp_validation(tmp_path, monkeypatch):
    """``pdae_tpu``'s ``test_sp_validation``: an ``sp_size`` that does not
    divide the world, and ``mesh_layout: hier`` with ``sp``, raise its
    ``ValueError``s; ``sp`` in one process is the one-process layout."""
    from _torch_parity import tiny_pdae_config
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    patch_tiny_encoders(monkeypatch)
    for sharding in ("sp", "fsdp+sp"):
        cfg = tiny_pdae_config()
        cfg["runner_config"].update(param_sharding=sharding, sp_size=3)
        with pytest.raises(ValueError, match="sp_size"):
            pick_trainer(cfg)(config=cfg, run_path=str(tmp_path / "a"), device="cpu")
        cfg["runner_config"].update(sp_size=2, mesh_layout="hier")
        with pytest.raises(ValueError, match="hier"):
            pick_trainer(cfg)(config=cfg, run_path=str(tmp_path / "b"), device="cpu")
        cfg["runner_config"].pop("mesh_layout")
        cfg["runner_config"].pop("sp_size")
        tr = pick_trainer(cfg)(config=cfg, run_path=str(tmp_path / sharding), device="cpu")
        assert tr.sp_groups.sp == 1 and tr.data_world == 1
        one = parallel.sp.ONE
        assert all(getattr(m, "sp", one) is one for m in tr.decoder.modules())
        assert tr.train(max_steps=1) == 1


def test_sp_size_one_is_the_replicated_path_bit_for_bit(tmp_path, monkeypatch):
    """At ``sp_size`` 1 nothing splits: two steps under ``sp`` and
    ``fsdp+sp`` give ``replicated``'s losses and state bit for bit."""
    from _torch_parity import tiny_pdae_config
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    patch_tiny_encoders(monkeypatch)
    runs = {}
    for sharding in ("replicated", "sp", "fsdp+sp"):
        cfg = tiny_pdae_config()
        cfg["runner_config"].update(param_sharding=sharding, sp_size=1)
        tr = pick_trainer(cfg)(config=cfg, run_path=str(tmp_path / sharding), device="cpu")
        losses = [float(tr.train_step(b)["prediction_loss"])
                  for b, _ in zip(tr._batch_iterator(0), range(2))]
        runs[sharding] = (losses, {f"{g}.{k}": p.detach().clone()
                                   for g, named in tr.state.params.items()
                                   for k, p in named.items()})
    for sharding in ("sp", "fsdp+sp"):
        assert runs[sharding][0] == runs["replicated"][0]
        assert all(torch.equal(v, runs["replicated"][1][k])
                   for k, v in runs[sharding][1].items())


# -- the plain versions of the split passes ------------------------------------------ #

def _gn_inputs(seed, b=2, c=16, h=8, w=6, shift=True):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, c, h, w).astype(np.float32) * 1.5 + 0.3
    g = rs.randn(b, c, h, w).astype(np.float32)
    coefs = [1 + 0.2 * rs.randn(c), 0.2 * rs.randn(c)] + [
        0.3 * rs.randn(b, c) for _ in range(4 if shift else 2)]
    return x, g, [np.asarray(a, np.float32) for a in coefs]


def _blocks(t, parts):
    return list(torch.from_numpy(t).chunk(parts, dim=2))


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("shift", [False, True])
def test_the_split_gn_passes_equal_pdae_tpus_closed_form(parts, shift):
    groups = 4
    x, g, coefs = _gn_inputs(parts + 10 * shift, shift=shift)
    full = coefs + ([np.zeros_like(coefs[2])] * 2 if not shift else [])
    nhwc = [jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (x, g)]
    out, res = jax_gn._fwd(nhwc[0], *[jnp.asarray(a) for a in full], groups)
    want_grads = jax_gn._bwd(groups, res, nhwc[1])
    want_out = np.asarray(out).transpose(0, 3, 1, 2)
    want_dx = np.asarray(want_grads[0]).transpose(0, 3, 1, 2)
    t = [torch.from_numpy(a) for a in coefs]
    xs, gs = _blocks(x, parts), _blocks(g, parts)
    # the stats pass on each block, the blocks' sums added (the all-reduce)
    sums = sum(ops.gn_stats_plain(xb, groups) for xb in xs)
    mean, rstd = ops.moments_from_sums(sums, x[0].size // groups)
    got = torch.cat([ops.gn_apply_plain(xb, mean, rstd, *t, groups=groups) for xb in xs], 2)
    np.testing.assert_allclose(got.numpy(), want_out, rtol=RTOL, atol=ATOL)
    # the moments pass on each block, the moments added, then the dx pass
    parts_out = [ops.gn_bwd_moments_plain(xb, gb, mean, rstd, *t, groups=groups)
                 for xb, gb in zip(xs, gs)]
    moments = sum(p[2] for p in parts_out) / (x[0].size // groups)
    dx = torch.cat([ops.gn_bwd_dx_plain(xb, gb, mean, rstd, moments, *t, groups=groups)
                    for xb, gb in zip(xs, gs)], 2)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=RTOL, atol=ATOL)
    # each block's dA, dB unfolded: the partial grads, summed, are JAX's
    padded = t + [None] * (6 - len(t))
    grads = [unfold_grads(p[0], p[1], *padded, [True] * 6) for p in parts_out]
    for i, want in enumerate(want_grads[1:1 + len(t)]):
        total = sum(gr[i] for gr in grads)
        np.testing.assert_allclose(total.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=str(i))


def test_the_split_chain_in_one_part_is_the_train_chain():
    """``gn_adagn_silu_split`` with no reduction and one part, forward and
    backward, against the one-process chain's autograd Function."""
    x, g, coefs = _gn_inputs(3)
    args = [torch.from_numpy(a).requires_grad_(True) for a in [x] + coefs]
    out = ops.gn_adagn_silu_split(*args, groups=4)
    got = torch.autograd.grad(out, args, torch.from_numpy(g))
    args2 = [a.detach().clone().requires_grad_(True) for a in args]
    want_out = ops.gn_adagn_silu_train(*args2, groups=4)
    want = torch.autograd.grad(want_out, args2, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), want_out.detach().numpy(), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("parts", [2, 4])
def test_tq_below_tk_attention_equals_pdae_tpus(parts):
    """A rank's query rows against every key: the plain forward (the
    kernel's plain version) and ``attention_bwd`` against ``pdae_tpu``'s
    reference and ``_attention_core_bwd`` on the whole problem, the rows'
    dk and dv added as the gather's reduce-scatter adds them."""
    rs = np.random.RandomState(parts)
    q, k, v, g = (rs.randn(2, 3, 32, 16).astype(np.float32) for _ in range(4))
    scale = 16 ** -0.25
    want = np.asarray(jax_attention.reference_attention(*map(jnp.asarray, (q, k, v)), scale))
    wdq, wdk, wdv = (np.asarray(a) for a in jax_attention._attention_core_bwd(
        tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g)))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    outs, dqs, dk, dv = [], [], 0, 0
    for qb, gb in zip(torch.from_numpy(q).chunk(parts, 2), torch.from_numpy(g).chunk(parts, 2)):
        assert qb.shape[2] < kt.shape[2]
        outs.append(ops.fused_qkv_attention(qb.contiguous(), kt, vt))
        dq_b, dk_b, dv_b = port_attention.attention_bwd(qb, kt, vt, gb)
        dqs.append(dq_b)
        dk, dv = dk + dk_b, dv + dv_b
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), want, rtol=RTOL, atol=ATOL)
    for got, w in ((torch.cat(dqs, 2), wdq), (dk, wdk), (dv, wdv)):
        np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL)
    plan = port_attention.attention_plan(6, 8, 16, 4, 32)
    assert plan.blocks == port_attention.attention_plan(6, 8, 16, 4).blocks
    assert plan.smem_bytes == port_attention.attention_smem_bytes(32, 16, 4, plan.bm, plan.bn)


# -- the live runs ----------------------------------------------------------------- #

def _sp(cfg, mode="sp", min_size=MIN_SIZE, **extra):
    cfg = copy.deepcopy(cfg)
    cfg["runner_config"].update({"param_sharding": mode, "sp_size": 2,
                                 "fsdp_min_size": min_size}, **extra)
    return cfg


FWD_DPM = dict(TINY_DPM, base_channel=16)


def _jax_sp_forward(jm, params, args, sp, devices):
    """``pdae_tpu``'s forward under ``make_sp_mesh(sp)`` over ``devices``:
    params replicated, the batch sharded over the data axis where it
    divides (else replicated), the models' ``constrain_spatial`` hints
    splitting the rows."""
    mesh = make_sp_mesh(sp, devices=devices)
    dp = len(devices) // sp
    pr = jax.device_put(params, replicated(mesh))
    spec = NamedSharding(mesh, P("data")) if args[0].shape[0] % dp == 0 else replicated(mesh)
    xs = [jax.device_put(jnp.asarray(a), spec) for a in args]
    with mesh:
        y = jax.jit(jm.apply)({"params": pr}, *xs)
    ys = [np.asarray(o) for o in (y if isinstance(y, tuple) else (y,))]
    return [o.transpose(0, 3, 1, 2) if o.ndim == 4 else o for o in ys]


def _forward_cases(root):
    """The models and inputs of the forward jobs (each model initialised in
    ``pdae_tpu`` and carried across by the export maps), and ``want()``,
    which gives ``pdae_tpu``'s sp forwards."""
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    t = rs.randint(0, 1000, (4,)).astype(np.int32)
    z = rs.randn(4, LATENT).astype(np.float32)
    x8 = rs.uniform(-1, 1, (1, 8, 8, 3)).astype(np.float32)
    enc = {"latent_dim": LATENT, "channels": [16, 32], "attn_after_stage": 2,
           "image_size": SIZE}
    models = {  # name: (JAX module, its inputs, port kind, port kwargs, to state dict)
        "unet": (JaxUNet(**FWD_DPM), (x, t), "unet", FWD_DPM, unet_state_dict),
        "shift": (JaxShiftUNet(latent_dim=LATENT, **FWD_DPM), (x, t, z), "shift",
                  dict(FWD_DPM, latent_dim=LATENT), unet_state_dict),
        "encoder": (JaxSemanticEncoder(LATENT, channels=(16, 32), attn_after_stage=2), (x,),
                    "encoder", enc, encoder_state_dict)}
    cases, data, inits = {2: [], 4: []}, {}, {}
    for seed, (name, (jm, args, kind, kwargs, to_sd)) in enumerate(models.items()):
        params = init_flax(jm, *[jnp.asarray(a[:1]) for a in args], seed=7 + seed)
        inits[name] = params
        for b in (4, 1):
            port_args = [nchw(a[:b]) if a.ndim == 4 else torch.from_numpy(a[:b])
                         for a in args]
            port_args = [a.long() if a.dtype == torch.int32 else a for a in port_args]
            data[f"{name}_b{b}"] = {"state": to_sd(params), "args": port_args}
            cases[2].append({"name": f"{name}_b{b}", "model": kind, "kwargs": kwargs})
    deep = JaxUNet(**DEEP_DPM)
    inits["deep"] = init_flax(deep, jnp.asarray(x8), jnp.asarray(t[:1]), seed=11)
    data["deep_b1"] = {"state": unet_state_dict(inits["deep"]),
                       "args": [nchw(x8), torch.from_numpy(t[:1]).long()]}
    cases[4].append({"name": "deep_b1", "model": "unet", "kwargs": DEEP_DPM})
    path = str(root / "forward_inputs.pt")
    torch.save(data, path)

    def want():
        out = {}
        for name, (jm, args, *_) in models.items():
            for b in (4, 1):
                devices = jax.devices()[:8] if b == 4 else jax.devices()[:2]
                out[f"{name}_b{b}"] = _jax_sp_forward(jm, inits[name], [a[:b] for a in args],
                                                      2, devices)
        out["deep_b1"] = _jax_sp_forward(deep, inits["deep"], [x8, t[:1]], 4,
                                         jax.devices()[:4])
        return out
    jobs = {w: {"kind": "forward", "name": f"forward_w{w}", "inputs": path,
                "cases": cases[w], "sp": w} for w in (2, 4)}
    return jobs, want


def _service_job(root):
    enc, dec, artifacts = _small_artifacts()
    config = dict(SMALL_CONFIG, sp_size=2)
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


def _trainer_jobs(root, configs, mode):
    jobs = []
    for name, steps in STEPS.items():
        min_size = 64 if name == "manipulation" else MIN_SIZE
        cfg = _sp(configs[name], mode, min_size)
        job = {"kind": "trainer", "name": f"{name}_{mode}", "config": cfg, "steps": steps,
               "root": str(root / f"{name}_{mode}")}
        if name == "representation":
            cfg["runner_config"]["save_latest_every_steps"] = 2
            job.update(copy_at=2, copy_to=str(root / f"rep_{mode}_step2.ckpt"),
                       eval={"ddim_style": "ddim10"} if mode == "sp" else None)
        jobs.append(job)
    sharded = _sp(configs["representation"], mode, checkpoint_format="sharded",
                  save_latest_every_steps=2)
    jobs.append({"kind": "trainer", "name": f"rep_sharded_{mode}", "config": sharded,
                 "steps": 4, "root": str(root / f"rep_sharded_{mode}"), "copy_at": 2,
                 "copy_to": str(root / f"rep_{mode}_step2.sharded")})
    for fmt in ("ckpt", "sharded"):
        jobs.append({"kind": "trainer", "name": f"rep_resume_{fmt}_{mode}",
                     "config": sharded if fmt == "sharded" else _sp(
                         configs["representation"], mode, save_latest_every_steps=2),
                     "steps": 4, "root": str(root / f"rep_resume_{fmt}_{mode}"),
                     "resume": str(root / f"rep_{mode}_step2.{fmt}")})
    return jobs


def _parity_job(inputs, fsdp, sp=2):
    name = "fsdp_sp" if fsdp else "sp" if sp == 2 else f"sp{sp}"
    return {"kind": "parity", "name": f"parity_{name}", "inputs": inputs,
            "latent": LATENT, "size": SIZE, "dpm": TINY_DPM, "optimizer": OPT,
            "diffusion": DIFFUSION, "ema_decay": EMA_DECAY, "min_size": MIN_SIZE, "sp": sp,
            "fsdp": fsdp}


def _jax_step_under_sp_mesh(jx, inputs, sp):
    """``pdae_tpu``'s step over the parity batch under ``make_sp_mesh(sp)``
    on ``sp`` CPU devices (one data replica): state and batch replicated,
    the models' ``constrain_spatial`` hints laying the maps out (at sp 3 no
    height of the 16px models divides, so every map stays whole)."""
    data = torch.load(inputs, weights_only=False)
    x, noise = (jnp.asarray(data[k].permute(0, 2, 3, 1).numpy()) for k in ("x", "noise"))
    mesh = make_sp_mesh(sp, devices=jax.devices()[:sp])
    args = jax.device_put((jx.new_state(), x, jnp.asarray(data["t"].numpy()), noise),
                          replicated(mesh))
    with mesh:
        state, loss, grads = jax.jit(jx.step.__wrapped__)(*args)
    return {"loss": float(loss), "grads": jax.device_get(grads),
            "params": jax.device_get(state.params)}


def _start_sp(root, jobs, world, tag):
    return _start(root, jobs, world, tag, worker="_torch_sp_worker.py")


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    build_stage34_artifacts(root)
    configs = _configs(root)
    for cfg in configs.values():
        cfg["dataloader_config"]["eval"]["num_generations"] = 2
    jx = _Jax()
    inputs, jax_want = _parity_inputs(root, jx)
    forward, forward_want = _forward_cases(root)
    service, service_want = _service_job(root)
    jobs2 = [forward[2], _parity_job(inputs, False), service] + _trainer_jobs(
        root, configs, "sp")
    jobs4 = [forward[4], _parity_job(inputs, True)] + _trainer_jobs(root, configs, "fsdp+sp")
    # sp 3 over 16-row images: no map splits, every rank runs the models whole
    three = _sp(configs["representation"], sp_size=3)
    jobs3 = [_parity_job(inputs, False, sp=3),
             {"kind": "trainer", "name": "representation_sp3", "config": three,
              "steps": STEPS["representation"], "root": str(root / "representation_sp3")}]
    # the one-process references are computed while the ranks run
    t0 = time.perf_counter()
    started = _start_sp(root, jobs2, 2, "w2")
    controls = {"sp": _controls(root, configs, 1)}
    forward_want = forward_want()
    outs = {"sp": _finish(started)}
    started = _start_sp(root, jobs4, 4, "w4")
    controls["fsdp+sp"] = _controls(root, configs, 2)
    outs["fsdp+sp"] = _finish(started)
    started = _start_sp(root, jobs3, 3, "w3")
    jax_sp3 = _jax_step_under_sp_mesh(jx, inputs, 3)
    outs["sp3"] = _finish(started)
    seconds = time.perf_counter() - t0

    def dumps(name, world):
        return [torch.load(root / f"{name}_rank{r}.pt", weights_only=False)
                for r in range(world)]
    yield {"root": root, "outs": outs, "dumps": dumps, "jax": jax_want, "jax_sp3": jax_sp3,
           "forward_want": forward_want, "service_want": service_want,
           "controls": controls, "seconds": seconds}


# -- the forwards -------------------------------------------------------------------- #

FORWARD_CASES = [(f"{m}_b{b}", 2) for b in (4, 1) for m in ("unet", "shift", "encoder")] + [
    ("deep_b1", 4)]


@pytest.mark.parametrize("case", FORWARD_CASES, ids=[c for c, _ in FORWARD_CASES])
def test_the_sp_forward_matches_pdae_tpus_sp_forward(live, case):
    name, world = case
    got = live["dumps"](f"forward_w{world}", world)
    for r in range(world):
        assert got[r]["sp_index"] == r
        out = got[r]["out"][name]
        outs = out if isinstance(out, tuple) else (out,)
        for o, w in zip(outs, live["forward_want"][name]):
            assert o.shape == w.shape
            np.testing.assert_allclose(o.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


# -- one step ------------------------------------------------------------------------ #

def _grouped(flat):
    out = {"encoder": {}, "shift": {}}
    for key, v in flat.items():
        g, k = key.split(".", 1)
        out[g][k] = v
    return out


@pytest.mark.parametrize("mode", ["sp", "fsdp_sp", "sp3"])
def test_one_sp_step_matches_the_jax_step(live, mode):
    """The step at sp 2, at ``fsdp+sp`` and at sp 3 (world 3, where no map
    of the 16px models splits: the gradients are whole on every rank, not
    partial sums, and are not summed over the sp group) against
    ``pdae_tpu``'s (at sp 3 under ``make_sp_mesh(3)``)."""
    want = live["jax_sp3"] if mode == "sp3" else live["jax"]
    world = {"sp": 2, "fsdp_sp": 4, "sp3": 3}[mode]
    got_all = live["dumps"](f"parity_{mode}", world)
    for got in got_all:
        assert got["partial"] == (mode != "sp3")
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=RTOL)
        _assert_groups_close(_grouped(got["grads"]), want["grads"], atol=ATOL, rtol=RTOL,
                             scaled=True)
        _assert_groups_close(_grouped(got["params"]), want["params"], atol=ATOL)
    for got in got_all[1:]:
        assert all(torch.equal(got["params"][k], got_all[0]["params"][k])
                   for k in got["params"])


# -- the trainers --------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(STEPS))
def test_sp_trains_what_the_replicated_run_trains(live, name, mode):
    """``test_sp_trainer_matches_replicated`` and
    ``test_fsdp_sp_trainer_matches_replicated``: the losses, params, EMA and
    moments against one process over the same global batch; the parameters
    whole on every rank; every rank bit-equal."""
    world = MODES[mode]
    dumps = live["dumps"](f"{name}_{mode}", world)
    want = live["controls"][mode][name]
    for r, got in enumerate(dumps):
        assert got["count"] == want["step"] == STEPS[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for key, ts in want["state"].items():
            for i, (x, w) in enumerate(zip(got["tensors"][key], ts[:4])):
                atol = PARAM_ATOL if i < 2 else SCALED_ATOL * float(w.abs().max()) + 1e-8
                np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=atol,
                                           err_msg=f"{name} {key} [{i}]")
        out = live["outs"][mode][r][f"{name}_{mode}"]
        assert out["grid"] == [2, world // 2, r % 2, r // 2]
        for h in out["held"]:
            assert h["ema"] == h["moments"][0] == h["moments"][1]
            if mode == "sp":
                assert h["ema"] == h["param"]
    for got in dumps[1:]:
        assert got["losses"] == dumps[0]["losses"]
        for key, ts in got["tensors"].items():
            assert all(torch.equal(x, y) for x, y in zip(ts, dumps[0]["tensors"][key])), key


def test_sp_three_with_nothing_split_trains_what_the_replicated_run_trains(live):
    """The representation trainer at sp 3 over 16-row images (world 3, one
    data replica): no module is laid out, and the run matches the one
    process over the same batch as sp 2's does."""
    dumps = live["dumps"]("representation_sp3", 3)
    want = live["controls"]["sp"]["representation"]
    for r, got in enumerate(dumps):
        assert got["count"] == want["step"] == STEPS["representation"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for key, ts in want["state"].items():
            for i, (x, w) in enumerate(zip(got["tensors"][key], ts[:4])):
                atol = PARAM_ATOL if i < 2 else SCALED_ATOL * float(w.abs().max()) + 1e-8
                np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=atol,
                                           err_msg=f"sp3 {key} [{i}]")
        assert live["outs"]["sp3"][r]["representation_sp3"]["grid"] == [3, 1, r, 0]
    for got in dumps[1:]:
        assert got["losses"] == dumps[0]["losses"]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fmt", ["ckpt", "sharded"])
def test_sp_checkpoint_roundtrip(live, mode, fmt):
    """A resume at step 2 from either format is bit-equal to the run
    without it (``pdae_tpu``'s ``test_sp_checkpoint_roundtrip``)."""
    world = MODES[mode]
    through = live["dumps"](f"rep_sharded_{mode}" if fmt == "sharded"
                            else f"representation_{mode}", world)
    resumed = live["dumps"](f"rep_resume_{fmt}_{mode}", world)
    for r in range(world):
        assert resumed[r]["losses"] == through[r]["losses"][2:]
        for key, ts in through[r]["tensors"].items():
            for x, y in zip(ts, resumed[r]["tensors"][key]):
                assert torch.equal(x, y), (r, key)
    files = sorted(os.listdir(live["root"] / f"rep_{mode}_step2.sharded"))
    assert files[0] == "manifest.msgpack" and len(files) == 1 + world


def test_the_sp_eval_grid_is_written_once(live):
    files = live["outs"]["sp"][0]["representation_sp"]["files"]
    assert "samples/sample0k.png" in files and "config.yml" in files


# -- the service --------------------------------------------------------------------- #

@pytest.mark.parametrize("call", ["encode_b3", "autoencode_b1", "autoencode_b3", "decode_b3",
                                  "generate_b3", "manipulate_b1"])
def test_the_sp_service_answers_as_one_process(live, call):
    want = live["service_want"][call]
    got = live["dumps"]("service", 2)
    for r in range(2):
        out = got[r]["out"][call]
        assert out.shape == want.shape
        if out.dtype == np.uint8:
            assert np.abs(out.astype(int) - want.astype(int)).max() <= 1, call
        else:
            np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_the_live_runs_stay_in_their_budget(live):
    assert live["seconds"] < 240, live["seconds"]


# -- the serve CLI --------------------------------------------------------------------- #

def test_serve_sp_size_two_answers_a_request(tmp_path):
    config = _serve_files(tmp_path)
    port, http = _free_port(), _free_port()
    cfg = tmp_path / "serve.yml"
    cfg.write_text(json.dumps(config))
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pdae_torch.serve", "--config", str(cfg), "--port",
             str(http), "--device", "cpu", "--sp-size", "2", "--coalesce-ms", "0"],
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
    one = PDAEService.from_config(config, device="cpu")
    want = one.autoencode(img[None], encode_style="ddim2", decode_style="ddim2")[0]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
