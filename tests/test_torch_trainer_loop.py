"""The port's trainer loop on the CPU: bitwise resume, the background
checkpoint write, SIGINT, ``ema_every``, ``num_iterations``, the cadence
check, the refusals, ``device_resident`` and ``transfer_uint8``, the trainer
each config picks, the eval grid and ``python -m pdae_torch.train``.

The run is the tiny one of ``tests/test_torch_trainer.py`` (SYNTHETIC 16px
gray, a two-level UNet of 8 channels, a two-stage encoder), its DPM trunk
grafted from a checkpoint the port itself wrote from a seeded UNet.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from _torch_parity import (TRAINER_DPM, assert_trees_bitwise, patch_tiny_encoders,
                           tiny_pdae_config)
from pdae_torch.models import UNet
from pdae_torch.training import RepresentationLearningTrainer, maybe_ema_update
from pdae_torch.training import base as base_mod
from pdae_torch.training.partition import split_shift_tree
from pdae_torch.utils import load_checkpoint, save_checkpoint, to_uint8, unet_tree
from pdae_torch.utils.image import make_grid

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_dpm(tmp_path_factory):
    """A DPM checkpoint written by the port: a seeded UNet under
    ``ema_denoise_fn`` in the flax layout."""
    torch.manual_seed(3)
    geometry = {k: v for k, v in TRAINER_DPM.items() if k != "model"}
    tree = unet_tree(UNet(**geometry).state_dict())
    path = str(tmp_path_factory.mktemp("dpm") / "dpm.ckpt")
    save_checkpoint(path, {"step": np.asarray(0, np.int32), "ema_denoise_fn": tree})
    return path, tree


def _trainer(run, cfg, **kw):
    return RepresentationLearningTrainer(config=cfg, run_path=str(run), device="cpu", **kw)


def _losses(run):
    with open(os.path.join(str(run), "metrics.jsonl")) as f:
        return [(r["step"], r["prediction_loss"]) for r in map(json.loads, f)]


def test_graft_of_a_port_dpm(port_dpm, tmp_path, monkeypatch):
    path, tree = port_dpm
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "run", tiny_pdae_config(path))
    trunk = split_shift_tree(unet_tree(tr.decoder.state_dict()))[1]
    assert_trees_bitwise(trunk, tree)


def test_resume_is_bitwise(port_dpm, tmp_path, monkeypatch):
    """4 straight steps against 2, a resume and 2 more: the same state and
    the same losses in metrics.jsonl. 24 items at b8 are 3 batches an epoch,
    so the resumed run crosses an epoch end."""
    patch_tiny_encoders(monkeypatch)
    cfg = tiny_pdae_config(port_dpm[0])
    cfg["train_dataset_config"]["length"] = 24
    straight = _trainer(tmp_path / "a", cfg)
    straight.train(max_steps=4)
    first = _trainer(tmp_path / "b", cfg)
    assert first.train(max_steps=2) == 2
    resumed = _trainer(tmp_path / "b", cfg, resume="latest")
    assert resumed.start_step == 2
    assert_trees_bitwise(resumed.state_dict(), first.state_dict())
    assert resumed.train(max_steps=4) == 4
    assert_trees_bitwise(resumed.state_dict(), straight.state_dict())
    assert _losses(tmp_path / "b") == _losses(tmp_path / "a")
    assert [s for s, _ in _losses(tmp_path / "a")] == [1, 2, 3, 4]
    assert_trees_bitwise(load_checkpoint(str(tmp_path / "b" / "checkpoints" / "latest.ckpt")),
                         load_checkpoint(str(tmp_path / "a" / "checkpoints" / "latest.ckpt")))


def test_a_save_holds_its_step_while_the_next_runs(port_dpm, tmp_path, monkeypatch):
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0]))
    tr.train(max_steps=1, save_on_exit=False)
    want = copy.deepcopy(tr.state_dict())
    go = threading.Event()
    real = base_mod.save_checkpoint

    def slow(path, tree):
        go.wait(30)
        real(path, tree)

    monkeypatch.setattr(base_mod, "save_checkpoint", slow)
    tr.save(1)
    # the next step changes params, EMA and moments in place while the
    # write waits
    tr.train_step(next(tr._batch_iterator(1)))
    moved = tr.state_dict()
    go.set()
    tr._join_save()
    raw = load_checkpoint(str(tmp_path / "run" / "checkpoints" / "latest.ckpt"))
    assert int(raw["step"]) == 1
    assert_trees_bitwise({k: raw[k] for k in want}, want)
    for key in ("decoder", "ema_decoder"):
        assert not np.array_equal(moved[key]["shift_out_conv"]["kernel"],
                                  want[key]["shift_out_conv"]["kernel"])
    assert tr.save_seconds[-1][1] is not None


def test_a_failed_write_reraises(port_dpm, tmp_path, monkeypatch):
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0]))

    def broken(path, tree):
        raise OSError("disk full")

    monkeypatch.setattr(base_mod, "save_checkpoint", broken)
    with pytest.raises(RuntimeError, match="background checkpoint write failed") as e:
        tr.train(max_steps=1)
    assert isinstance(e.value.__cause__, OSError)


def test_sigint_saves_and_stops(port_dpm, tmp_path, monkeypatch):
    patch_tiny_encoders(monkeypatch)
    cfg = tiny_pdae_config(port_dpm[0])
    tr = _trainer(tmp_path / "run", cfg)
    inner = tr.train_step
    count = {"n": 0}

    def wrapped(batch):
        count["n"] += 1
        if count["n"] == 2:
            os.kill(os.getpid(), signal.SIGINT)
        return inner(batch)

    tr.train_step = wrapped
    assert tr.train(max_steps=50) == 2
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "latest.ckpt")
    assert _trainer(tmp_path / "run", cfg, resume="latest").start_step == 2


def test_ema_every_gating(port_dpm, tmp_path, monkeypatch):
    ema, params = {"g": {"w": torch.zeros(3)}}, {"g": {"w": torch.ones(3)}}
    maybe_ema_update(2, ema, params, 0.5, 2)
    assert torch.equal(ema["g"]["w"], torch.full((3,), 0.5))
    maybe_ema_update(3, ema, params, 0.5, 2)
    assert torch.equal(ema["g"]["w"], torch.full((3,), 0.5))
    # in the trainer: the EMA moves after step 2 and not after step 1
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0], ema_every=2))
    ema = ("ema_encoder", "ema_decoder")
    start = copy.deepcopy({k: tr.state_dict()[k] for k in ema})
    tr.train(max_steps=1, save_on_exit=False)
    assert_trees_bitwise({k: tr.state_dict()[k] for k in ema}, start)
    tr.train(max_steps=2, save_on_exit=False)
    # the shift branch's output conv moves at every step (its gradient is
    # not zero at the zero init, unlike the encoder's)
    assert not np.array_equal(tr.state_dict()["ema_decoder"]["shift_out_conv"]["kernel"],
                              start["ema_decoder"]["shift_out_conv"]["kernel"])


def test_num_iterations_splits_the_batch(port_dpm, tmp_path, monkeypatch):
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0], num_iterations=2))
    assert tr.loader.batch_size == 16
    assert tr.train(max_steps=1) == 1
    assert all(torch.isfinite(p).all() for p in tr.encoder.parameters())


def test_steps_per_dispatch_keeps_the_cadence_check(port_dpm, tmp_path, monkeypatch):
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "bad", tiny_pdae_config(port_dpm[0], steps_per_dispatch=4,
                                                      display_steps=3))
    with pytest.raises(ValueError, match="display_steps=3 must be a multiple of "
                                         "steps_per_dispatch=4"):
        tr.train(max_steps=1)
    tr = _trainer(tmp_path / "ok", tiny_pdae_config(port_dpm[0], steps_per_dispatch=2,
                                                     display_steps=2))
    assert tr.train(max_steps=2) == 2


# fsdp, tp, sp, their compositions, the hierarchical mesh and the sharded
# write train (tests/test_torch_fsdp.py, tests/test_torch_tp.py,
# tests/test_torch_sp.py, tests/test_torch_hier.py), profiler traces are
# written (the profile_dir tests below); the sp layouts' errors are
# pdae_tpu's ValueErrors, raised before the run directory exists
REFUSALS = {
    "param_sharding": ({"runner_config": {"param_sharding": "sp", "sp_size": 2}},
                       ValueError, "sp_size=2 must divide the device count 1"),
    "param_sharding_sp": ({"runner_config": {"param_sharding": "sp", "mesh_layout": "hier"}},
                          ValueError, "mesh_layout 'hier' applies to fsdp; sp builds"),
    "param_sharding_fsdp+sp": ({"runner_config": {"param_sharding": "fsdp+sp",
                                                  "sp_size": 3}},
                               ValueError, "sp_size=3 must divide the device count 1"),
    # a torchrun launch of any layout, fsdp+sp too, needs the process group
    # joined first
    "WORLD_SIZE": ({"runner_config": {"param_sharding": "fsdp+sp"}},
                   RuntimeError, "WORLD_SIZE=2, but this process has not joined"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_unported_options_are_refused_by_name(name, tmp_path, monkeypatch):
    change, error, what = REFUSALS[name]
    if name == "WORLD_SIZE":
        monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = tiny_pdae_config()
    for section, values in change.items():
        cfg[section].update(values)
    with pytest.raises(error, match=what):
        _trainer(tmp_path / "run", cfg)
    assert not os.path.exists(tmp_path / "run")


def _traces(path) -> list:
    """The Chrome traces ``tensorboard_trace_handler`` wrote under ``path``,
    each parsed (a trace cut off mid-write does not parse)."""
    names = sorted(n for n in os.listdir(path) if n.endswith(".pt.trace.json"))
    assert len(names) == len(os.listdir(path)), os.listdir(path)
    out = []
    for name in names:
        with open(os.path.join(path, name)) as f:
            out.append(json.load(f))
    return out


def _ops(trace) -> set:
    return {e.get("name") for e in trace["traceEvents"] if e.get("cat") == "cpu_op"}


@pytest.mark.parametrize("k", [1, 2])
def test_profile_dir_traces_the_loop_and_keeps_the_bits(k, port_dpm, tmp_path, monkeypatch):
    """``runner_config.profile_dir`` (the JAX trainer's profiler trace):
    each ``train`` call writes one trace of its loop (the steps' ops in it)
    under the directory, eagerly and in chunks of ``steps_per_dispatch``
    (on the CPU the chunks run eagerly), and the run's losses and state are
    bit-equal to the same run without it."""
    patch_tiny_encoders(monkeypatch)
    runner = {"steps_per_dispatch": k, "display_steps": k}
    plain = _trainer(tmp_path / "plain", tiny_pdae_config(port_dpm[0], **runner))
    plain.train(max_steps=2 * k, save_on_exit=False)
    traced_dir = tmp_path / "trace"
    traced = _trainer(tmp_path / "traced", tiny_pdae_config(
        port_dpm[0], profile_dir=str(traced_dir), **runner))
    traced.train(max_steps=k, save_on_exit=False)
    traced.train(max_steps=2 * k, save_on_exit=False)
    assert _losses(tmp_path / "traced") == _losses(tmp_path / "plain")
    assert len(_losses(tmp_path / "plain")) == 2
    assert_trees_bitwise(traced.state_dict(), plain.state_dict())
    traces = _traces(traced_dir)
    assert len(traces) == 2
    for trace in traces:
        assert {"aten::convolution", "aten::group_norm"} <= _ops(trace), sorted(_ops(trace))


def test_profile_dir_trace_is_written_when_the_loop_raises(port_dpm, tmp_path, monkeypatch):
    """An exception mid-loop still stops the profiler and writes a whole
    trace of the steps before it, and the signal handlers the loop
    replaced are back."""
    patch_tiny_encoders(monkeypatch)
    traced_dir = tmp_path / "trace"
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0],
                                                     profile_dir=str(traced_dir)))
    inner = tr.train_step
    count = {"n": 0}

    def failing(batch):
        count["n"] += 1
        if count["n"] == 3:
            raise RuntimeError("a step failed")
        return inner(batch)

    tr.train_step = failing
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGINT, signal.SIGTERM)}
    with pytest.raises(RuntimeError, match="a step failed"):
        tr.train(max_steps=5)
    assert {sig: signal.getsignal(sig) for sig in handlers} == handlers
    assert not torch.autograd.profiler._is_profiler_enabled
    (trace,) = _traces(traced_dir)
    assert "aten::convolution" in _ops(trace)
    assert [s for s, _ in _losses(tmp_path / "run")] == [1, 2]


def test_profile_dir_traces_on_the_primary_rank_only(port_dpm, tmp_path, monkeypatch):
    """Another rank of a run (the primary alone writes) leaves no trace."""
    patch_tiny_encoders(monkeypatch)
    traced_dir = tmp_path / "trace"
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0],
                                                     profile_dir=str(traced_dir)))
    tr.primary = False
    assert tr.train(max_steps=1, save_on_exit=False) == 1
    assert not os.path.exists(traced_dir)


def test_with_weights_leaves_every_module_parameter_as_it_was():
    """The eval's EMA swap (``base.with_weights``) puts each module's own
    parameter back, under a module's second name too (MLPSkipNet's
    ``linear_emb`` is also ``cond_layers.1``), and computes with the EMA."""
    from pdae_torch.models.mlp_skip_net import MLPSkipNet
    from pdae_torch.training.base import with_weights

    torch.manual_seed(0)
    model = MLPSkipNet(16, 32, 3, 8)
    before = [(m, a, p) for m in model.modules() for a, p in m._parameters.items()]
    ema = {k: v.detach() + 1 for k, v in model.named_parameters()}
    z, t = torch.randn(2, 16), torch.tensor([3, 7])
    got = with_weights({"model": model}, {"model": ema}, lambda m, z, t: m(z, t), z, t)
    assert all(m._parameters[a] is p for m, a, p in before)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.add_(1)
        assert torch.equal(got, model(z, t))


@pytest.mark.parametrize("sharding", ["fsdp", "replicated"])
def test_mesh_layout_hier_trains(sharding, tmp_path, monkeypatch):
    """``mesh_layout: hier`` lifted its refusal (the live runs are in
    ``tests/test_torch_hier.py``): in one process the grid is ``[1, 1]`` and
    the trainer takes a step; a ``hier_shape`` that does not cover the world
    raises before the run directory exists."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    patch_tiny_encoders(monkeypatch)
    cfg = tiny_pdae_config()
    cfg["runner_config"].update(param_sharding=sharding, mesh_layout="hier")
    tr = _trainer(tmp_path / "run", cfg)
    assert tr.mesh_layout == "hier" and tr.plan is None
    assert tr.train(max_steps=1) == 1
    cfg["runner_config"].update(hier_shape=[2, 1])
    with pytest.raises(ValueError, match="hier_shape=\\[2, 1\\] must cover the world of 1"):
        _trainer(tmp_path / "bad", cfg)
    assert not os.path.exists(tmp_path / "bad")


def test_tp_in_one_process_is_the_one_process_layout_and_hier_is_refused(tmp_path,
                                                                          monkeypatch):
    """``tp`` lifted its refusal: in one process ``tp_size`` defaults to the
    world of one, nothing splits, and the trainer takes a step; a
    ``tp_size`` that does not divide the world and ``mesh_layout: hier``
    with tp raise ``pdae_tpu``'s ``ValueError``s."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    patch_tiny_encoders(monkeypatch)
    for sharding in ("tp", "fsdp+tp"):
        cfg = tiny_pdae_config()
        cfg["runner_config"].update(param_sharding=sharding)
        tr = _trainer(tmp_path / sharding.replace("+", "_"), cfg)
        assert tr.tp_layout.groups.tp == 1 and tr.data_world == 1
        assert all(i.role == "whole" for i in tr.tp_layout.infos.values())
        assert tr.train(max_steps=1) == 1
    cfg = tiny_pdae_config()
    cfg["runner_config"].update(param_sharding="tp", tp_size=2)
    with pytest.raises(ValueError, match="model_size=2 must divide the device count 1"):
        _trainer(tmp_path / "tp2", cfg)
    cfg["runner_config"].update(mesh_layout="hier")
    with pytest.raises(ValueError, match="mesh_layout 'hier' applies to fsdp"):
        _trainer(tmp_path / "hier", cfg)


# the options whose refusals the compute dtype and remat lifted: each trains
ACCEPTED = {
    "remat_full": ({"runner_config": {"remat": True}}, torch.float32),
    "remat_skips": ({"runner_config": {"remat": "skips"}}, torch.float32),
    "compute_dtype": ({"runner_config": {"compute_dtype": "bfloat16"}}, torch.bfloat16),
    "enable_amp": ({"optimizer_config": {"enable_amp": True}}, torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_remat_and_compute_dtype_train_a_step(name, port_dpm, tmp_path, monkeypatch):
    """The tiny trainer with the option set takes a step: finite loss, every
    parameter fp32 and finite, every conv and linear of both models
    computing in the chosen dtype."""
    from pdae_torch.models.blocks import Conv1d, Conv2d, Linear
    change, dtype = ACCEPTED[name]
    patch_tiny_encoders(monkeypatch)
    cfg = tiny_pdae_config(port_dpm[0])
    for section, values in change.items():
        cfg[section].update(values)
    tr = _trainer(tmp_path / "run", cfg)
    assert tr._compute_dtype() == dtype
    assert tr.train(max_steps=1) == 1
    assert np.isfinite(_losses(tmp_path / "run")[0][1])
    layers = [m for model in (tr.encoder, tr.decoder) for m in model.modules()
              if isinstance(m, (Conv1d, Conv2d, Linear))]
    assert layers and all(m.compute_dtype == dtype for m in layers)
    for model in (tr.encoder, tr.decoder):
        assert model.dtype == dtype
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in model.parameters())


@pytest.mark.parametrize("option", ["device_resident", "transfer_uint8"])
def test_data_options_are_accepted_and_train_a_step(option, port_dpm, tmp_path,
                                                    monkeypatch):
    """The options the shipped stage configs set, on the representation
    trainer: the step reads uint8 pixels, or gathers its batch from the
    resident corpus, and the eval grid reads the eval set's x_0 alike."""
    patch_tiny_encoders(monkeypatch)
    cfg = tiny_pdae_config(port_dpm[0])
    cfg["train_dataset_config"][option] = True
    tr = _trainer(tmp_path / "run", cfg)
    batch = next(tr._batch_iterator(0))
    assert batch["x_0"].dtype == (torch.uint8 if option == "transfer_uint8"
                                  else torch.float32)
    assert tr.train(max_steps=1) == 1
    assert all(torch.isfinite(p).all() for p in tr.encoder.parameters())
    tr.evaluate(1, ddim_style="ddim2")
    assert os.path.exists(tmp_path / "run" / "samples" / "sample0k.png")


@pytest.mark.parametrize("key,name", [("denoise_fn_config", "RegularDiffusionTrainer"),
                                      ("latent_denoise_fn_config",
                                       "LatentDiffusionTrainer"),
                                      ("inferred_latents", "ManipulationTrainer")])
def test_pick_trainer_returns_each_trainer(key, name):
    """The trainer of a config's keys, in ``scripts/train.py``'s order."""
    from pdae_torch.train import pick_trainer
    assert pick_trainer({key: {}}).__name__ == name
    assert pick_trainer(tiny_pdae_config()) is RepresentationLearningTrainer
    with pytest.raises(SystemExit, match="cannot infer trainer type"):
        pick_trainer({})


def test_eval_grid_decodes_with_the_ema_weights(port_dpm, tmp_path, monkeypatch):
    from pdae_torch.utils.rng import EVAL, generator
    from PIL import Image
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0], evaluate_every_steps=2))
    tr.train(max_steps=2)
    before = copy.deepcopy(tr.state_dict())
    tr.evaluate(2, ddim_style="ddim4")
    assert_trees_bitwise(tr.state_dict(), before)        # the live weights stay
    read = np.asarray(Image.open(tmp_path / "run" / "samples" / "sample0k.png"))
    # the same grid from copies of the models holding the EMA weights
    enc, dec = copy.deepcopy(tr.encoder).eval(), copy.deepcopy(tr.decoder).eval()
    with torch.no_grad():
        for model, group in ((enc, "encoder"), (dec, "shift")):
            named = dict(model.named_parameters())
            for k, v in tr.state.ema_params[group].items():
                named[k].copy_(v)
    items = [tr.eval_dataset[i] for i in range(2)]
    x_0 = torch.from_numpy(np.stack([i["x_0"] for i in items])).permute(0, 3, 1, 2).contiguous()
    x_T = torch.randn(x_0.shape, generator=generator(0, EVAL, 2, "cpu"))
    with torch.no_grad():
        imgs = tr.gd.representation_learning_ddim_sample("ddim4", enc, dec, x_0, x_T)
    stacked = []
    for g, im in zip([i["gt"] for i in items], to_uint8(imgs.permute(0, 2, 3, 1).numpy())):
        stacked += [g, im]
    np.testing.assert_array_equal(read, make_grid(np.stack(stacked), nrow=2)[..., 0])


def test_train_entry_point(tmp_path):
    """``python -m pdae_torch.train`` on the CPU from a YAML config (the
    64px encoder over a 3-channel tiny DPM, SYNTHETIC b2), then its
    ``main`` with ``--resume latest``."""
    yaml = pytest.importorskip("yaml")
    dpm = dict(TRAINER_DPM, input_channel=3)
    cfg = tiny_pdae_config()
    cfg["trained_ddpm_config"] = {"denoise_fn_config": dpm}
    cfg["train_dataset_config"] = {"name": "SYNTHETIC", "image_size": 64,
                                   "image_channel": 3, "length": 6, "latent_dim": 16}
    cfg["encoder_config"] = {"model": "CELEBA64Encoder", "latent_dim": 16}
    cfg["dataloader_config"]["train"]["batch_size"] = 2
    config_path = str(tmp_path / "config.yml")
    with open(config_path, "w") as f:
        yaml.safe_dump(cfg, f)
    run = str(tmp_path / "run")
    env = {**os.environ, "PYTHONPATH": ROOT}

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "pdae_torch.train", "--config_path",
                               config_path, "--run_path", run, "--device", "cpu", *args],
                              cwd=str(tmp_path), env=env, capture_output=True, text=True,
                              timeout=300)

    out = cli("--max_steps", "4", "--set", "runner_config.save_latest_every_steps=3")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "trainer: RepresentationLearningTrainer" in out.stdout
    assert int(load_checkpoint(os.path.join(run, "checkpoints", "latest.ckpt"))["step"]) == 4
    # the resume through main() in this process: the same code, one interpreter
    # start (and its TensorBoard import) fewer
    from pdae_torch.train import main
    assert main(["--config_path", config_path, "--run_path", run, "--device", "cpu",
                 "--resume", "latest", "--max_steps", "6"]) == 0
    assert int(load_checkpoint(os.path.join(run, "checkpoints", "latest.ckpt"))["step"]) == 6
    assert [s for s, _ in _losses(run)] == [1, 2, 3, 4, 5, 6]
    with open(os.path.join(run, "config.yml")) as f:
        assert json.load(f)["runner_config"]["save_latest_every_steps"] == 100000


def test_the_trainer_path_needs_no_yaml_msgpack_or_pil(tmp_path):
    """A run from a config dict (train, eval grid, checkpoint, resume)
    imports none of ``yaml``, ``msgpack`` and ``PIL``, which the card's
    machine is not known to have, TensorBoard's image summary included.
    TensorFlow is made unimportable in the child, as on the card's machine
    (here TensorBoard would import it, and it imports PIL)."""
    dpm = dict(TRAINER_DPM, input_channel=3)
    cfg = tiny_pdae_config()
    cfg["trained_ddpm_config"] = {"denoise_fn_config": dpm}
    cfg["train_dataset_config"] = {"name": "SYNTHETIC", "image_size": 64,
                                   "image_channel": 3, "length": 4, "latent_dim": 16}
    cfg["encoder_config"] = {"model": "CELEBA64Encoder", "latent_dim": 16}
    cfg["dataloader_config"]["train"]["batch_size"] = 2
    script = f"""
import json, sys
sys.modules["tensorflow"] = None
from pdae_torch.training import RepresentationLearningTrainer
cfg = json.loads({json.dumps(json.dumps(cfg))})
run = {json.dumps(str(tmp_path / "run"))}
tr = RepresentationLearningTrainer(config=cfg, run_path=run, device="cpu")
tr.train(max_steps=2)
tr.evaluate(2, ddim_style="ddim2")
RepresentationLearningTrainer(config=cfg, run_path=run, device="cpu", resume="latest")
import importlib.util                    # where TensorBoard is, the image went there
assert (tr.logger._tb is not None) == (importlib.util.find_spec("tensorboard") is not None)
print(json.dumps(sorted(m for m in ("yaml", "msgpack", "PIL") if m in sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert os.path.exists(tmp_path / "run" / "samples" / "sample0k.png")


def test_a_save_replaces_a_sharded_latest(port_dpm, tmp_path, monkeypatch):
    """A run dir whose ``latest.ckpt`` is a sharded directory (a JAX run's)
    gets a file in its place, a resume heals a replacement cut short, and a
    directory of anything else is refused."""
    from pdae_tpu.utils import save_sharded_checkpoint
    patch_tiny_encoders(monkeypatch)
    tr = _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0]))
    latest = tmp_path / "run" / "checkpoints" / "latest.ckpt"
    save_sharded_checkpoint(str(latest), {"w": np.ones(4, np.float32)})
    assert latest.is_dir()
    tr.save(0)
    tr._join_save()
    assert latest.is_file() and int(load_checkpoint(str(latest))["step"]) == 0
    # a save that stopped between dropping the directory and the rename
    # leaves the new file as latest.ckpt.swap; a resume takes it
    os.replace(latest, str(latest) + ".swap")
    assert _trainer(tmp_path / "run", tiny_pdae_config(port_dpm[0]),
                    resume="latest").start_step == 0
    assert latest.is_file()
    os.unlink(latest)
    os.makedirs(latest)
    (latest / "notes.txt").write_text("not a checkpoint")
    with pytest.raises(ValueError, match="refusing to overwrite"):
        tr.save(0)


def test_snapshot_cadence_and_no_final_save_after_an_error(port_dpm, tmp_path, monkeypatch):
    """One save covers both cadences (``save-0k.ckpt`` beside ``latest.ckpt``
    at step 2), and a run that raises leaves its last good checkpoint."""
    patch_tiny_encoders(monkeypatch)
    cfg = tiny_pdae_config(port_dpm[0], save_checkpoint_every_steps=2)
    tr = _trainer(tmp_path / "run", cfg)
    saves = []
    inner_save = tr.save
    monkeypatch.setattr(tr, "save", lambda step, snapshot=False: (
        saves.append((step, snapshot)), inner_save(step, snapshot))[1])
    inner = tr.train_step

    def failing(batch):
        if tr.step == 3:
            raise RuntimeError("step failed")
        return inner(batch)

    tr.train_step = failing
    with pytest.raises(RuntimeError, match="step failed"):
        tr.train(max_steps=10)
    assert saves == [(2, True)]
    ckpts = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["latest.ckpt", "save-0k.ckpt"]
    for name in ("latest.ckpt", "save-0k.ckpt"):
        assert int(load_checkpoint(str(ckpts / name))["step"]) == 2


def test_tensorboard_image_summary_reads_back(tmp_path):
    """The eval grid's TensorBoard summary is a PNG made without PIL that
    TensorBoard reads back as the same pixels."""
    pytest.importorskip("tensorboard")
    import io
    from PIL import Image
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    logger = base_mod.Logger(str(tmp_path))
    img = np.random.RandomState(0).randint(0, 256, (10, 12, 3)).astype(np.uint8)
    logger.image(5, "result", img)
    logger._tb.flush()
    events = EventAccumulator(str(tmp_path / "tb"))
    events.Reload()
    [event] = events.Images("result")
    assert (event.step, event.width, event.height) == (5, 12, 10)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(event.encoded_image_string))),
                                  img)
