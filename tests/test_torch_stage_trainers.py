"""The port's regular, latent and manipulation trainers against ``pdae_tpu``'s,
across checkpoint files, on the CPU; their evals; ``python -m
pdae_torch.train`` on ``configs/mnist_regular.yml``; and the configs that
``chip_smoke.py`` trains on the card against the shipped ones.

``pdae_tpu`` writes each stage's checkpoint once for the module, as its own
tests train them: a class-conditional two-level UNet of 8 channels (SYNTHETIC
16px gray, 20 timesteps, b8, Adam), and the latent DPM (AdamW) and the
manipulation classifier (Adam) over the synthesized tiny PDAE of
``tests/test_stage34_sharded.py``, 2 steps each. Then, for each stage:

* the port resumes the JAX checkpoint: step, params, EMA, Adam moments and
  count equal the file's arrays bit for bit, and it steps on, finite;
* ``pdae_tpu`` resumes a port checkpoint of step 3: ``start_step`` 3, every
  leaf bit-equal to the file, and one more JAX step is finite.
"""

import copy
import gzip
import os
import struct

import flax.serialization as flax_ser
import jax
import numpy as np
import pytest
import torch

from _torch_parity import TRAINER_DPM, TRAINER_DS, TRAINER_OPT, TRAINER_RUNNER
from _torch_parity import assert_trees_bitwise, patch_tiny_encoders
from pdae_torch.training import (LatentDiffusionTrainer, ManipulationTrainer,
                                 RegularDiffusionTrainer)
from pdae_torch.utils import load_checkpoint as port_load
from pdae_tpu.utils import load_checkpoint as jax_load
from test_stage34_sharded import build_stage34_artifacts, latent_cfg, manip_cfg
from test_stage34_sharded import patch_tiny_encoders as patch_jax_tiny_encoders

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"regular": ("denoise_fn", "ema_denoise_fn", "optimizer"),
        "latent": ("latent_denoise_fn", "ema_latent_denoise_fn", "optimizer"),
        "manipulation": ("classifier", "ema_classifier", "optimizer")}
PORT = {"regular": RegularDiffusionTrainer, "latent": LatentDiffusionTrainer,
        "manipulation": ManipulationTrainer}


def regular_cfg():
    return {"train_dataset_config": dict(TRAINER_DS), "eval_dataset_config": {},
            "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
            "denoise_fn_config": {**TRAINER_DPM, "num_class": 10},
            "dataloader_config": {"train": {"num_workers": 1, "batch_size": 8},
                                  "eval": {"num_generations": 4}},
            "optimizer_config": dict(TRAINER_OPT), "runner_config": dict(TRAINER_RUNNER)}


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """(configs by stage, JAX checkpoints by stage)."""
    from pdae_tpu.training import LatentDiffusionTrainer as JaxLatent
    from pdae_tpu.training import ManipulationTrainer as JaxManipulation
    from pdae_tpu.training import RegularDiffusionTrainer as JaxRegular
    root = tmp_path_factory.mktemp("stages34")
    build_stage34_artifacts(root)
    configs = {"regular": regular_cfg(), "latent": latent_cfg(root),
               "manipulation": manip_cfg(root)}
    ckpts = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_tiny_encoders(mp)
        for name, cls in (("regular", JaxRegular), ("latent", JaxLatent),
                          ("manipulation", JaxManipulation)):
            run = str(root / f"jax_{name}")
            cls(config=configs[name], run_path=run).train(max_steps=2)
            ckpts[name] = os.path.join(run, "checkpoints", "latest.ckpt")
    return configs, ckpts


@pytest.mark.parametrize("stage", sorted(PORT))
def test_port_resumes_a_jax_checkpoint(stage, stages, tmp_path, monkeypatch):
    configs, ckpts = stages
    patch_tiny_encoders(monkeypatch)
    tr = PORT[stage](config=configs[stage], run_path=str(tmp_path / "run"),
                     resume=ckpts[stage], device="cpu")
    raw = jax_load(ckpts[stage])
    assert tr.start_step == tr.step == int(raw["step"]) == 2
    got = tr.state_dict()
    assert_trees_bitwise({k: got[k] for k in KEYS[stage]}, {k: raw[k] for k in KEYS[stage]})
    assert tr.train(max_steps=3) == 3
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())


@pytest.mark.parametrize("stage", sorted(PORT))
def test_jax_resumes_a_port_checkpoint(stage, stages, tmp_path, monkeypatch):
    from pdae_tpu import training as jax_training
    configs, _ = stages
    patch_tiny_encoders(monkeypatch)
    patch_jax_tiny_encoders(monkeypatch)
    port_run = str(tmp_path / "port")
    PORT[stage](config=configs[stage], run_path=port_run, device="cpu").train(max_steps=3)
    path = os.path.join(port_run, "checkpoints", "latest.ckpt")
    raw = port_load(path)
    assert int(raw["step"]) == 3
    jt = getattr(jax_training, PORT[stage].__name__)(
        config=configs[stage], run_path=str(tmp_path / "jax"), resume=path)
    assert jt.start_step == 3 and int(jt.state.step) == 3
    got = jax.tree_util.tree_map(np.asarray, flax_ser.to_state_dict(
        jax.device_get(jt.state_dict())))
    assert_trees_bitwise({k: got[k] for k in KEYS[stage]}, {k: raw[k] for k in KEYS[stage]})
    assert jt.train(max_steps=4) == 4
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(jt.state.params))


def _png_hw(path):
    with open(path, "rb") as f:
        head = f.read(24)
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def test_regular_eval_samples_each_class_from_the_ema(tmp_path):
    """The grid is a DDIM sample of the EMA weights (the live ones stay),
    one image per class in turn."""
    from pdae_torch.utils import to_uint8
    from pdae_torch.utils.image import make_grid
    from pdae_torch.utils.rng import EVAL, generator
    from PIL import Image
    tr = RegularDiffusionTrainer(config=regular_cfg(), run_path=str(tmp_path / "run"),
                                 device="cpu")
    tr.train(max_steps=2)
    live = copy.deepcopy(tr.state_dict())
    tr.evaluate(2, ddim_style="ddim4")
    assert_trees_bitwise(tr.state_dict(), live)
    model = copy.deepcopy(tr.model).eval()
    with torch.no_grad():
        named = dict(model.named_parameters())
        for k, v in tr.ema_weights().items():
            named[k].copy_(v)
        x_T = torch.randn((4, 1, 16, 16), generator=generator(0, EVAL, 2, "cpu"))
        imgs = tr.gd.regular_ddim_sample("ddim4", model, x_T, torch.arange(4) % 10)
    want = make_grid(to_uint8(imgs.permute(0, 2, 3, 1).numpy()))[..., 0]
    read = np.asarray(Image.open(tmp_path / "run" / "samples" / "step-2.png"))
    np.testing.assert_array_equal(read, want)


@pytest.mark.parametrize("stage", ["latent", "manipulation"])
def test_later_stage_evals_write_their_grids(stage, stages, tmp_path, monkeypatch):
    configs, _ = stages
    patch_tiny_encoders(monkeypatch)
    tr = PORT[stage](config=configs[stage], run_path=str(tmp_path / "run"), device="cpu")
    tr.train(max_steps=1, save_on_exit=False)
    live = copy.deepcopy(tr.state_dict())
    if stage == "latent":
        tr.evaluate(1, latent_ddim_style="ddim3", decoder_ddim_style="ddim3")
        n = configs[stage]["dataloader_config"]["eval"]["num_generations"]
        want = (2 + (16 + 2) * int(np.ceil(n / np.ceil(np.sqrt(n)))),
                2 + (16 + 2) * int(np.ceil(np.sqrt(n))))
    else:
        with pytest.raises(ValueError, match="class_id 31"):
            tr.evaluate(1)
        tr.evaluate(1, encode_style="ddim3", decode_style="ddim3", class_id=4)
        want = (2 + 16 + 2, 2 + 2 * (16 + 2))
    assert_trees_bitwise(tr.state_dict(), live)
    assert _png_hw(tmp_path / "run" / "samples" / "sample0k.png") == want


def _write_idx(root, prefix, n, seed, compress):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, 28, 28), np.uint8)
    labels = rs.randint(0, 10, (n,), np.uint8)
    suffix = ".gz" if compress else ""
    opener = gzip.open if compress else open
    os.makedirs(root, exist_ok=True)
    with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


def test_train_entry_point_runs_mnist_regular(tmp_path):
    """``python -m pdae_torch.train`` on the shipped ``configs/mnist_regular.yml``
    (uint8, device-resident, steps_per_dispatch 4) with its data path set to
    idx files written here; the batch is cut to 4 for this CPU. Then
    ``main`` resumes it in this process."""
    import subprocess
    import sys
    pytest.importorskip("yaml")
    data = str(tmp_path / "mnist")
    _write_idx(os.path.join(data, "MNIST", "raw"), "train", 12, 0, True)
    _write_idx(data, "t10k", 4, 1, False)
    config = os.path.join(ROOT, "configs", "mnist_regular.yml")
    run = str(tmp_path / "run")
    sets = ["--set", f"train_dataset_config.data_path={data}",
            "--set", "dataloader_config.train.batch_size=4"]
    out = subprocess.run([sys.executable, "-m", "pdae_torch.train", "--config_path", config,
                          "--run_path", run, "--device", "cpu", "--max_steps", "1", *sets],
                         cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "trainer: RegularDiffusionTrainer" in out.stdout
    assert "device-resident corpus: 12 items" in out.stdout
    from pdae_torch.train import main
    assert main(["--config_path", config, "--run_path", run, "--device", "cpu",
                 "--resume", "latest", "--max_steps", "2", *sets]) == 0
    raw = port_load(os.path.join(run, "checkpoints", "latest.ckpt"))
    assert int(raw["step"]) == 2 and sorted(raw) == sorted(KEYS["regular"] + ("step",))


def test_chip_smoke_stage_configs_are_the_shipped_ones():
    """``chip_smoke.py``'s stages phase trains config dicts of the shipped
    stage configs: the same models, optimizers, batches and data options,
    with SYNTHETIC data and the phase's files in place of the datasets and
    checkpoints, and a 6-step run's cadences."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    def shipped(name):
        with open(os.path.join(ROOT, "configs", name)) as f:
            return yaml.safe_load(f)

    files = {"celeba64": {k: k for k in ("config", "checkpoint", "stats", "dpm_config")},
             "celebahq128": {k: k + "128" for k in ("config", "checkpoint", "stats",
                                                    "dpm_config")}}
    got = chip_smoke.stage_configs(files)
    for stage, name in (("regular", "dpm_celeba64.yml"), ("latent", "celeba64_latent.yml"),
                        ("manipulation", "celebahq_manipulation.yml")):
        want, mine = shipped(name), got[stage]
        for key in ("denoise_fn_config", "latent_denoise_fn_config", "diffusion_config"):
            if key in want:
                assert {k: list(v) if isinstance(v, tuple) else v
                        for k, v in mine[key].items()} == want[key], (stage, key)
        opt = {k: v for k, v in want["optimizer_config"].items()}
        assert mine["optimizer_config"] == opt, stage
        assert (mine["dataloader_config"]["train"]["batch_size"]
                == want["dataloader_config"]["train"]["batch_size"])
        ds, ds_want = mine["train_dataset_config"], want["train_dataset_config"]
        for key in ("image_size", "image_channel", "augmentation", "transfer_uint8",
                    "device_resident", "latent_dim"):
            assert ds.get(key) == ds_want.get(key, ds.get(key)), (stage, key)
        assert ds["transfer_uint8"] and ds["device_resident"] and ds["name"] == "SYNTHETIC"
        runner = {k: v for k, v in want["runner_config"].items()
                  if k in ("num_iterations", "ema_every", "ema_decay")}
        assert {k: mine["runner_config"][k] for k in runner} == runner
    dpm128 = shipped("dpm_celebahq.yml")["denoise_fn_config"]
    assert {"model": "UNet", **{k: list(v) if isinstance(v, tuple) else v
                                for k, v in chip_smoke.CELEBAHQ_DPM.items()}} == dpm128
    assert got["latent"]["trained_representation_learning_checkpoint"] == "checkpoint"
    assert got["manipulation"]["inferred_latents"] == "stats128"
