"""The port's representation-learning trainer against ``pdae_tpu``'s, across
checkpoint files, on the CPU.

A JAX stage-1 DPM (2 steps) and a JAX stage-2 PDAE (2 steps) are trained once
for the module, as ``tests/test_training_pipeline.py`` trains them: SYNTHETIC
16px gray, a two-level UNet of 8 channels, a two-stage encoder of 8 and 16
channels, 20 timesteps, b8. Then:

* the port grafts the JAX DPM: its trunk equals ``ema_denoise_fn``;
* the port resumes the JAX PDAE checkpoint: step, params, EMA, Adam moments
  and count and the trunk equal the file's arrays bit for bit, and it steps on;
* ``pdae_tpu`` resumes a port checkpoint of step 3: ``start_step`` 3, every
  leaf bit-equal to the file, and one more JAX step is finite.
"""

import os

import flax.serialization as flax_ser
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_bitwise, patch_tiny_encoders, tiny_pdae_config)
from pdae_torch.training import RepresentationLearningTrainer
from pdae_torch.training.partition import split_shift_tree
from pdae_torch.utils import load_checkpoint as port_load, unet_tree
from pdae_tpu.utils import load_checkpoint as jax_load

torch.set_num_threads(1)
KEYS = ("encoder", "ema_encoder", "decoder", "ema_decoder", "optimizer")


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """(root, stage-1 checkpoint, stage-2 checkpoint) written by pdae_tpu."""
    from _torch_parity import TRAINER_DPM, TRAINER_DS, TRAINER_OPT, TRAINER_RUNNER
    from pdae_tpu.training import RegularDiffusionTrainer
    from pdae_tpu.training import RepresentationLearningTrainer as JaxTrainer
    root = tmp_path_factory.mktemp("stages")
    dpm_run = str(root / "dpm")
    RegularDiffusionTrainer(config={
        "train_dataset_config": TRAINER_DS, "eval_dataset_config": {},
        "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
        "denoise_fn_config": TRAINER_DPM,
        "dataloader_config": {"train": {"num_workers": 1, "batch_size": 8},
                              "eval": {"num_generations": 4}},
        "optimizer_config": TRAINER_OPT, "runner_config": TRAINER_RUNNER,
    }, run_path=dpm_run).train(max_steps=2)
    dpm_ckpt = os.path.join(dpm_run, "checkpoints", "latest.ckpt")
    pdae_run = str(root / "pdae")
    with pytest.MonkeyPatch.context() as mp:
        patch_tiny_encoders(mp, jax_too=True)
        JaxTrainer(config=tiny_pdae_config(dpm_ckpt), run_path=pdae_run).train(max_steps=2)
    return root, dpm_ckpt, os.path.join(pdae_run, "checkpoints", "latest.ckpt")


def test_port_grafts_the_jax_dpm(stages, tmp_path, monkeypatch):
    _, dpm_ckpt, _ = stages
    patch_tiny_encoders(monkeypatch)
    tr = RepresentationLearningTrainer(config=tiny_pdae_config(dpm_ckpt),
                                       run_path=str(tmp_path / "run"), device="cpu")
    dpm = jax_load(dpm_ckpt)["ema_denoise_fn"]
    shift, trunk = split_shift_tree(unet_tree(tr.decoder.state_dict()))
    assert sorted(trunk) == sorted(k for k in dpm if k != "label_emb")
    assert_trees_bitwise(trunk, {k: dpm[k] for k in trunk})
    assert_trees_bitwise(tr._trunk_tree, trunk)
    assert shift and "label_emb" in shift


def test_port_resumes_a_jax_checkpoint(stages, tmp_path, monkeypatch):
    _, dpm_ckpt, pdae_ckpt = stages
    patch_tiny_encoders(monkeypatch)
    tr = RepresentationLearningTrainer(config=tiny_pdae_config(dpm_ckpt),
                                       run_path=str(tmp_path / "run"), resume=pdae_ckpt,
                                       device="cpu")
    raw = jax_load(pdae_ckpt)
    assert tr.start_step == tr.step == int(raw["step"]) == 2
    got = tr.state_dict()
    assert_trees_bitwise({k: got[k] for k in KEYS}, {k: raw[k] for k in KEYS})
    assert int(raw["optimizer"]["0"]["count"]) == 2
    # the modules hold the file's trunk, and train on from it
    assert_trees_bitwise(split_shift_tree(unet_tree(tr.decoder.state_dict()))[1],
                         split_shift_tree(raw["decoder"])[1])
    assert tr.train(max_steps=3) == 3
    assert all(torch.isfinite(p).all() for p in tr.encoder.parameters())


def test_jax_resumes_a_port_checkpoint(stages, tmp_path, monkeypatch):
    from pdae_tpu.training import RepresentationLearningTrainer as JaxTrainer
    root, dpm_ckpt, _ = stages
    patch_tiny_encoders(monkeypatch, jax_too=True)
    cfg = tiny_pdae_config(dpm_ckpt)
    port_run = str(tmp_path / "port")
    RepresentationLearningTrainer(config=cfg, run_path=port_run, device="cpu").train(
        max_steps=3)
    path = os.path.join(port_run, "checkpoints", "latest.ckpt")
    raw = port_load(path)
    assert int(raw["step"]) == 3
    jt = JaxTrainer(config=cfg, run_path=str(tmp_path / "jax"), resume=path)
    assert jt.start_step == 3 and int(jt.state.step) == 3
    got = jax.tree_util.tree_map(np.asarray, flax_ser.to_state_dict(
        jax.device_get(jt.state_dict())))
    assert_trees_bitwise({k: got[k] for k in KEYS}, {k: raw[k] for k in KEYS})
    assert jt.train(max_steps=4) == 4
    assert int(jt.state.step) == 4
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(jt.state.params))
