"""The device-resident corpus and the uint8 transfer of the port
(``pdae_torch/training/resident.py``, ``utils.image.x0_from_transfer``) on the
CPU, against ``pdae_tpu`` where the JAX package defines the result:

* ``x0_from_transfer`` is bit-equal to the host's float normalisation;
* ``epoch_global_indices`` is ``pdae_tpu``'s table and the port loader's
  ``idx``; ``materialize_step_arrays`` is ``pdae_tpu``'s arrays;
* ``sample_batch`` gathers the rows asked for and flips by its coins;
* a resident ``epoch`` run without augmentation trains bit for bit like the
  host-loader run; a resident run resumed at a step off the epoch and off
  the save cadence equals the uninterrupted run, in both sampling modes;
* ``latent_train_source: precomputed`` gives the ``encode`` run's losses
  and weights (rtol 1e-5 / atol 1e-6: the encoder sees chunks of 512 instead
  of batches of 8), and is refused without ``device_resident`` or with
  augmentation; ``encode_corpus`` handles a ragged tail;
* a sampler refuses a ``transfer_uint8`` dataset.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import TRAINER_DPM, assert_trees_bitwise, patch_tiny_encoders
from pdae_torch.data import Loader, build_dataset
from pdae_torch.training import (LatentDiffusionTrainer, ManipulationTrainer,
                                 RegularDiffusionTrainer)
from pdae_torch.training.resident import (encode_corpus, epoch_global_indices,
                                          materialize_step_arrays, sample_batch)
from pdae_torch.utils.image import x0_from_transfer
from test_stage34_sharded import build_stage34_artifacts, latent_cfg, manip_cfg

torch.set_num_threads(1)


def _losses(run, key="prediction_loss"):
    with open(os.path.join(str(run), "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f)]


def regular_cfg(length=24, **dataset):
    """The tiny regular DPM on SYNTHETIC 16px gray uint8, 3 batches of 8 an
    epoch, resident."""
    return {"train_dataset_config": {"name": "SYNTHETIC", "image_size": 16,
                                     "image_channel": 1, "length": length,
                                     "transfer_uint8": True, "device_resident": True,
                                     **dataset},
            "eval_dataset_config": {},
            "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
            "denoise_fn_config": dict(TRAINER_DPM),
            "dataloader_config": {"train": {"num_workers": 1, "batch_size": 8},
                                  "eval": {"num_generations": 2}},
            "optimizer_config": {"lr": 1e-3, "adam_betas": "(0.9, 0.999)"},
            "runner_config": {"display_steps": 1, "evaluate_every_steps": 100000,
                              "save_latest_every_steps": 2,
                              "save_checkpoint_every_steps": 100000,
                              "ema_decay": 0.9}}


def test_x0_from_transfer_is_the_host_normalisation():
    from pdae_torch.data.datasets import _finalize
    from pdae_tpu.data.datasets import _finalize as jax_finalize
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    image = np.random.RandomState(0).randint(0, 256, (9, 7, 3)).astype(np.uint8)
    for pixels in (every, image):
        host, _ = _finalize(pixels, None, False)
        raw, gt = _finalize(pixels, None, False, as_uint8=True)
        assert raw.dtype == np.uint8 and np.array_equal(raw, gt)
        np.testing.assert_array_equal(jax_finalize(pixels, None, False)[0], host)
        got = x0_from_transfer(torch.from_numpy(raw))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), host)
    f = torch.randn(3, 4)
    assert x0_from_transfer(f) is f


@pytest.mark.parametrize("world", [1, 3])
def test_epoch_indices_match_jax_and_the_loader(world):
    from pdae_tpu.data.pipeline import Loader as JaxLoader
    from pdae_tpu.training.resident import epoch_global_indices as jax_indices
    ds = build_dataset({"name": "SYNTHETIC", "image_size": 8, "length": 23})
    port = Loader(ds, batch_size=2, seed=5, num_workers=1, process_count=world,
                  process_index=0)
    ref = JaxLoader(ds, batch_size=2, seed=5, num_workers=1, process_count=world,
                    process_index=0)
    for epoch in range(3):
        table = epoch_global_indices(port, epoch)
        assert table.dtype == np.int32
        np.testing.assert_array_equal(table, jax_indices(ref, epoch))
        if world == 1:
            np.testing.assert_array_equal(
                table, np.stack([b["idx"] for b in port.epoch(epoch)]))


def test_materialize_matches_jax():
    from pdae_tpu.data import build_dataset as jax_build
    from pdae_tpu.training.resident import materialize_step_arrays as jax_materialize
    cfg = {"name": "SYNTHETIC", "image_size": 16, "length": 5, "multilabel": 4,
           "transfer_uint8": True}
    keys = ("x_0", "label")
    got = materialize_step_arrays(build_dataset(cfg), keys, chunk=2)
    want = jax_materialize(jax_build(cfg), keys, chunk=2)
    assert sorted(got) == sorted(keys)
    for k in keys:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_sample_batch_gathers_and_flips():
    x = torch.arange(6 * 2 * 3 * 4, dtype=torch.float32).reshape(6, 2, 3, 4)
    data = {"x_0": x, "label": torch.arange(6)}
    idx = torch.tensor([4, 0, 4, 2])
    out = sample_batch(data, torch.Generator().manual_seed(0), 4, 6, indices=idx)
    assert torch.equal(out["x_0"], x[idx]) and torch.equal(out["label"], idx)
    flipped = sample_batch(data, torch.Generator().manual_seed(1), 4, 6, flip=True,
                           indices=idx)
    coin = torch.rand(4, generator=torch.Generator().manual_seed(1)) < 0.5
    assert 0 < int(coin.sum()) < 4
    for row, c in enumerate(coin):
        want = x[idx[row]].flip(2) if c else x[idx[row]]
        assert torch.equal(flipped["x_0"][row], want)
    assert torch.equal(flipped["label"], idx)
    drawn = sample_batch(data, torch.Generator().manual_seed(2), 5, 6)
    again = sample_batch(data, torch.Generator().manual_seed(2), 5, 6)
    assert torch.equal(drawn["label"], again["label"])
    assert drawn["label"].min() >= 0 and drawn["label"].max() < 6
    assert torch.equal(drawn["x_0"], x[drawn["label"]])


def test_resident_epoch_trains_like_the_host_loader(tmp_path):
    """4 steps over 3 batches an epoch: the same losses and the same state,
    bit for bit, as the run whose batches come from the host loader."""
    resident = RegularDiffusionTrainer(config=regular_cfg(), run_path=str(tmp_path / "r"),
                                       device="cpu")
    host_cfg = regular_cfg(device_resident=False)
    host = RegularDiffusionTrainer(config=host_cfg, run_path=str(tmp_path / "h"),
                                   device="cpu")
    batch = next(resident._batch_iterator(1))
    assert batch["x_0"].dtype == torch.uint8 and batch["x_0"].shape == (8, 1, 16, 16)
    assert torch.equal(batch["x_0"], next(host._batch_iterator(1))["x_0"])
    resident.train(max_steps=4)
    host.train(max_steps=4)
    assert _losses(tmp_path / "r") == _losses(tmp_path / "h")
    assert_trees_bitwise(resident.state_dict(), host.state_dict())


@pytest.mark.parametrize("sampling", ["epoch", "uniform"])
def test_resident_resume_off_the_cadence_equals_the_straight_run(sampling, tmp_path):
    """5 straight steps against 3 (a save at 2, the final one at 3), a resume
    from step 3 and 2 more: step 3 is off the save cadence and inside an
    epoch; the device flip is on, so its coins count too."""
    cfg = regular_cfg(resident_sampling=sampling)
    runs = {}
    for name in ("a", "b"):
        tr = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / name),
                                     device="cpu")
        tr.train_dataset.augmentation = True      # SYNTHETIC has no host flip
        runs[name] = tr
    runs["a"].train(max_steps=5)
    assert runs["b"].train(max_steps=3) == 3
    resumed = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / "b"),
                                      resume="latest", device="cpu")
    resumed.train_dataset.augmentation = True
    assert resumed.start_step == 3
    assert resumed.train(max_steps=5) == 5
    assert_trees_bitwise(resumed.state_dict(), runs["a"].state_dict())
    assert _losses(tmp_path / "b") == _losses(tmp_path / "a")


def test_resident_sampling_is_epoch_or_uniform(tmp_path):
    with pytest.raises(ValueError, match="resident_sampling must be 'epoch' or 'uniform'"):
        RegularDiffusionTrainer(config=regular_cfg(resident_sampling="shuffle"),
                                run_path=str(tmp_path / "r"), device="cpu")


@pytest.fixture(scope="module")
def stage34(tmp_path_factory):
    root = tmp_path_factory.mktemp("resident34")
    build_stage34_artifacts(root)
    return root


def _later_stage_cfg(stage, root, source):
    cfg = (latent_cfg if stage == "latent" else manip_cfg)(
        root, extra={"latent_train_source": source, "display_steps": 1})
    cfg["train_dataset_config"].update(device_resident=True, transfer_uint8=True)
    return cfg


@pytest.mark.parametrize("stage", ["latent", "manipulation"])
def test_precomputed_equals_encode(stage, stage34, tmp_path, monkeypatch):
    patch_tiny_encoders(monkeypatch)
    cls = LatentDiffusionTrainer if stage == "latent" else ManipulationTrainer
    key = "prediction_loss" if stage == "latent" else "bce_loss"
    runs = {}
    for source in ("encode", "precomputed"):
        tr = cls(config=_later_stage_cfg(stage, stage34, source),
                 run_path=str(tmp_path / source), device="cpu")
        tr.train(max_steps=3, save_on_exit=False)
        runs[source] = tr
    z = runs["precomputed"]._resident_device_data()["x_0"]
    assert z.shape == (32, 16) and z.dtype == torch.float32
    np.testing.assert_allclose(_losses(tmp_path / "precomputed", key),
                               _losses(tmp_path / "encode", key), rtol=1e-5)
    for k, v in runs["encode"].state.params["model"].items():
        torch.testing.assert_close(runs["precomputed"].state.params["model"][k], v,
                                   rtol=1e-5, atol=1e-6)


def test_precomputed_needs_a_resident_corpus_without_augmentation(stage34, tmp_path,
                                                                  monkeypatch):
    patch_tiny_encoders(monkeypatch)
    cfg = _later_stage_cfg("latent", stage34, "precomputed")
    cfg["train_dataset_config"]["device_resident"] = False
    with pytest.raises(ValueError, match="requires train_dataset_config.device_resident"):
        LatentDiffusionTrainer(config=cfg, run_path=str(tmp_path / "a"), device="cpu")
    cfg = _later_stage_cfg("manipulation", stage34, "precomputed")
    cfg["train_dataset_config"].update(name="CELEBAHQ", data_path=str(tmp_path),
                                       augmentation=True, require_annotations=False)
    with pytest.raises(ValueError, match="requires augmentation: false"):
        ManipulationTrainer(config=cfg, run_path=str(tmp_path / "b"), device="cpu")
    cfg = _later_stage_cfg("latent", stage34, "cached")
    with pytest.raises(ValueError, match="'encode' or 'precomputed', got 'cached'"):
        LatentDiffusionTrainer(config=cfg, run_path=str(tmp_path / "c"), device="cpu")


def test_encode_corpus_pads_and_drops_a_ragged_tail():
    from pdae_torch.models import SemanticEncoder
    torch.manual_seed(0)
    encoder = SemanticEncoder(16, channels=(8, 16), attn_after_stage=2, image_size=16,
                              input_channel=1).eval()
    calls = []
    encoder.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))
    pixels = np.random.RandomState(1).randint(0, 256, (7, 16, 16, 1)).astype(np.uint8)
    z = encode_corpus(encoder, pixels, "cpu", chunk=4)
    assert calls == [4, 4] and z.shape == (7, 16)
    with torch.no_grad():
        want = encoder(x0_from_transfer(torch.from_numpy(pixels).permute(0, 3, 1, 2)))
    torch.testing.assert_close(z, want, rtol=1e-5, atol=1e-6)


def test_samplers_refuse_a_uint8_dataset():
    """A sampler reads x_0 as float [-1, 1] (SSIM, MSE, the encoder), so its
    dataset may not be ``transfer_uint8``, whatever the dataset builder
    accepts for the trainers."""
    from pdae_torch.sampling import SamplerContext
    ctx = SamplerContext({"dataset_config": {"name": "SYNTHETIC", "image_size": 16,
                                             "transfer_uint8": True}}, device="cpu")
    with pytest.raises(ValueError, match="transfer_uint8 is a training option"):
        ctx.dataset()
    ctx.config["dataset_config"]["transfer_uint8"] = False
    assert ctx.dataset()[0]["x_0"].dtype == np.float32
