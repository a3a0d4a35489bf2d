"""``python -m pdae_torch.headline_eval`` (the port of
``scripts/headline_eval.py``) on the CPU at 16px.

* ``synthetic_batch`` is byte-equal to the script's, with and without texture.
* The eval half against ``pdae_tpu``: the script's 16px encoder and ShiftUNet
  (``TINY_DPM``, latent 32) with perturbed weights, carried to the port's
  models of ``headline_eval.build``; the same textured batch through
  ``pdae_tpu``'s ``representation_learning_autoencoding`` and its SSIM/MSE,
  and through the port's ``autoencode`` and ``evaluate``. fp32: the
  reconstructions within ``RECON_ATOL`` (a few encode steps: the DDIM encode
  amplifies a difference step by step), SSIM within ``SSIM_ATOL`` and MSE
  within ``MSE_RTOL``. bf16: the port's reconstruction within 3x JAX's own
  bf16-against-fp32 gap in relative L2 (``tests/test_torch_dtype.py``'s
  rule; the gap itself under ``C_MAX``).
* ``main``: the JSON's keys, finite losses, the clamp of ``--eval_batch``,
  evaluation on the trained parameters (not the initial ones, not the EMA),
  the fast-eval trade exactly when both default pairs run, and no card
  without ``--device`` raises.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, nchw
from pdae_tpu.data.datasets import SYNTHETIC as JaxSYNTHETIC
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.metrics import MSEMetric as JaxMSEMetric
from pdae_tpu.metrics import SSIMMetric as JaxSSIMMetric
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_torch import headline_eval
from pdae_torch.data import SYNTHETIC
from pdae_torch.utils import encoder_state_dict, unet_state_dict

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
SIZE, LATENT, BATCH, TEXTURE = 16, 32, 4, 0.15
IDXS = np.arange(headline_eval.EVAL_START, headline_eval.EVAL_START + BATCH)
# fp32: one forward of either package differs by ~1e-6; the encode's
# predicted x_0 divides by sqrt(alpha_bar), down to 0.006 at t = 999, so a
# five-step encode carries that to a few 1e-4 on [-1, 1] images
RECON_ATOL = 2e-3
SSIM_ATOL = 2e-5
MSE_RTOL = 5e-5
# bf16: the same amplification makes JAX's own bf16-against-fp32 gap of a
# whole roundtrip 0.25-0.35 here (a single forward's stays under 5e-2,
# tests/test_torch_dtype.py), so the control is held under C_MAX
FACTOR, C_MAX = 3.0, 0.5
JSON_KEYS = {"size", "device", "dtype", "train_steps", "train_batch", "train_wall_s",
             "loss_first", "loss_last", "eval_batch", "eval_n", "texture", "styles"}
STYLE_KEYS = {"warm_wall_s", "peak_mb", "imgs_per_sec", "ssim", "mse"}


def _script():
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
    import headline_eval as script
    return script


def _datasets():
    cfg = {"image_size": SIZE, "image_channel": 3, "length": headline_eval.CORPUS}
    return JaxSYNTHETIC(cfg), SYNTHETIC(cfg)


@pytest.mark.parametrize("texture", [0.0, TEXTURE])
def test_synthetic_batch_is_the_scripts(texture):
    jax_ds, port_ds = _datasets()
    idxs = np.array([0, 7, 89999, 95000, 99999])
    want = _script().synthetic_batch(jax_ds, idxs, texture)
    got = headline_eval.synthetic_batch(port_ds, idxs, texture)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def carried():
    """The script's 16px models (zero-init layers perturbed) as flax params,
    and the textured eval batch of both packages' corpora (NHWC)."""
    x1 = jnp.zeros((1, SIZE, SIZE, 3))
    enc_params = init_flax(JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2),
                           x1, seed=61)
    dec_params = init_flax(JaxShiftUNet(latent_dim=LATENT, **TINY_DPM), x1,
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, LATENT)), seed=62)
    jax_ds, port_ds = _datasets()
    x = _script().synthetic_batch(jax_ds, IDXS, TEXTURE)
    return enc_params, dec_params, x, port_ds


def _jax_run(carried, pair, dtype):
    """The script's eval of one batch: (recon NHWC, ssim, mse)."""
    enc_params, dec_params, x, _ = carried
    encoder = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2, dtype=dtype)
    decoder = JaxShiftUNet(latent_dim=LATENT, dtype=dtype, **TINY_DPM)
    gd = JaxGaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    enc_style, dec_style = pair.split("+")
    fn = jax.jit(lambda ep, dp, xx: gd.representation_learning_autoencoding(
        enc_style, dec_style, lambda v: encoder.apply({"params": ep}, v),
        lambda v, t, z: decoder.apply({"params": dp}, v, t, z), xx))
    recon = np.asarray(fn(enc_params, dec_params, jnp.asarray(x)))
    ssim_m, mse_m = JaxSSIMMetric(), JaxMSEMetric()
    ssim_m.process((recon + 1.0) / 2.0, (x + 1.0) / 2.0)
    mse_m.process((recon + 1.0) / 2.0, (x + 1.0) / 2.0)
    return recon, ssim_m.compute_metrics(), mse_m.compute_metrics()


def _port_run(carried, pair, dtype):
    """The port's ``autoencode`` and ``evaluate`` of the same batch:
    (recon NHWC, the evaluate record)."""
    enc_params, dec_params, x, port_ds = carried
    gd, encoder, decoder = headline_eval.build(SIZE, dtype, torch.device("cpu"))
    encoder.load_state_dict(encoder_state_dict(enc_params), strict=True)
    decoder.load_state_dict(unet_state_dict(dec_params), strict=True)
    recon = headline_eval.autoencode(gd, pair, encoder.eval(), decoder.eval(), nchw(x))
    rec = headline_eval.evaluate(gd, pair, encoder, decoder, port_ds, IDXS, BATCH, 1,
                                 TEXTURE, torch.device("cpu"))
    return recon.permute(0, 2, 3, 1).numpy(), rec


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("pair", ["ddim5+ddim3", "dpm5+dpm5"])
def test_the_eval_half_matches_jax(pair, carried):
    want32, ssim32, mse32 = _jax_run(carried, pair, jnp.float32)
    got32, rec = _port_run(carried, pair, torch.float32)
    np.testing.assert_allclose(got32, want32, rtol=0, atol=RECON_ATOL)
    assert abs(rec["ssim"] - ssim32) <= SSIM_ATOL, (rec["ssim"], ssim32)
    np.testing.assert_allclose(rec["mse"], mse32, rtol=MSE_RTOL)
    assert 0.0 < rec["ssim"] <= 1.0 and rec["imgs_per_sec"] > 0 and rec["peak_mb"] is None

    want16, _, _ = _jax_run(carried, pair, jnp.bfloat16)
    got16, _ = _port_run(carried, pair, torch.bfloat16)
    control = _rel(want16, want32)
    assert 0.0 < control <= C_MAX, control
    assert _rel(got16, want16) <= FACTOR * control, (_rel(got16, want16), control)


def test_main_trains_then_evaluates_the_trained_parameters(monkeypatch):
    """Two steps, then both default pairs (the reference pattern and the fast
    one) on two images: every key of the JSON, finite losses, the clamp,
    and each evaluation on the trained parameters, which moved, and not on
    the EMA, which stayed near the start; the fast-eval trade is there. One
    pair alone gives no trade."""
    seen = {}
    real_train, real_evaluate = headline_eval.train, headline_eval.evaluate

    def train(gd, encoder, decoder, *args):
        seen["start"] = {k: v.detach().clone() for k, v in decoder.named_parameters()}
        out = real_train(gd, encoder, decoder, *args)
        seen["state"] = out["state"]
        return out

    def evaluate(gd, pair, encoder, decoder, *args):
        seen.setdefault("evaluated", []).append(
            {k: v.detach().clone() for k, v in decoder.named_parameters()})
        return real_evaluate(gd, pair, encoder, decoder, *args)

    monkeypatch.setattr(headline_eval, "train", train)
    monkeypatch.setattr(headline_eval, "evaluate", evaluate)
    out = headline_eval.main(["--size", "16", "--device", "cpu", "--dtype", "float32",
                              "--train_steps", "2", "--train_batch", "2", "--eval_n", "2",
                              "--reps", "1", "--texture", str(TEXTURE)])
    assert set(out) == JSON_KEYS | {"fast_eval_trade"}
    assert set(out["styles"]) == {headline_eval.BASE_PAIR, headline_eval.FAST_PAIR}
    assert all(set(r) == STYLE_KEYS for r in out["styles"].values())
    assert set(out["fast_eval_trade"]) == {"speedup", "ssim_delta", "mse_ratio"}
    assert out["fast_eval_trade"]["speedup"] > 1.0
    assert out["eval_batch"] == 2 and out["device"] == "cpu"
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    for r in out["styles"].values():
        assert 0.0 < r["ssim"] <= 1.0 and r["mse"] >= 0.0 and r["imgs_per_sec"] > 0

    shift = seen["state"].params["shift"]
    ema = seen["state"].ema_params["shift"]
    key = "shift_out.2.weight"
    assert len(seen["evaluated"]) == 2
    for params in seen["evaluated"]:
        assert all(torch.equal(params[k], p) for k, p in shift.items())
        assert not torch.equal(params[key], seen["start"][key])
        assert not torch.equal(params[key], ema[key])
        # two steps move the EMA by 1e-4 of the parameters' move, at most
        assert (ema[key] - seen["start"][key]).abs().max() < (
            1e-3 * (params[key] - seen["start"][key]).abs().max())

    one = headline_eval.main(["--size", "16", "--device", "cpu", "--dtype", "float32",
                              "--train_steps", "0", "--eval_batch", "16", "--eval_n", "2",
                              "--reps", "1", "--styles", "dpm3+dpm3"])
    assert set(one) == JSON_KEYS and one["eval_batch"] == 2
    assert one["loss_first"] is None and one["loss_last"] is None


def test_main_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        headline_eval.main(["--size", "16", "--train_steps", "0", "--eval_n", "1",
                            "--styles", "dpm3+dpm3"])
