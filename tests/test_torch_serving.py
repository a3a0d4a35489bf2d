"""The port's ``PDAEService`` against the JAX package's autoencoding on the CPU,
and the rules the port keeps: NHWC in and out, power-of-two buckets, no
silent CPU fallback, no JAX anywhere in ``pdae_torch`` or ``chip_smoke.py``.

The stack is the tiny ShiftUNet (``TINY_DPM``) at 64px with the full-width
64px encoder, on perturbed flax weights carried over by
``pdae_torch.utils.convert``. The convs sum in another order in the two
frameworks, and the DDIM encode amplifies that: reconstructions agree with
JAX's within 1e-2 in [-1, 1] floats (mean under 2e-4), and so at most one
uint8 level apart.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, jnp_f32
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import encoder_for_resolution as jax_encoder_for_resolution
from pdae_tpu.utils.image import from_uint8 as jax_from_uint8
from pdae_tpu.utils.image import to_uint8 as jax_to_uint8
from pdae_torch import serving
from pdae_torch.serving import PDAEService
from pdae_torch.utils import (encoder_state_dict, from_uint8, to_uint8,
                              unet_state_dict)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT, SIZE = 16, 64
CONFIG = {
    "trained_ddpm_config": TINY_DPM,
    "decoder_config": {"latent_dim": LATENT},
    "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
    "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
    "image_size": SIZE, "max_batch": 4,
    "encoder_ddim_style": "ddim5", "decoder_ddim_style": "ddim5",
}


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, SIZE, SIZE, 3), np.uint8)


@pytest.fixture(scope="module")
def stack():
    x = jnp.zeros((1, SIZE, SIZE, 3))
    encoder = jax_encoder_for_resolution(SIZE, LATENT)
    decoder = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
    enc_params = init_flax(encoder, x, seed=0)
    dec_params = init_flax(decoder, x, jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, LATENT)), seed=1)
    service = PDAEService(CONFIG, encoder_state_dict(enc_params),
                          unet_state_dict(dec_params), device="cpu")
    return encoder, decoder, enc_params, dec_params, service


def test_autoencode_matches_jax(stack):
    encoder, decoder, enc_params, dec_params, service = stack
    images = _images(3)
    gd = JaxGaussianDiffusion(CONFIG["diffusion_config"])
    autoencode = jax.jit(lambda x: gd.representation_learning_autoencoding(
        "ddim5", "ddim5", lambda xx: encoder.apply({"params": enc_params}, xx),
        lambda xx, tt, zz: decoder.apply({"params": dec_params}, xx, tt, zz), x))
    want = np.asarray(autoencode(jnp_f32(images.astype(np.float32) / 255.0 * 2.0 - 1.0)))

    x, n = service._to_model_input(images)
    with torch.no_grad():
        got = service.gd.representation_learning_autoencoding(
            "ddim5", "ddim5", service.encoder, service.decoder, x)
    got = service._to_nhwc(got, n)
    # the DDIM encode multiplies a model difference by up to
    # sqrt(1 / abar_t) ~ 158 at t = 999 before the x_0 clamp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert np.abs(got - want).mean() < 2e-4

    recon = service.autoencode(images)
    assert recon.shape == images.shape and recon.dtype == np.uint8
    assert np.abs(recon.astype(int) - jax_to_uint8(want).astype(int)).max() <= 1


def test_encode_matches_jax(stack):
    encoder, _, enc_params, _, service = stack
    images = _images(2, seed=1)
    want = np.asarray(encoder.apply({"params": enc_params}, jnp_f32(
        images.astype(np.float32) / 255.0 * 2.0 - 1.0)))
    np.testing.assert_allclose(service.encode(images), want, rtol=1e-4, atol=1e-5)


def test_bucket_padding_and_trimming(stack):
    service = stack[-1]
    assert [serving._bucket(n, 4) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    assert serving._bucket(5, 64) == 8
    images = _images(3, seed=2)
    x, n = service._to_model_input(images)
    assert (n, tuple(x.shape)) == (3, (4, 3, SIZE, SIZE))
    torch.testing.assert_close(x[3], x[0])              # padded with the first image
    z = service.encode(images)
    assert z.shape == (3, LATENT)
    np.testing.assert_allclose(service.encode(images[1:2])[0], z[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="max_batch"):
        service.encode(_images(5))
    with pytest.raises(ValueError, match="empty"):
        service.encode(_images(0))


def test_decode_trims_and_takes_latents(stack):
    service = stack[-1]
    z = np.random.RandomState(3).randn(3, LATENT).astype(np.float32)
    x_T = np.random.RandomState(4).randn(3, SIZE, SIZE, 3).astype(np.float32)
    out = service.decode(z, x_T)
    assert out.shape == (3, SIZE, SIZE, 3) and out.dtype == np.uint8
    with pytest.raises(ValueError, match="latents"):
        service.decode(z[:2], x_T)


def test_service_states_tf32_off(stack):
    service = stack[-1]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    PDAEService(CONFIG, service.encoder.state_dict(), service.decoder.state_dict(),
                device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_no_card_and_no_device_raises(stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    service = stack[-1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PDAEService(CONFIG, service.encoder.state_dict(), service.decoder.state_dict())


def test_uint8_conversions_match_jax():
    rs = np.random.RandomState(5)
    x = rs.uniform(-1.2, 1.2, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(x), jax_to_uint8(x))
    u = rs.randint(0, 256, (2, 4, 4, 3), np.uint8)
    np.testing.assert_array_equal(from_uint8(u), jax_from_uint8(u))


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pdae_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "pdae_tpu")
    files = _port_sources()
    assert len(files) > 10 and os.path.exists(files[0])
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"
