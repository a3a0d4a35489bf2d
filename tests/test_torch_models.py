"""The port's models against the JAX package's on the CPU, on the same weights.

A flax model is initialised, its zero-init layers perturbed
(``_torch_parity.perturb``), its params carried over with
``pdae_torch.utils.convert`` and loaded with ``load_state_dict(strict=True)``.
Outputs agree at fp32 within rtol 1e-4 / atol 1e-5: the convolutions sum in
another order in the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, jnp_f32, nchw, nhwc, perturb
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.models import encoder_for_resolution as jax_encoder_for_resolution
from pdae_tpu.models.blocks import Downsample as JaxDownsample
from pdae_tpu.models.blocks import Upsample as JaxUpsample
from pdae_tpu.models.blocks import qkv_attention as jax_qkv_attention
from pdae_tpu.models.blocks import timestep_embedding as jax_timestep_embedding
from pdae_tpu.utils.torch_convert import (export_encoder_state_dict,
                                          export_unet_state_dict)
from pdae_torch.models import ShiftUNet, UNet, encoder_for_resolution
from pdae_torch.models.blocks import (Downsample, Upsample, qkv_attention,
                                      timestep_embedding)
from pdae_torch.utils import encoder_state_dict, unet_state_dict

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
LATENT = 16


def _assert_same_state_dict(got, want):
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def tiny_shift_unet():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([3, 700], np.int32)
    z = rs.randn(2, LATENT).astype(np.float32)
    model = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
    params = init_flax(model, jnp_f32(x), jnp.asarray(t), jnp_f32(z))
    return model, params, (x, t, z)


def test_shift_unet_converter_matches_export(tiny_shift_unet):
    _, params, _ = tiny_shift_unet
    _assert_same_state_dict(unet_state_dict(params), export_unet_state_dict(params))


def test_shift_unet_matches_jax(tiny_shift_unet):
    model, params, (x, t, z) = tiny_shift_unet
    want_eps, want_g = jax.jit(model.apply)({"params": params}, jnp_f32(x),
                                            jnp.asarray(t), jnp_f32(z))
    port = ShiftUNet(latent_dim=LATENT, **TINY_DPM).eval()
    port.load_state_dict(unet_state_dict(params), strict=True)
    with torch.no_grad():
        eps, g = port(nchw(x), torch.from_numpy(t), torch.from_numpy(z))
    assert np.abs(np.asarray(want_g)).max() > 1e-3      # the branch is live
    np.testing.assert_allclose(nhwc(eps), np.asarray(want_eps), **TOL)
    np.testing.assert_allclose(nhwc(g), np.asarray(want_g), **TOL)


def test_unet_matches_jax():
    cfg = dict(TINY_DPM, use_new_attention_order=True)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([0, 999], np.int32)
    model = JaxUNet(**cfg)
    params = init_flax(model, jnp_f32(x), jnp.asarray(t))
    want = jax.jit(model.apply)({"params": params}, jnp_f32(x), jnp.asarray(t))
    sd = unet_state_dict(params)
    _assert_same_state_dict(sd, export_unet_state_dict(params))
    port = UNet(**cfg).eval()
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(t))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [64, 128])
def test_encoder_matches_jax(size):
    rs = np.random.RandomState(size)
    batch = 2 if size == 64 else 1
    x = rs.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    model = jax_encoder_for_resolution(size, 512)
    params = init_flax(model, jnp_f32(x))
    sd = encoder_state_dict(params)
    _assert_same_state_dict(sd, export_encoder_state_dict(params, 4 if size == 64 else 5))
    want = jax.jit(model.apply)({"params": params}, jnp_f32(x))
    port = encoder_for_resolution(size, 512).eval()
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("new_order", [False, True])
def test_qkv_attention_head_orders(new_order):
    rs = np.random.RandomState(2)
    b, t, heads, ch = 2, 16, 4, 8
    qkv = rs.randn(b, t, 3 * heads * ch).astype(np.float32)      # JAX: [B, T, 3C]
    want = np.asarray(jax_qkv_attention(jnp.asarray(qkv), heads, new_order))
    got = qkv_attention(torch.from_numpy(qkv.transpose(0, 2, 1).copy()), heads,
                        new_order)                               # port: [B, 3C, T]
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 250, 999], np.int32)
    want = np.asarray(jax_timestep_embedding(jnp.asarray(t), dim))
    got = timestep_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("use_conv", [False, True])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_up_and_downsample_match_jax(kind, use_conv):
    x = np.random.RandomState(3).randn(2, 8, 8, 16).astype(np.float32)
    jax_cls, cls, name = {"up": (JaxUpsample, Upsample, "conv"),
                          "down": (JaxDownsample, Downsample, "op")}[kind]
    model = jax_cls(16, use_conv, out_channels=16)
    params = perturb(jax.device_get(
        model.init(jax.random.PRNGKey(0), jnp_f32(x)).get("params", {})), 4)
    want = model.apply({"params": params}, jnp_f32(x))
    port = cls(16, use_conv, out_channels=16)
    if use_conv:
        conv = getattr(port, name)
        conv.weight.data = torch.from_numpy(params[name]["kernel"].transpose(3, 2, 0, 1).copy())
        conv.bias.data = torch.from_numpy(params[name]["bias"])
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
