"""The port's diffusion math against the JAX package's on the CPU.

Schedule tables are float64 numpy cast to float32 in both packages, so they
must be bitwise equal. The DDIM loops are held to the JAX ``lax.scan`` loops
on the same model and inputs: with a toy model at rtol/atol 1e-5 (only the
order of float32 ops differs), with the tiny ShiftUNet at atol 1e-4 (the
model's convs sum in another order, over 5 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, jnp_f32
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.diffusion import ddim as jax_ddim
from pdae_tpu.diffusion import schedules as jax_schedules
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_torch.diffusion import GaussianDiffusion, ddim, schedules
from pdae_torch.models import ShiftUNet
from pdae_torch.utils import unet_state_dict

torch.set_num_threads(1)
LATENT = 16


def _assert_bitwise(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("betas_type", ["linear", "cosine"])
def test_schedule_tables_bitwise(betas_type):
    got = schedules.make_schedule(betas_type, 1000)
    want = jax_schedules.make_schedule(betas_type, 1000)
    for name in want._fields:
        _assert_bitwise(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("style", ["ddim5", "ddim100", "ddim1000"])
@pytest.mark.parametrize("betas_type", ["linear", "cosine"])
def test_ddim_tables_bitwise(style, betas_type):
    got = GaussianDiffusion({"timesteps": 1000, "betas_type": betas_type}).ddim_schedule(style)
    want = JaxGaussianDiffusion({"timesteps": 1000,
                                 "betas_type": betas_type}).ddim_schedule(style)
    for name in want._fields:
        _assert_bitwise(getattr(got, name), getattr(want, name))
    assert got.num_steps == want.num_steps


def test_extract_broadcasts():
    table = torch.arange(10, dtype=torch.float32)
    out = schedules.extract(table, torch.tensor([1, 7]), 4)
    assert out.shape == (2, 1, 1, 1) and out.flatten().tolist() == [1.0, 7.0]


def test_dpm_styles_name_their_roadmap_item():
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gd.representation_learning_ddim_sample("dpm20", None, None, None,
                                               torch.zeros(1, 3, 4, 4), torch.zeros(1, 2))


# -- loops with a toy model (no weights): the update equations alone ------- #

def _toy_jax(x, t, condition=None):
    tt = (t.astype(jnp.float32) / 1000.0).reshape((-1,) + (1,) * (x.ndim - 1))
    return 0.3 * jnp.tanh(x) + 0.1 * jnp.sin(3.0 * x) * tt


def _toy_torch(x, t, condition=None):
    tt = (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))
    return 0.3 * torch.tanh(x) + 0.1 * torch.sin(3.0 * x) * tt


@pytest.mark.parametrize("direction", ["sample", "encode"])
def test_plain_ddim_loops_match_jax(direction):
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32)
    jax_dds = JaxGaussianDiffusion({"timesteps": 1000,
                                    "betas_type": "linear"}).ddim_schedule("ddim10")
    dds = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"}).ddim_schedule("ddim10")
    jax_loop = {"sample": jax_ddim.ddim_sample_loop,
                "encode": jax_ddim.ddim_encode_loop}[direction]
    loop = {"sample": ddim.ddim_sample_loop, "encode": ddim.ddim_encode_loop}[direction]
    want = np.asarray(jax.jit(lambda a: jax_loop(jax_dds, _toy_jax, a))(jnp_f32(x)))
    got = loop(dds, _toy_torch, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- shift-DDIM trajectories through the tiny ShiftUNet -------------------- #

@pytest.fixture(scope="module")
def tiny_pair():
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rs.randn(2, LATENT).astype(np.float32)
    model = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
    params = init_flax(model, jnp_f32(x), jnp.zeros((2,), jnp.int32), jnp_f32(z), seed=5)
    port = ShiftUNet(latent_dim=LATENT, **TINY_DPM).eval()
    port.load_state_dict(unet_state_dict(params), strict=True)

    def jax_decoder(xx, tt, zz):
        return model.apply({"params": params}, xx, tt, zz)

    def port_decoder(xx, tt, zz):     # NHWC in and out, as the JAX loop sees it
        eps, g = port(xx.permute(0, 3, 1, 2), tt, zz)
        return eps.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1)

    return jax_decoder, port_decoder, x, z


@pytest.mark.parametrize("stop_percent", [0.0, 0.4])
def test_shift_ddim_sample_trajectory(tiny_pair, stop_percent):
    jax_decoder, port_decoder, x_T, z = tiny_pair
    jax_dds = JaxGaussianDiffusion({"timesteps": 1000,
                                    "betas_type": "linear"}).ddim_schedule("ddim5")
    dds = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"}).ddim_schedule("ddim5")
    want = np.asarray(jax.jit(lambda a, zz: jax_ddim.shift_ddim_sample_loop(
        jax_dds, jax_decoder, zz, a, stop_percent=stop_percent))(jnp_f32(x_T), jnp_f32(z)))
    with torch.no_grad():
        got = ddim.shift_ddim_sample_loop(dds, port_decoder, torch.from_numpy(z),
                                          torch.from_numpy(x_T), stop_percent)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_shift_ddim_encode_trajectory(tiny_pair):
    jax_decoder, port_decoder, x_0, z = tiny_pair
    jax_dds = JaxGaussianDiffusion({"timesteps": 1000,
                                    "betas_type": "linear"}).ddim_schedule("ddim5")
    dds = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"}).ddim_schedule("ddim5")
    want = np.asarray(jax.jit(lambda a, zz: jax_ddim.shift_ddim_encode_loop(
        jax_dds, jax_decoder, zz, a))(jnp_f32(x_0), jnp_f32(z)))
    with torch.no_grad():
        got = ddim.shift_ddim_encode_loop(dds, port_decoder, torch.from_numpy(z),
                                          torch.from_numpy(x_0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_stop_percent_gates_the_shift(tiny_pair):
    """With stop_percent = 1 no step is shifted: the shift loop equals the
    plain DDIM loop over epsilon alone."""
    _, port_decoder, x_T, z = tiny_pair
    dds = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"}).ddim_schedule("ddim5")
    with torch.no_grad():
        shifted = ddim.shift_ddim_sample_loop(dds, port_decoder, torch.from_numpy(z),
                                              torch.from_numpy(x_T), 1.0)
        plain = ddim.ddim_sample_loop(dds, lambda a, t, c: port_decoder(a, t, c)[0],
                                      torch.from_numpy(x_T), torch.from_numpy(z))
    assert torch.equal(shifted, plain)
