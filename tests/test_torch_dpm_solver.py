"""The port's DPM-Solver++ against the JAX package's on the CPU.

The step tables are float64 numpy cast to float32 in both packages, so they
must be bitwise equal. The loops are held to the JAX ``lax.scan`` loops on the
same model and inputs: with a toy model within rtol/atol 1e-5 (only the order
of float32 ops differs), with the tiny ShiftUNet within 1e-4 (its convs sum
in another order, over 5 steps). Order 1 on the ``t`` grid is the DDIM
update, so it is held to the port's own DDIM loops within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (jnp_f32, tiny_shift_decoders, toy_eps_jax,
                           toy_eps_torch)
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.diffusion import dpm_solver as jax_dpm
from pdae_torch.diffusion import GaussianDiffusion, ddim, dpm_solver

torch.set_num_threads(1)
LATENT = 16
LINEAR = {"timesteps": 1000, "betas_type": "linear"}


def _assert_bitwise(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("betas_type", ["linear", "cosine"])
@pytest.mark.parametrize("direction", ["decode", "encode"])
@pytest.mark.parametrize("spacing", ["lambda", "t"])
@pytest.mark.parametrize("style", ["dpm5", "dpm10", "dpm20", "dpm50"])
def test_solver_tables_bitwise(style, spacing, direction, betas_type):
    config = {"timesteps": 1000, "betas_type": betas_type}
    got = GaussianDiffusion(config).solver_tables(style, spacing, direction)
    want = JaxGaussianDiffusion(config).solver_tables(style, spacing, direction)
    for name in want._fields:
        _assert_bitwise(getattr(got, name), getattr(want, name))
    assert got.num_steps == want.num_steps
    assert float(got.c2[0]) == 0.0 and float(got.c2[-1]) == 0.0


@pytest.mark.parametrize("style", ["dpm5", "dpm20"])
def test_latent_solver_tables_bitwise(style):
    got = GaussianDiffusion(LINEAR).latent_solver_tables(style)
    want = JaxGaussianDiffusion(LINEAR).latent_solver_tables(style)
    for name in want._fields:
        _assert_bitwise(getattr(got, name), getattr(want, name))


def test_style_and_argument_checks():
    assert dpm_solver.solver_steps_from_style("dpm20") == 20
    abar = GaussianDiffusion(LINEAR).schedule.alphas_cumprod.numpy()
    for bad in (dict(style="ddim20"), dict(style="dpm5", spacing="log"),
                dict(style="dpm5", direction="sideways")):
        with pytest.raises(ValueError):
            dpm_solver.make_solver_tables(abar, **bad)


# -- the loops with a toy model: the update equations alone ---------------- #

@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("direction", ["sample", "encode"])
def test_toy_solver_loops_match_jax(direction, order):
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32)
    grid = "decode" if direction == "sample" else "encode"
    jax_tables = JaxGaussianDiffusion(LINEAR).solver_tables("dpm10", direction=grid)
    tables = GaussianDiffusion(LINEAR).solver_tables("dpm10", direction=grid)
    jax_loop = {"sample": jax_dpm.dpm_solver_sample_loop,
                "encode": jax_dpm.dpm_solver_encode_loop}[direction]
    loop = {"sample": dpm_solver.dpm_solver_sample_loop,
            "encode": dpm_solver.dpm_solver_encode_loop}[direction]
    want = np.asarray(jax.jit(lambda a: jax_loop(jax_tables, toy_eps_jax, a,
                                                 order=order))(jnp_f32(x)))
    got = loop(tables, toy_eps_torch, torch.from_numpy(x), order=order).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", ["sample", "encode"])
def test_order1_on_the_t_grid_is_the_ddim_loop(direction):
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 8, 3).astype(np.float32))
    gd = GaussianDiffusion(LINEAR)
    dds = gd.ddim_schedule("ddim10")
    if direction == "sample":
        got = dpm_solver.dpm_solver_sample_loop(
            gd.solver_tables("dpm10", spacing="t"), toy_eps_torch, x, order=1)
        want = ddim.ddim_sample_loop(dds, toy_eps_torch, x)
    else:
        got = dpm_solver.dpm_solver_encode_loop(
            gd.solver_tables("dpm10", spacing="t", direction="encode"),
            toy_eps_torch, x, order=1)
        want = ddim.ddim_encode_loop(dds, toy_eps_torch, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_order2_differs_from_order1():
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 8, 8, 3).astype(np.float32))
    tables = GaussianDiffusion(LINEAR).solver_tables("dpm10")
    a = dpm_solver.dpm_solver_sample_loop(tables, toy_eps_torch, x, order=1)
    b = dpm_solver.dpm_solver_sample_loop(tables, toy_eps_torch, x, order=2)
    assert torch.isfinite(b).all() and not torch.equal(a, b)
    with pytest.raises(ValueError, match="order"):
        dpm_solver.dpm_solver_sample_loop(tables, toy_eps_torch, x, order=3)


# -- the shift loops through the tiny ShiftUNet ---------------------------- #

@pytest.fixture(scope="module")
def decoders():
    rs = np.random.RandomState(6)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rs.randn(2, LATENT).astype(np.float32)
    return (*tiny_shift_decoders(LATENT), x, z)


@pytest.mark.parametrize("stop_percent", [0.0, 0.3, 0.4])
def test_shift_solver_sample_matches_jax(decoders, stop_percent):
    jax_decoder, port_decoder, x_T, z = decoders
    jax_tables = JaxGaussianDiffusion(LINEAR).solver_tables("dpm5")
    tables = GaussianDiffusion(LINEAR).solver_tables("dpm5")
    want = np.asarray(jax.jit(lambda a, zz: jax_dpm.shift_dpm_solver_sample_loop(
        jax_tables, jax_decoder, zz, a, stop_percent=stop_percent))(jnp_f32(x_T),
                                                                    jnp_f32(z)))
    with torch.no_grad():
        got = dpm_solver.shift_dpm_solver_sample_loop(
            tables, port_decoder, torch.from_numpy(z), torch.from_numpy(x_T),
            stop_percent=stop_percent)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_shift_solver_encode_matches_jax(decoders):
    jax_decoder, port_decoder, x_0, z = decoders
    jax_tables = JaxGaussianDiffusion(LINEAR).solver_tables("dpm5", direction="encode")
    tables = GaussianDiffusion(LINEAR).solver_tables("dpm5", direction="encode")
    want = np.asarray(jax.jit(lambda a, zz: jax_dpm.shift_dpm_solver_encode_loop(
        jax_tables, jax_decoder, zz, a))(jnp_f32(x_0), jnp_f32(z)))
    with torch.no_grad():
        got = dpm_solver.shift_dpm_solver_encode_loop(
            tables, port_decoder, torch.from_numpy(z), torch.from_numpy(x_0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_stop_percent_one_leaves_every_step_unshifted(decoders):
    _, port_decoder, x_T, z = decoders
    tables = GaussianDiffusion(LINEAR).solver_tables("dpm5")
    with torch.no_grad():
        shifted = dpm_solver.shift_dpm_solver_sample_loop(
            tables, port_decoder, torch.from_numpy(z), torch.from_numpy(x_T), 1.0)
        plain = dpm_solver.dpm_solver_sample_loop(
            tables, lambda a, t, c: port_decoder(a, t, c)[0], torch.from_numpy(x_T),
            torch.from_numpy(z))
    assert torch.equal(shifted, plain)
