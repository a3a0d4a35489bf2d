"""The port's diffusion math against the JAX package's on the CPU.

Schedule tables are float64 numpy cast to float32 in both packages, so they
must be bitwise equal. The DDIM loops are held to the JAX ``lax.scan`` loops
on the same model and inputs: with a toy model at rtol/atol 1e-5 (only the
order of float32 ops differs), with the tiny ShiftUNet at atol 1e-4 (the
model's convs sum in another order, over 5 steps). So are the trajectory
interpolation, the single ancestral steps (rtol 1e-5 / atol 1e-6), the
ancestral loops, the gap measure and the one-step denoise, each with its
noise injected (a 20-step schedule keeps the full-T loops short).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jnp_f32, tiny_shift_decoders, toy_eps_jax, toy_eps_torch
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.diffusion import ddim as jax_ddim
from pdae_tpu.diffusion import schedules as jax_schedules
from pdae_torch.diffusion import GaussianDiffusion, ddim, dpm_solver, schedules

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


@pytest.mark.parametrize("style,loops", [
    ("ddim5", ("ddim_sample_loop", "ddim_encode_loop", "shift_ddim_sample_loop",
               "shift_ddim_encode_loop")),
    ("dpm5", ("dpm_solver_sample_loop", "dpm_solver_encode_loop",
              "shift_dpm_solver_sample_loop", "shift_dpm_solver_encode_loop"))])
def test_style_dispatch(monkeypatch, style, loops):
    """``dpm<N>`` routes every sample and encode entry point to the
    DPM-Solver loops (encode on the reversed grid), ``ddim<N>`` to the DDIM
    loops; any other style raises."""
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    seen = []
    for mod in (ddim, dpm_solver):
        for name in loops:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, lambda sched, *a, _n=name, **k: seen.append(
                    (_n, getattr(sched, "t_model", None))))
    x, z = torch.zeros(1, 3, 4, 4), torch.zeros(1, 2)
    gd.ddim_sample(style, None, x)
    gd.ddim_encode(style, None, x)
    gd.representation_learning_ddim_sample(style, None, None, None, x, z)
    gd.representation_learning_ddim_encode(style, None, None, x, z)
    assert [n for n, _ in seen] == list(loops)
    if style.startswith("dpm"):
        decode_t, encode_t = seen[0][1], seen[1][1]
        assert decode_t[0] == 999 and encode_t[0] == 0
        assert torch.equal(decode_t, gd.solver_tables(style).t_model)
    for bad in ("euler5", "ddpm5"):
        with pytest.raises(ValueError, match="not a DDIM style"):
            gd.ddim_sample(bad, None, x)


# -- loops with a toy model (no weights): the update equations alone ------- #

@pytest.mark.parametrize("direction", ["sample", "encode"])
def test_plain_ddim_loops_match_jax(direction):
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32)
    jax_dds = JaxGaussianDiffusion({"timesteps": 1000,
                                    "betas_type": "linear"}).ddim_schedule("ddim10")
    dds = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"}).ddim_schedule("ddim10")
    jax_loop = {"sample": jax_ddim.ddim_sample_loop,
                "encode": jax_ddim.ddim_encode_loop}[direction]
    loop = {"sample": ddim.ddim_sample_loop, "encode": ddim.ddim_encode_loop}[direction]
    want = np.asarray(jax.jit(lambda a: jax_loop(jax_dds, toy_eps_jax, a))(jnp_f32(x)))
    got = loop(dds, toy_eps_torch, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- shift-DDIM trajectories through the tiny ShiftUNet -------------------- #

@pytest.fixture(scope="module")
def tiny_pair():
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rs.randn(2, LATENT).astype(np.float32)
    return (*tiny_shift_decoders(LATENT), x, z)


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


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_trajectory_interpolation_matches_jax(tiny_pair, alpha):
    jax_decoder, port_decoder, x_T, z = tiny_pair
    z_2 = np.random.RandomState(8).randn(*z.shape).astype(np.float32)
    jax_gd = JaxGaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    want = np.asarray(jax.jit(
        lambda a, z1, z2: jax_gd.representation_learning_ddim_trajectory_interpolation(
            "ddim5", jax_decoder, z1, z2, a, alpha))(jnp_f32(x_T), jnp_f32(z), jnp_f32(z_2)))
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    with torch.no_grad():
        got = gd.representation_learning_ddim_trajectory_interpolation(
            "ddim5", port_decoder, torch.from_numpy(z), torch.from_numpy(z_2),
            torch.from_numpy(x_T), alpha)
        if alpha == 0.0:      # the z_1 trajectory: the plain shift-DDIM sample
            torch.testing.assert_close(got, ddim.shift_ddim_sample_loop(
                gd.ddim_schedule("ddim5"), port_decoder, torch.from_numpy(z),
                torch.from_numpy(x_T)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# -- process math, ancestral sampling and the losses, noise injected ------- #

SHORT = {"timesteps": 20, "betas_type": "linear"}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("learned", [False, True])
def test_single_steps_match_jax(learned):
    rs = np.random.RandomState(9)
    x_t, eps, x_0, noise = (rs.randn(3, 4, 4, 2).astype(np.float32) for _ in range(4))
    rng = rs.uniform(-1, 1, (3, 4, 4, 2)).astype(np.float32) if learned else None
    t = np.array([0, 7, 19], np.int32)
    jgd, gd = JaxGaussianDiffusion(SHORT), GaussianDiffusion(SHORT)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    J = lambda a: None if a is None else jnp_f32(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    pairs = [
        (jgd.q_posterior_mean(J(x_0), J(x_t), jt), gd.q_posterior_mean(T(x_0), T(x_t), tt)),
        (jgd.predicted_noise_to_predicted_x_0(J(x_t), jt, J(eps)),
         gd.predicted_noise_to_predicted_x_0(T(x_t), tt, T(eps))),
        (jgd.predicted_noise_to_predicted_mean(J(x_t), jt, J(eps)),
         gd.predicted_noise_to_predicted_mean(T(x_t), tt, T(eps))),
        (jgd.noise_p_sample(None, J(x_t), jt, J(eps), J(rng), noise=J(noise)),
         gd.noise_p_sample(None, T(x_t), tt, T(eps), T(rng), noise=T(noise))),
        (jgd.x_0_clip_p_sample(None, J(x_t), jt, J(eps), J(rng), noise=J(noise)),
         gd.x_0_clip_p_sample(None, T(x_t), tt, T(eps), T(rng), noise=T(noise)))]
    if learned:
        pairs.append((jgd.learned_range_to_log_variance(J(rng), jt),
                      gd.learned_range_to_log_variance(T(rng), tt)))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("learned", [False, True])
def test_regular_ddpm_sample_matches_jax(learned):
    """Full-T ancestral sampling with the noise injected (t = T-1 .. 0); a
    model with twice the channels carries the learned variance range."""
    rs = np.random.RandomState(10)
    x_T = rs.randn(2, 4, 4, 3).astype(np.float32)
    noise = rs.randn(SHORT["timesteps"], 2, 4, 4, 3).astype(np.float32)

    def jax_fn(x, t, c):
        eps = toy_eps_jax(x, t)
        return jnp.concatenate([eps, jnp.tanh(x)], axis=-1) if learned else eps

    def port_fn(x, t, c):
        eps = toy_eps_torch(x, t)
        return torch.cat([eps, torch.tanh(x)], dim=1) if learned else eps

    jgd = JaxGaussianDiffusion(SHORT)
    want = np.asarray(jax.jit(lambda a, n: jgd.regular_ddpm_sample(
        None, jax_fn, a, noise=n))(jnp_f32(x_T), jnp_f32(noise)))
    got = GaussianDiffusion(SHORT).regular_ddpm_sample(
        None, port_fn, _nchw(x_T), noise=_nchw(noise.reshape(-1, 4, 4, 3)).reshape(
            SHORT["timesteps"], 2, 3, 4, 4))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_ancestral_draws_come_from_the_generator():
    gd = GaussianDiffusion(SHORT)
    x_T = torch.zeros(2, 3, 4, 4)
    a, b, c = (gd.regular_ddpm_sample(torch.Generator().manual_seed(s), toy_eps_torch, x_T)
               for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_regular_train_one_batch_matches_jax():
    rs = np.random.RandomState(11)
    x_0, noise = (rs.randn(3, 4, 4, 3).astype(np.float32) for _ in range(2))
    t = np.array([0, 9, 19], np.int32)
    want = JaxGaussianDiffusion(SHORT).regular_train_one_batch(
        None, toy_eps_jax, jnp_f32(x_0), t=jnp.asarray(t), noise=jnp_f32(noise))
    got = GaussianDiffusion(SHORT).regular_train_one_batch(
        None, toy_eps_torch, torch.from_numpy(x_0), t=torch.from_numpy(t),
        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(got["prediction_loss"]),
                               float(want["prediction_loss"]), rtol=1e-5)


def test_representation_learning_ddpm_sample_matches_jax(tiny_pair):
    jax_decoder, port_decoder, x_T, z = tiny_pair
    noise = np.random.RandomState(12).randn(SHORT["timesteps"], *x_T.shape).astype(np.float32)
    jgd = JaxGaussianDiffusion(SHORT)
    want = np.asarray(jax.jit(lambda a, zz, n: jgd.representation_learning_ddpm_sample(
        None, None, jax_decoder, None, a, zz, noise=n))(jnp_f32(x_T), jnp_f32(z),
                                                         jnp_f32(noise)))
    with torch.no_grad():
        got = GaussianDiffusion(SHORT).representation_learning_ddpm_sample(
            None, None, port_decoder, None, torch.from_numpy(x_T), torch.from_numpy(z),
            noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_gap_measure_and_denoise_one_step_match_jax(tiny_pair):
    """Both with the noise injected; the gap measure's own draws are
    uniform in [0, 1), the reference's quirk."""
    jax_decoder, port_decoder, x_0, z = tiny_pair
    noise = np.random.RandomState(13).rand(SHORT["timesteps"], *x_0.shape).astype(np.float32)
    jax_encoder = lambda x: jnp_f32(z)
    port_encoder = lambda x: torch.from_numpy(z)
    jgd, gd = JaxGaussianDiffusion(SHORT), GaussianDiffusion(SHORT)
    want = jax.jit(lambda a, n: jgd.representation_learning_gap_measure(
        None, jax_encoder, jax_decoder, a, noise=n))(jnp_f32(x_0), jnp_f32(noise))
    with torch.no_grad():
        got = gd.representation_learning_gap_measure(
            None, port_encoder, port_decoder, torch.from_numpy(x_0),
            noise=torch.from_numpy(noise))
        for g, w in zip(got, want):
            assert g.shape == (SHORT["timesteps"],)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
        drawn = gd.representation_learning_gap_measure(
            torch.Generator().manual_seed(0), port_encoder, port_decoder,
            torch.from_numpy(x_0))
        assert all(torch.isfinite(d).all() for d in drawn)

        want = jax.jit(lambda a, n: jgd.representation_learning_denoise_one_step(
            None, jax_encoder, jax_decoder, a, [3, 17], noise=n))(jnp_f32(x_0),
                                                               jnp_f32(noise[0]))
        got = gd.representation_learning_denoise_one_step(
            None, port_encoder, port_decoder, torch.from_numpy(x_0), [3, 17],
            noise=torch.from_numpy(noise[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
