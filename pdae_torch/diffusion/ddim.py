"""DDIM sub-sequence sampling and encoding as plain Python loops.

Port of ``pdae_tpu/diffusion/ddim.py``, where each loop is one ``lax.scan``.
Here each step calls the model eagerly. The math is carried over exactly:

* sampling visits i = num_steps .. 1, encoding i = 0 .. num_steps-1;
* the model receives the original time axis, ``timestep_map[i]``;
* the predicted x_0 is clamped to [-1, 1] and the noise recomputed from it;
* the shift variants use ``eps - sqrt(1 - abar_t) * gradient``;
* ``stop_percent``: the shift is applied only while
  ``(i - 1) >= int(stop_percent * num_steps)``.

Per-step coefficients are float32 table entries applied as numbers; the
float32 square roots are taken in numpy float32, as the JAX code takes them.
Each step (its model calls and its update) is a span ``pdae.solver.step``
keyed by i (``tracing``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import tracing
from .schedules import DDIMSchedule


def _entry(table: torch.Tensor, i: int) -> np.float32:
    return np.float32(table[i].item())


def _t_vec(dds: DDIMSchedule, i: int, x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0],), int(dds.timestep_map[i]), dtype=torch.int32,
                      device=x.device)


def _predict_x0_and_renoise(dds: DDIMSchedule, x_t, i, predicted_noise):
    sr = float(_entry(dds.sqrt_recip_alphas_cumprod, i))
    srm1 = float(_entry(dds.sqrt_recip_alphas_cumprod_m1, i))
    predicted_x_0 = (sr * x_t - srm1 * predicted_noise).clamp(-1.0, 1.0)
    return predicted_x_0, (sr * x_t - predicted_x_0) / srm1


def _step(abar: np.float32, predicted_x_0, new_noise):
    return (predicted_x_0 * float(np.sqrt(abar))
            + float(np.sqrt(np.float32(1.0) - abar)) * new_noise)


def _shifted_noise(dds: DDIMSchedule, predicted_noise, gradient, i):
    coef = float(_entry(dds.sqrt_one_minus_alphas_cumprod, i))
    return predicted_noise - coef * gradient


def ddim_sample_loop(dds: DDIMSchedule, denoise_fn: Callable, x_T, condition=None):
    """Deterministic DDIM sampling x_T -> x_0."""
    x = x_T
    for i in range(dds.num_steps, 0, -1):
        with tracing.span("pdae.solver.step", i):
            eps = denoise_fn(x, _t_vec(dds, i, x), condition)
            x0, eps = _predict_x0_and_renoise(dds, x, i, eps)
            x = _step(_entry(dds.alphas_cumprod_prev, i), x0, eps)
    return x


def ddim_encode_loop(dds: DDIMSchedule, denoise_fn: Callable, x_0, condition=None):
    """Deterministic DDIM encoding x_0 -> x_T."""
    x = x_0
    for i in range(dds.num_steps):
        with tracing.span("pdae.solver.step", i):
            eps = denoise_fn(x, _t_vec(dds, i, x), condition)
            x0, eps = _predict_x0_and_renoise(dds, x, i, eps)
            x = _step(_entry(dds.alphas_cumprod_next, i), x0, eps)
    return x


def shift_ddim_sample_loop(dds: DDIMSchedule, decoder: Callable, z, x_T,
                           stop_percent: float = 0.0):
    """PDAE shift-DDIM sampling; ``decoder(x, t, z) -> (eps, gradient)``."""
    stop_step = int(stop_percent * dds.num_steps)
    x = x_T
    for i in range(dds.num_steps, 0, -1):
        with tracing.span("pdae.solver.step", i):
            eps, gradient = decoder(x, _t_vec(dds, i, x), z)
            if (i - 1) >= stop_step:
                eps = _shifted_noise(dds, eps, gradient, i)
            x0, eps = _predict_x0_and_renoise(dds, x, i, eps)
            x = _step(_entry(dds.alphas_cumprod_prev, i), x0, eps)
    return x


def shift_ddim_encode_loop(dds: DDIMSchedule, decoder: Callable, z, x_0):
    """PDAE shift-DDIM encoding x_0 -> x_T."""
    x = x_0
    for i in range(dds.num_steps):
        with tracing.span("pdae.solver.step", i):
            eps, gradient = decoder(x, _t_vec(dds, i, x), z)
            eps = _shifted_noise(dds, eps, gradient, i)
            x0, eps = _predict_x0_and_renoise(dds, x, i, eps)
            x = _step(_entry(dds.alphas_cumprod_next, i), x0, eps)
    return x


def shift_ddim_trajectory_interpolation(dds: DDIMSchedule, decoder: Callable,
                                        z_1, z_2, x_T, alpha: float):
    """Shift-DDIM sampling with the gradient blended from two latents,
    ``(1 - alpha) * g(z_1) + alpha * g(z_2)``, at every step; the noise is
    the ``z_1`` call's. Two decoder calls per step."""
    x = x_T
    for i in range(dds.num_steps, 0, -1):
        with tracing.span("pdae.solver.step", i):
            t = _t_vec(dds, i, x)
            eps, gradient_1 = decoder(x, t, z_1)
            _, gradient_2 = decoder(x, t, z_2)
            gradient = (1.0 - alpha) * gradient_1 + alpha * gradient_2
            eps = _shifted_noise(dds, eps, gradient, i)
            x0, eps = _predict_x0_and_renoise(dds, x, i, eps)
            x = _step(_entry(dds.alphas_cumprod_prev, i), x0, eps)
    return x


def latent_ddim_sample_loop(dds: DDIMSchedule, latent_denoise_fn: Callable, z_T):
    """Latent DDIM sampling, ``latent_denoise_fn(z, t)``: the clamped DDIM
    loop, the path the reference calls (not the unclamped one below)."""
    return ddim_sample_loop(dds, lambda x, t, _c: latent_denoise_fn(x, t), z_T)


def latent_ddim_sample_loop_unclamped(dds: DDIMSchedule,
                                      latent_denoise_fn: Callable, z_T):
    """The unclamped variant the reference defines but does not call: the
    predicted z_0 is not clamped and the step takes the original predicted
    noise, not one recomputed from z_0."""
    z = z_T
    for i in range(dds.num_steps, 0, -1):
        with tracing.span("pdae.solver.step", i):
            eps = latent_denoise_fn(z, _t_vec(dds, i, z))
            sr = float(_entry(dds.sqrt_recip_alphas_cumprod, i))
            srm1 = float(_entry(dds.sqrt_recip_alphas_cumprod_m1, i))
            z = _step(_entry(dds.alphas_cumprod_prev, i), sr * z - srm1 * eps, eps)
    return z
