"""DPM-Solver++(2M) multistep sampling and encoding as plain Python loops.

Port of ``pdae_tpu/diffusion/dpm_solver.py``, where the loop is one
``lax.scan``. Here each step calls the model eagerly, as the DDIM loops of
``ddim.py`` do. The tables are computed in float64 numpy and cast to float32
once, as the JAX package computes them, so they are bitwise equal to its own;
each step applies its coefficients as numbers taken from those tables.

* ``spacing="lambda"`` (the default) puts the N+1 grid points uniformly in
  half-log-SNR, snapped to the discrete time axis (snapping may merge
  neighbours, so the realized step count can be below N); ``spacing="t"``
  reuses the ``respace`` sub-sequence of a ``ddim<N>`` run, on which order 1
  is the DDIM update exactly.
* The predicted x_0 is clamped to [-1, 1], as in the DDIM loops.
* Order 2 adds ``c2 * (x0_k - x0_{k-1})`` to the predicted x_0; ``c2`` is 0
  at the first step (no history) and at the last (lower order final).
* ``direction="encode"`` reverses the grid: the same update integrates the
  inversion x_0 -> x_T.
* PDAE shift: ``eps - sqrt(1 - abar_s) * gradient``; the sample loops shift
  while ``(n - k - 1) >= int(stop_percent * n)``, the encode loops always.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import tracing
from .schedules import _f32, respace


def solver_steps_from_style(style: str) -> int:
    """'dpm20' -> 20."""
    if not style.startswith("dpm"):
        raise ValueError(f"not a DPM-Solver style: {style!r}")
    return int(style[len("dpm"):])


class SolverTables(NamedTuple):
    """Per-step coefficients, each ``[num_steps]`` (float32, ``t_model``
    int32). Step k integrates grid position k to k+1; the model sees the
    original time axis, ``t_model[k]``."""

    t_model: torch.Tensor
    sr: torch.Tensor          # 1/alpha_s            (x0 = sr*x - srm1*eps)
    srm1: torch.Tensor        # sigma_s/alpha_s
    sigma_s: torch.Tensor     # sqrt(1 - abar_s), the shift coefficient
    ratio: torch.Tensor       # sigma_t/sigma_s
    acoef: torch.Tensor       # alpha_t - sigma_t*alpha_s/sigma_s
    c2: torch.Tensor          # 0.5*h_k/h_{k-1}; 0 at the first and last step

    @property
    def num_steps(self) -> int:
        return self.t_model.shape[0]


def _grid_indices(abar: np.ndarray, n: int, spacing: str) -> np.ndarray:
    """N+1 original-axis time indices, descending (the x_T level first)."""
    if spacing == "t":
        _, timestep_map = respace(abar, f"ddim{n}")
        return timestep_map[::-1].copy()
    if spacing != "lambda":
        raise ValueError(f"spacing must be 'lambda' or 't', got {spacing!r}")
    lam = np.log(np.sqrt(abar) / np.sqrt(1.0 - abar))
    targets = np.linspace(lam[-1], lam[0], n + 1)
    idx = sorted({int(np.argmin(np.abs(lam - lt))) for lt in targets},
                 reverse=True)
    idx[0], idx[-1] = abar.shape[0] - 1, 0
    return np.asarray(idx)


def make_solver_tables(schedule_alphas_cumprod, style: str,
                       spacing: str = "lambda",
                       direction: str = "decode") -> SolverTables:
    """The step tables of ``style`` = ``"dpm<N>"`` over the schedule's
    ``alphas_cumprod``; ``direction="encode"`` reverses the grid."""
    if direction not in ("decode", "encode"):
        raise ValueError(f"direction must be 'decode' or 'encode', got {direction!r}")
    n = solver_steps_from_style(style)
    abar_full = np.asarray(schedule_alphas_cumprod, dtype=np.float64)
    idx = _grid_indices(abar_full, n, spacing)
    if direction == "encode":
        idx = idx[::-1].copy()
    abar = abar_full[idx]
    alpha = np.sqrt(abar)
    sigma = np.sqrt(1.0 - abar)
    lam = np.log(alpha / sigma)

    s, t = np.arange(len(idx) - 1), np.arange(1, len(idx))
    h = lam[t] - lam[s]
    c2 = np.zeros_like(h)
    c2[1:] = 0.5 * h[1:] / h[:-1]
    c2[-1] = 0.0
    return SolverTables(
        t_model=torch.from_numpy(np.asarray(idx[s], dtype=np.int32)),
        sr=_f32(1.0 / alpha[s]),
        srm1=_f32(sigma[s] / alpha[s]),
        sigma_s=_f32(sigma[s]),
        ratio=_f32(sigma[t] / sigma[s]),
        acoef=_f32(alpha[t] - sigma[t] * alpha[s] / sigma[s]),
        c2=_f32(c2),
    )


def _entry(table: torch.Tensor, k: int) -> float:
    """A float32 table entry as a Python float (exact)."""
    return float(table[k])


def _t_vec(tables: SolverTables, k: int, x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0],), int(tables.t_model[k]), dtype=torch.int32,
                      device=x.device)


def _solver_loop(tables: SolverTables, eps_fn: Callable, x_T, order: int):
    """The multistep update; ``eps_fn(x, k)`` gives the noise at step k. Each
    step is a span ``pdae.solver.step`` keyed by k (``tracing``)."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    x, x0_prev = x_T, torch.zeros_like(x_T)
    for k in range(tables.num_steps):
        with tracing.span("pdae.solver.step", k):
            eps = eps_fn(x, k)
            x0 = (_entry(tables.sr, k) * x - _entry(tables.srm1, k) * eps).clamp(-1.0, 1.0)
            x0_eff = x0 + _entry(tables.c2, k) * (x0 - x0_prev) if order == 2 else x0
            x = _entry(tables.ratio, k) * x + _entry(tables.acoef, k) * x0_eff
            x0_prev = x0
    return x


def dpm_solver_sample_loop(tables: SolverTables, denoise_fn: Callable, x_T,
                           condition=None, order: int = 2):
    """x_T -> x_0 for a plain epsilon model ``denoise_fn(x, t, condition)``."""
    return _solver_loop(
        tables, lambda x, k: denoise_fn(x, _t_vec(tables, k, x), condition),
        x_T, order)


def shift_dpm_solver_sample_loop(tables: SolverTables, decoder: Callable, z,
                                 x_T, stop_percent: float = 0.0, order: int = 2):
    """PDAE shift decode; ``decoder(x, t, z) -> (eps, gradient)``."""
    n = tables.num_steps
    stop_step = int(stop_percent * n)

    def eps_fn(x, k):
        eps, gradient = decoder(x, _t_vec(tables, k, x), z)
        if (n - k - 1) >= stop_step:
            eps = eps - _entry(tables.sigma_s, k) * gradient
        return eps

    return _solver_loop(tables, eps_fn, x_T, order)


def dpm_solver_encode_loop(tables: SolverTables, denoise_fn: Callable, x_0,
                           condition=None, order: int = 2):
    """x_0 -> x_T; ``tables`` built with ``direction="encode"``."""
    return _solver_loop(
        tables, lambda x, k: denoise_fn(x, _t_vec(tables, k, x), condition),
        x_0, order)


def shift_dpm_solver_encode_loop(tables: SolverTables, decoder: Callable, z,
                                 x_0, order: int = 2):
    """PDAE shift encode (the shift at every step)."""
    def eps_fn(x, k):
        eps, gradient = decoder(x, _t_vec(tables, k, x), z)
        return eps - _entry(tables.sigma_s, k) * gradient

    return _solver_loop(tables, eps_fn, x_0, order)


def latent_dpm_solver_sample_loop(tables: SolverTables,
                                  latent_denoise_fn: Callable, z_T,
                                  order: int = 2):
    """Latent-DPM decode, with the [-1, 1] x_0 clamp of the called latent
    DDIM path; ``latent_denoise_fn(z, t)``."""
    return dpm_solver_sample_loop(
        tables, lambda x, t, _c: latent_denoise_fn(x, t), z_T, order=order)
