"""Diffusion noise schedules and the tables derived from them.

Port of ``pdae_tpu/diffusion/schedules.py``: every table is computed in
float64 numpy and cast to float32 once, exactly as the JAX package does, so
the tables are bitwise equal to its own. They are CPU tensors; the sampling
loops read per-step coefficients from them as numbers, and ``extract`` keeps
one copy of a table on each device it gathers on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def make_betas(betas_type: str, timesteps: int) -> np.ndarray:
    """Beta schedule (float64 numpy)."""
    if betas_type == "linear":
        return np.linspace(0.0001, 0.02, timesteps)
    if betas_type == "cosine":
        alpha_bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        max_beta = 0.999
        betas = []
        for i in range(timesteps):
            t1 = i / timesteps
            t2 = (i + 1) / timesteps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
        return np.array(betas)
    if betas_type == "constant_0.008":
        return np.full((timesteps,), 0.008)
    raise NotImplementedError(f"unknown betas_type: {betas_type}")


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


class Schedule(NamedTuple):
    """Every derived table, each ``[timesteps]`` float32."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod_m1: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    x_0_posterior_mean_x_0_coef: torch.Tensor
    x_0_posterior_mean_x_t_coef: torch.Tensor
    noise_posterior_mean_x_t_coef: torch.Tensor
    noise_posterior_mean_noise_coef: torch.Tensor
    shift_coef: torch.Tensor
    weight: torch.Tensor  # SNR^gamma / (1 + SNR)

    @property
    def timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(betas_type: str = "linear", timesteps: int = 1000,
                  gamma: float = 0.1) -> Schedule:
    betas = make_betas(betas_type, timesteps).astype(np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:]))

    snr = alphas_cumprod / (1.0 - alphas_cumprod)

    return Schedule(
        betas=_f32(betas),
        alphas=_f32(alphas),
        alphas_cumprod=_f32(alphas_cumprod),
        alphas_cumprod_prev=_f32(alphas_cumprod_prev),
        alphas_cumprod_next=_f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=_f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=_f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recip_alphas_cumprod_m1=_f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=_f32(posterior_variance),
        posterior_log_variance_clipped=_f32(posterior_log_variance_clipped),
        x_0_posterior_mean_x_0_coef=_f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        x_0_posterior_mean_x_t_coef=_f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        noise_posterior_mean_x_t_coef=_f32(np.sqrt(1.0 / alphas)),
        noise_posterior_mean_noise_coef=_f32(
            betas / (np.sqrt(alphas) * np.sqrt(1.0 - alphas_cumprod))),
        shift_coef=_f32(
            -np.sqrt(alphas) * (1.0 - alphas_cumprod_prev) / np.sqrt(1.0 - alphas_cumprod)),
        weight=_f32(snr ** gamma / (1.0 + snr)),
    )


def ddim_steps_from_style(ddim_style: str) -> int:
    """'ddim100' -> 100."""
    if not ddim_style.startswith("ddim"):
        raise ValueError(f"not a DDIM style: {ddim_style!r}")
    return int(ddim_style[len("ddim"):])


def respace(alphas_cumprod, ddim_style: str):
    """DDIM re-spacing: the sub-sequence's betas and its map back to the
    original time axis, with the set-of-linspace dedup of the reference.
    Returns ``(new_betas, timestep_map)`` as numpy arrays."""
    alphas_cumprod = np.asarray(alphas_cumprod, dtype=np.float64)
    original_timesteps = alphas_cumprod.shape[0]
    ddim_step = ddim_steps_from_style(ddim_style)
    use_timesteps = set(
        int(s) for s in np.linspace(0, original_timesteps - 1, ddim_step + 1))

    timestep_map = []
    new_betas = []
    last_alpha_cumprod = 1.0
    for i, ac in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1.0 - ac / last_alpha_cumprod)
            last_alpha_cumprod = ac
            timestep_map.append(i)
    return np.array(new_betas), np.array(timestep_map, dtype=np.int32)


class DDIMSchedule(NamedTuple):
    """Re-spaced tables of length ``num_steps + 1``; sampling visits indices
    ``num_steps..1`` and encoding ``0..num_steps-1``."""

    timestep_map: torch.Tensor           # int32
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod_m1: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.timestep_map.shape[0] - 1


def make_ddim_schedule(schedule_alphas_cumprod, ddim_style: str) -> DDIMSchedule:
    new_betas, timestep_map = respace(np.asarray(schedule_alphas_cumprod), ddim_style)
    alphas = 1.0 - new_betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
    return DDIMSchedule(
        timestep_map=torch.from_numpy(timestep_map),
        alphas_cumprod_prev=_f32(alphas_cumprod_prev),
        alphas_cumprod_next=_f32(alphas_cumprod_next),
        sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recip_alphas_cumprod_m1=_f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
    )


_ON_DEVICE: dict = {}   # (id(table), device) -> (table, its copy there)


def _on_device(table: torch.Tensor, device) -> torch.Tensor:
    """``table`` on ``device``, copied there once: a train step then makes no
    host-to-device copy, which would wait for the card and which a CUDA
    graph cannot capture from pageable memory. The entry holds the table, so
    its ``id`` stays its own."""
    if table.device == device:
        return table
    key = (id(table), device)
    hit = _ON_DEVICE.get(key)
    if hit is None:
        hit = _ON_DEVICE[key] = (table, table.to(device))
    return hit[1]


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-sample coefficients ``table[t]`` and broadcast them over
    ``ndim - 1`` trailing dims."""
    out = _on_device(table, t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))
