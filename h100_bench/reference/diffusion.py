"""Plain diffusion arithmetic of PDAE: the linear beta schedule, the
representation-learning loss, DPM-Solver++(2M) with the PDAE shift for the
inversion (x_0 -> x_T) and the decode (x_T -> x_0), and the [-1, 1] <-> uint8
image conversions.

Tables are computed in float64 numpy and rounded to fp32 once; each solver
step applies its coefficients as numbers taken from those tables.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_alphas_cumprod(timesteps: int = 1000) -> np.ndarray:
    """abar_t of the linear schedule as the fp32 table holds it, widened to
    float64 (the solver's grid and coefficients are worked out from it)."""
    betas = np.linspace(0.0001, 0.02, timesteps, dtype=np.float64)
    return np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)


def loss_tables(timesteps: int = 1000, gamma: float = 0.1):
    """fp32 ``[T]`` tables of the PDAE loss: sqrt(abar), sqrt(1 - abar), the
    shift coefficient -sqrt(alpha_t) (1 - abar_{t-1}) / sqrt(1 - abar_t) and
    the weight SNR^gamma / (1 + SNR)."""
    betas = np.linspace(0.0001, 0.02, timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    abar_prev = np.append(1.0, abar[:-1])
    snr = abar / (1.0 - abar)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return {"sqrt_abar": f32(np.sqrt(abar)), "sqrt_1m_abar": f32(np.sqrt(1.0 - abar)),
            "shift_coef": f32(-np.sqrt(alphas) * (1.0 - abar_prev) / np.sqrt(1.0 - abar)),
            "weight": f32(snr ** gamma / (1.0 + snr))}


def representation_loss_sum(tables, encoder, decoder, x_0, t, noise):
    """The sum over the rows' elements of weight * (noise - (eps + shift_coef *
    gradient))^2; the batch's loss is this over the batch's element count."""
    def col(name):
        return tables[name].to(x_0.device)[t.long()].reshape(-1, 1, 1, 1)

    z = encoder(x_0)
    x_t = col("sqrt_abar") * x_0 + col("sqrt_1m_abar") * noise
    eps, grad = decoder(x_t, t, z)
    return (col("weight") * (noise - (eps + col("shift_coef") * grad)) ** 2).sum()


def solver_grid(abar: np.ndarray, n: int) -> np.ndarray:
    """DPM-Solver's N+1 time indices, uniform in half-log-SNR and snapped to
    the discrete axis (neighbours may merge), descending."""
    lam = np.log(np.sqrt(abar) / np.sqrt(1.0 - abar))
    idx = sorted({int(np.argmin(np.abs(lam - v))) for v in np.linspace(lam[-1], lam[0], n + 1)},
                 reverse=True)
    idx[0], idx[-1] = abar.shape[0] - 1, 0
    return np.asarray(idx)


def solver_steps(abar: np.ndarray, n: int, encode: bool):
    """Per step k: (model time, 1/alpha_s, sigma_s/alpha_s, sigma_s,
    sigma_t/sigma_s, alpha_t - sigma_t alpha_s/sigma_s, c2), every number
    rounded to fp32; ``encode`` runs the grid backwards."""
    idx = solver_grid(abar, n)
    if encode:
        idx = idx[::-1]
    a = abar[idx]
    alpha, sigma = np.sqrt(a), np.sqrt(1.0 - a)
    lam = np.log(alpha / sigma)
    h = lam[1:] - lam[:-1]
    c2 = np.zeros_like(h)
    c2[1:] = 0.5 * h[1:] / h[:-1]
    c2[-1] = 0.0
    r = lambda v: float(np.float32(v))
    return [(int(idx[k]), r(1.0 / alpha[k]), r(sigma[k] / alpha[k]), r(sigma[k]),
             r(sigma[k + 1] / sigma[k]), r(alpha[k + 1] - sigma[k + 1] * alpha[k] / sigma[k]),
             r(c2[k])) for k in range(len(idx) - 1)]


def shift_solver(steps, decoder, z, x):
    """DPM-Solver++(2M) with the PDAE shift eps - sigma_s * gradient at every
    step and the predicted x_0 clamped to [-1, 1]."""
    x0_prev = torch.zeros_like(x)
    for t, sr, srm1, sigma_s, ratio, acoef, c2 in steps:
        tv = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        eps, grad = decoder(x, tv, z)
        x0 = (sr * x - srm1 * (eps - sigma_s * grad)).clamp(-1.0, 1.0)
        x = ratio * x + acoef * (x0 + c2 * (x0 - x0_prev))
        x0_prev = x0
    return x


def autoencode(encoder, decoder, x_0, encode_steps: int, decode_steps: int):
    """x_0 -> z, the inversion to x_T, and the decode back to x_0."""
    abar = linear_alphas_cumprod()
    z = encoder(x_0)
    x_T = shift_solver(solver_steps(abar, encode_steps, True), decoder, z, x_0)
    return shift_solver(solver_steps(abar, decode_steps, False), decoder, z, x_T)


def from_uint8(images: np.ndarray) -> torch.Tensor:
    """uint8 NHWC -> fp32 NCHW in [-1, 1], as x / 255 * 2 - 1."""
    x = images.astype(np.float32) / 255.0 * 2.0 - 1.0
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def to_uint8(x: torch.Tensor) -> np.ndarray:
    """fp32 NCHW in [-1, 1] -> uint8 NHWC, (x + 1) * 127.5 rounded."""
    a = x.permute(0, 2, 3, 1).detach().cpu().numpy().astype(np.float32)
    return np.clip(np.round((a + 1.0) * 127.5), 0, 255).astype(np.uint8)
