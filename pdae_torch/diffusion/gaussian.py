"""Gaussian diffusion: the process math, losses, training batches, ancestral
(DDPM) sampling and the workload-level entry points.

Port of ``pdae_tpu/diffusion/gaussian.py``. The model is a plain callable:

* ``denoise_fn(x_t, t, condition) -> eps`` (or ``[eps | learned range]``
  with twice the channels, along dim 1: the port runs NCHW);
* ``decoder(x_t, t, z) -> (eps, gradient)`` (the PDAE ShiftUNet);
* ``latent_denoise_fn(z_t, t) -> eps``;
* ``encoder(x_0) -> z``;
* ``classifier(z_norm) -> logits``.

Styles: ``ddim<N>`` runs the DDIM loops of ``ddim.py``, ``dpm<N>`` the
DPM-Solver++ loops of ``dpm_solver.py``, for sampling and for encoding.

Randomness comes from an explicit ``torch.Generator`` (the JAX package
threads ``jax.random`` keys), drawn on the generator's own device; every draw
can be injected instead. Per-timestep noise is injected as
``[timesteps, *shape]``, ordered t = T-1 .. 0 as the JAX scans take it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import ddim as ddim_lib
from . import dpm_solver as dpm_lib
from .schedules import DDIMSchedule, extract, make_ddim_schedule, make_schedule


def _randn(generator, shape, like):
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=like.dtype).to(like.device)


def _randint(generator, high, batch, device):
    return torch.randint(0, high, (batch,), generator=generator,
                         device=generator.device, dtype=torch.int32).to(device)


def _t_full(i: int, batch: int, device) -> torch.Tensor:
    return torch.full((batch,), i, dtype=torch.int32, device=device)


class GaussianDiffusion:
    """Holds the schedule tables. ``config``: ``{"timesteps": int,
    "betas_type": "linear" | "cosine"}``. The latent DPM runs its own
    schedule: constant beta 0.008 over 1000 steps, with an l1 loss."""

    def __init__(self, config: dict):
        self.timesteps = int(config["timesteps"])
        self.betas_type = config["betas_type"]
        self.schedule = make_schedule(self.betas_type, self.timesteps)
        self.latent_timesteps = 1000
        self.latent_schedule = make_schedule("constant_0.008", self.latent_timesteps)
        self.latent_loss_type = "l1"

    # -- process math ------------------------------------------------------ #

    def q_sample(self, x_0, t, noise):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_0.dim()) * x_0
                + extract(s.sqrt_one_minus_alphas_cumprod, t, x_0.dim()) * noise)

    def q_posterior_mean(self, x_0, x_t, t):
        s = self.schedule
        return (extract(s.x_0_posterior_mean_x_0_coef, t, x_t.dim()) * x_0
                + extract(s.x_0_posterior_mean_x_t_coef, t, x_t.dim()) * x_t)

    def predicted_noise_to_predicted_x_0(self, x_t, t, predicted_noise):
        s = self.schedule
        return (extract(s.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
                - extract(s.sqrt_recip_alphas_cumprod_m1, t, x_t.dim()) * predicted_noise)

    def predicted_noise_to_predicted_mean(self, x_t, t, predicted_noise):
        s = self.schedule
        return (extract(s.noise_posterior_mean_x_t_coef, t, x_t.dim()) * x_t
                - extract(s.noise_posterior_mean_noise_coef, t, x_t.dim()) * predicted_noise)

    def learned_range_to_log_variance(self, learned_range, t):
        s = self.schedule
        nd = learned_range.dim()
        min_log_variance = extract(s.posterior_log_variance_clipped, t, nd)
        max_log_variance = extract(torch.log(s.betas), t, nd)
        frac = (learned_range + 1.0) / 2.0
        return min_log_variance + frac * (max_log_variance - min_log_variance)

    def _ancestral_step(self, generator, x_t, t, mean, learned_range, noise):
        if learned_range is not None:
            log_variance = self.learned_range_to_log_variance(learned_range, t)
        else:
            log_variance = extract(self.schedule.posterior_log_variance_clipped, t,
                                   x_t.dim())
        if noise is None:
            noise = _randn(generator, x_t.shape, x_t)
        nonzero_mask = (1.0 - (t == 0).to(x_t.dtype)).reshape(
            (x_t.shape[0],) + (1,) * (x_t.dim() - 1))
        return mean + nonzero_mask * torch.exp(0.5 * log_variance) * noise

    def noise_p_sample(self, generator, x_t, t, predicted_noise, learned_range=None,
                       *, noise=None):
        """One ancestral DDPM step from the predicted noise."""
        mean = self.predicted_noise_to_predicted_mean(x_t, t, predicted_noise)
        return self._ancestral_step(generator, x_t, t, mean, learned_range, noise)

    def x_0_clip_p_sample(self, generator, x_t, t, predicted_noise,
                          learned_range=None, clip_x_0=True, *, noise=None):
        """One ancestral step through the (clamped) predicted x_0."""
        predicted_x_0 = self.predicted_noise_to_predicted_x_0(x_t, t, predicted_noise)
        if clip_x_0:
            predicted_x_0 = predicted_x_0.clamp(-1.0, 1.0)
        mean = self.q_posterior_mean(predicted_x_0, x_t, t)
        return self._ancestral_step(generator, x_t, t, mean, learned_range, noise)

    @staticmethod
    def p_loss(noise, predicted_noise, weight=None, loss_type="l2"):
        if loss_type == "l1":
            return (noise - predicted_noise).abs().mean()
        if loss_type == "l2":
            if weight is not None:
                return (weight * (noise - predicted_noise) ** 2).mean()
            return ((noise - predicted_noise) ** 2).mean()
        raise NotImplementedError(loss_type)

    # -- style routing ----------------------------------------------------- #

    def ddim_schedule(self, ddim_style: str) -> DDIMSchedule:
        return make_ddim_schedule(self.schedule.alphas_cumprod.numpy(), ddim_style)

    def latent_ddim_schedule(self, ddim_style: str) -> DDIMSchedule:
        return make_ddim_schedule(self.latent_schedule.alphas_cumprod.numpy(),
                                  ddim_style)

    @staticmethod
    def _is_solver_style(style: str) -> bool:
        return style.startswith("dpm")

    def solver_tables(self, style: str, spacing: str = "lambda",
                      direction: str = "decode") -> dpm_lib.SolverTables:
        return dpm_lib.make_solver_tables(self.schedule.alphas_cumprod.numpy(), style,
                                          spacing=spacing, direction=direction)

    def latent_solver_tables(self, style: str,
                             spacing: str = "lambda") -> dpm_lib.SolverTables:
        return dpm_lib.make_solver_tables(self.latent_schedule.alphas_cumprod.numpy(),
                                          style, spacing=spacing)

    def ddim_sample(self, ddim_style, denoise_fn, x_T, condition=None):
        if self._is_solver_style(ddim_style):
            return dpm_lib.dpm_solver_sample_loop(
                self.solver_tables(ddim_style), denoise_fn, x_T, condition)
        return ddim_lib.ddim_sample_loop(
            self.ddim_schedule(ddim_style), denoise_fn, x_T, condition)

    def ddim_encode(self, ddim_style, denoise_fn, x_0, condition=None):
        if self._is_solver_style(ddim_style):
            return dpm_lib.dpm_solver_encode_loop(
                self.solver_tables(ddim_style, direction="encode"),
                denoise_fn, x_0, condition)
        return ddim_lib.ddim_encode_loop(
            self.ddim_schedule(ddim_style), denoise_fn, x_0, condition)

    def test_pretrained_dpms(self, ddim_style, denoise_fn, x_T, condition=None):
        return self.ddim_sample(ddim_style, denoise_fn, x_T, condition)

    def train_draws(self, generator, n: int, row_shape, like, latent: bool = False):
        """``t`` (int32 ``[n]``, over the latent schedule where ``latent``)
        then noise (``[n, *row_shape]`` in ``like``'s dtype, on its device),
        drawn from ``generator`` as the train losses draw them when nothing
        is injected: the global micro-batch's draws, which a data-parallel
        step cuts its rows from (``training.state.accumulate_grads``)."""
        t = _randint(generator, self.latent_timesteps if latent else self.timesteps, n,
                     like.device)
        return t, _randn(generator, (n,) + tuple(row_shape), like)

    # -- regular diffusion ------------------------------------------------- #

    def regular_train_one_batch(self, generator, denoise_fn, x_0, condition=None,
                                *, t=None, noise=None):
        """The plain DDPM l2 loss of one batch; ``t`` (int ``[B]``) then
        ``noise`` are drawn from ``generator`` unless injected."""
        if t is None:
            t = _randint(generator, self.timesteps, x_0.shape[0], x_0.device)
        if noise is None:
            noise = _randn(generator, x_0.shape, x_0)
        x_t = self.q_sample(x_0, t, noise)
        return {"prediction_loss": self.p_loss(noise, denoise_fn(x_t, t, condition))}

    def regular_ddim_sample(self, ddim_style, denoise_fn, x_T, condition=None):
        return self.ddim_sample(ddim_style, denoise_fn, x_T, condition)

    def regular_ddpm_sample(self, generator, denoise_fn, x_T, condition=None,
                            *, noise=None):
        """Full-T ancestral sampling; a model output with twice x_T's
        channels carries the learned variance range in its second half."""
        ch = x_T.shape[1]
        x = x_T
        for step, i in enumerate(range(self.timesteps - 1, -1, -1)):
            t = _t_full(i, x.shape[0], x.device)
            output = denoise_fn(x, t, condition)
            if output.shape[1] == 2 * ch:
                predicted_noise, learned_range = output.chunk(2, dim=1)
            else:
                predicted_noise, learned_range = output, None
            x = self.noise_p_sample(generator, x, t, predicted_noise, learned_range,
                                    noise=None if noise is None else noise[step])
        return x

    # -- representation learning (PDAE) -------------------------------------- #

    def representation_learning_train_one_batch(self, generator, encoder, decoder,
                                                x_0, *, t=None, noise=None):
        """The PDAE loss of one batch: the SNR-weighted l2 between the noise
        and ``eps + shift_coef * gradient``. ``t`` (int ``[B]``) and ``noise``
        may be injected for deterministic parity tests; by default they are
        drawn from ``generator`` on its own device."""
        z = encoder(x_0)
        if t is None:
            t = _randint(generator, self.timesteps, x_0.shape[0], x_0.device)
        if noise is None:
            noise = _randn(generator, x_0.shape, x_0)
        x_t = self.q_sample(x_0, t, noise)
        predicted_noise, gradient = decoder(x_t, t, z)
        shift_coef = extract(self.schedule.shift_coef, t, x_0.dim())
        weight = extract(self.schedule.weight, t, x_0.dim())
        loss = self.p_loss(noise, predicted_noise + shift_coef * gradient,
                           weight=weight)
        return {"prediction_loss": loss}

    def representation_learning_ddpm_sample(self, generator, encoder, decoder, x_0,
                                            x_T, z=None, *, noise=None):
        """Full-T ancestral sampling with the shifted noise."""
        if z is None:
            z = encoder(x_0)
        x = x_T
        for step, i in enumerate(range(self.timesteps - 1, -1, -1)):
            t = _t_full(i, x.shape[0], x.device)
            predicted_noise, gradient = decoder(x, t, z)
            shift_coef = extract(self.schedule.shift_coef, t, x.dim())
            x = self.noise_p_sample(generator, x, t,
                                    predicted_noise + shift_coef * gradient,
                                    noise=None if noise is None else noise[step])
        return x

    def representation_learning_ddim_sample(self, ddim_style, encoder, decoder,
                                            x_0, x_T, z=None, stop_percent=0.0):
        if z is None:
            z = encoder(x_0)
        if self._is_solver_style(ddim_style):
            return dpm_lib.shift_dpm_solver_sample_loop(
                self.solver_tables(ddim_style), decoder, z, x_T,
                stop_percent=stop_percent)
        return ddim_lib.shift_ddim_sample_loop(
            self.ddim_schedule(ddim_style), decoder, z, x_T,
            stop_percent=stop_percent)

    def representation_learning_ddim_encode(self, ddim_style, encoder, decoder,
                                            x_0, z=None):
        if z is None:
            z = encoder(x_0)
        if self._is_solver_style(ddim_style):
            return dpm_lib.shift_dpm_solver_encode_loop(
                self.solver_tables(ddim_style, direction="encode"), decoder, z, x_0)
        return ddim_lib.shift_ddim_encode_loop(
            self.ddim_schedule(ddim_style), decoder, z, x_0)

    def representation_learning_autoencoding(self, encoder_ddim_style,
                                             decoder_ddim_style, encoder,
                                             decoder, x_0):
        z = encoder(x_0)
        inferred_x_T = self.representation_learning_ddim_encode(
            encoder_ddim_style, encoder, decoder, x_0, z)
        return self.representation_learning_ddim_sample(
            decoder_ddim_style, None, decoder, None, inferred_x_T, z)

    def representation_learning_gap_measure(self, generator, encoder, decoder, x_0,
                                            *, noise=None):
        """Posterior-mean gaps at every t, two ``[timesteps]`` tensors ordered
        t = T-1 .. 0. The noise is uniform in [0, 1), as the reference draws
        it (``torch.rand_like``), a quirk kept."""
        z = encoder(x_0)
        gaps, ae_gaps = [], []
        for step, i in enumerate(range(self.timesteps - 1, -1, -1)):
            t = _t_full(i, x_0.shape[0], x_0.device)
            if noise is None:
                eps = torch.rand(x_0.shape, generator=generator,
                                 device=generator.device,
                                 dtype=x_0.dtype).to(x_0.device)
            else:
                eps = noise[step]
            x_t = self.q_sample(x_0, t, eps)
            predicted_noise, gradient = decoder(x_t, t, z)
            predicted_x_0 = self.predicted_noise_to_predicted_x_0(x_t, t, predicted_noise)
            predicted_posterior_mean = self.q_posterior_mean(predicted_x_0, x_t, t)
            shift_coef = extract(self.schedule.shift_coef, t, x_0.dim())
            ae_x_0 = self.predicted_noise_to_predicted_x_0(
                x_t, t, predicted_noise + shift_coef * gradient)
            ae_posterior_mean = self.q_posterior_mean(ae_x_0, x_t, t)
            true_posterior_mean = self.q_posterior_mean(x_0, x_t, t)
            gaps.append(((true_posterior_mean - predicted_posterior_mean) ** 2).mean())
            ae_gaps.append(((true_posterior_mean - ae_posterior_mean) ** 2).mean())
        return torch.stack(gaps), torch.stack(ae_gaps)

    def representation_learning_denoise_one_step(self, generator, encoder, decoder,
                                                 x_0, timestep_list: Sequence[int],
                                                 *, noise=None):
        """One denoising step from ``q_sample`` at each image's own t: the
        predicted x_0 from eps alone and from the shifted noise."""
        t = torch.as_tensor(timestep_list, dtype=torch.int32, device=x_0.device)
        if noise is None:
            noise = _randn(generator, x_0.shape, x_0)
        x_t = self.q_sample(x_0, t, noise)
        z = encoder(x_0)
        predicted_noise, gradient = decoder(x_t, t, z)
        predicted_x_0 = self.predicted_noise_to_predicted_x_0(x_t, t, predicted_noise)
        shift_coef = extract(self.schedule.shift_coef, t, x_0.dim())
        ae_x_0 = self.predicted_noise_to_predicted_x_0(
            x_t, t, predicted_noise + shift_coef * gradient)
        return predicted_x_0, ae_x_0

    def representation_learning_ddim_trajectory_interpolation(
            self, ddim_style, decoder, z_1, z_2, x_T, alpha):
        return ddim_lib.shift_ddim_trajectory_interpolation(
            self.ddim_schedule(ddim_style), decoder, z_1, z_2, x_T, alpha)

    # -- latent DPM -------------------------------------------------------- #

    @staticmethod
    def normalize(z, mean, std):
        return (z - mean) / std

    @staticmethod
    def denormalize(z, mean, std):
        return z * std + mean

    def latent_diffusion_train_one_batch(self, generator, latent_denoise_fn, encoder,
                                         x_0, latents_mean, latents_std,
                                         *, t=None, noise=None):
        """The latent DPM's l1 loss of one batch on the normalized encoder
        latents (no gradient reaches the encoder)."""
        ls = self.latent_schedule
        with torch.no_grad():
            z_0 = encoder(x_0)
        z_0 = self.normalize(z_0, latents_mean, latents_std)
        if t is None:
            t = _randint(generator, self.latent_timesteps, z_0.shape[0], z_0.device)
        if noise is None:
            noise = _randn(generator, z_0.shape, z_0)
        z_t = (extract(ls.sqrt_alphas_cumprod, t, z_0.dim()) * z_0
               + extract(ls.sqrt_one_minus_alphas_cumprod, t, z_0.dim()) * noise)
        loss = self.p_loss(noise, latent_denoise_fn(z_t, t),
                           loss_type=self.latent_loss_type)
        return {"prediction_loss": loss}

    def latent_diffusion_sample(self, generator, latent_ddim_style, decoder_ddim_style,
                                latent_denoise_fn, decoder, x_T, latents_mean,
                                latents_std, latent_dim: int = 512, *, z_T=None):
        """z_T ~ N(0, 1) clamped to [-1, 1] -> the latent loop -> denormalize
        -> shift decode of x_T with ``stop_percent = 0.3``."""
        if z_T is None:
            z_T = _randn(generator, (x_T.shape[0], latent_dim), x_T)
        z_T = z_T.clamp(-1.0, 1.0)
        if self._is_solver_style(latent_ddim_style):
            z = dpm_lib.latent_dpm_solver_sample_loop(
                self.latent_solver_tables(latent_ddim_style), latent_denoise_fn, z_T)
        else:
            z = ddim_lib.latent_ddim_sample_loop(
                self.latent_ddim_schedule(latent_ddim_style), latent_denoise_fn, z_T)
        z = self.denormalize(z, latents_mean, latents_std)
        return self.representation_learning_ddim_sample(
            decoder_ddim_style, None, decoder, None, x_T, z, stop_percent=0.3)

    # -- manipulation ------------------------------------------------------ #

    def manipulation_train_one_batch(self, classifier, encoder, x_0, label,
                                     latents_mean, latents_std):
        """Binary cross entropy with logits (mean) of the classifier on the
        normalized latents against ``label > 0``."""
        with torch.no_grad():
            z = encoder(x_0)
        prediction = classifier(self.normalize(z, latents_mean, latents_std))
        gt = (label > 0).to(prediction.dtype)
        loss = (prediction.clamp_min(0) - prediction * gt
                + torch.log1p(torch.exp(-prediction.abs()))).mean()
        return {"bce_loss": loss}

    def manipulation_sample(self, ddim_style, classifier_weight, encoder,
                            decoder, x_0, inferred_x_T, latents_mean,
                            latents_std, class_id: int, scale: float):
        """Move the normalized latent along the class's unit weight row by
        ``scale * sqrt(512)`` and shift-decode ``inferred_x_T`` with it.
        ``sqrt(512)`` whatever the latent dim, as the reference has it; the
        norm's 1e-12 floor keeps a zero row a zero edit."""
        z_norm = self.normalize(encoder(x_0), latents_mean, latents_std)
        w = classifier_weight[class_id][None, :]
        w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp_min(1e-12)
        z_manipulated = self.denormalize(z_norm + scale * math.sqrt(512) * w,
                                         latents_mean, latents_std)
        return self.representation_learning_ddim_sample(
            ddim_style, None, decoder, None, inferred_x_T, z_manipulated,
            stop_percent=0.0)
