"""Gaussian diffusion: the PDAE autoencoding and training entry points.

Port of the part of ``pdae_tpu/diffusion/gaussian.py`` that serving and the
representation-learning train step run: the schedules, the shift-DDIM
sample/encode/autoencode methods, ``q_sample``, ``p_loss`` and the training
batch. The model is a plain callable: ``decoder(x_t, t, z) -> (eps, gradient)``
and ``encoder(x_0) -> z``. Randomness comes from an explicit
``torch.Generator`` (the JAX package threads ``jax.random`` keys), or is
injected.
"""

from __future__ import annotations

import torch

from . import ddim as ddim_lib
from .schedules import DDIMSchedule, extract, make_ddim_schedule, make_schedule


class GaussianDiffusion:
    """Holds the schedule tables. ``config``: ``{"timesteps": int,
    "betas_type": "linear" | "cosine"}``."""

    def __init__(self, config: dict):
        self.timesteps = int(config["timesteps"])
        self.betas_type = config["betas_type"]
        self.schedule = make_schedule(self.betas_type, self.timesteps)

    def q_sample(self, x_0, t, noise):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_0.dim()) * x_0
                + extract(s.sqrt_one_minus_alphas_cumprod, t, x_0.dim()) * noise)

    @staticmethod
    def p_loss(noise, predicted_noise, weight=None, loss_type="l2"):
        if loss_type == "l1":
            return (noise - predicted_noise).abs().mean()
        if loss_type == "l2":
            if weight is not None:
                return (weight * (noise - predicted_noise) ** 2).mean()
            return ((noise - predicted_noise) ** 2).mean()
        raise NotImplementedError(loss_type)

    def representation_learning_train_one_batch(self, generator, encoder, decoder,
                                                x_0, *, t=None, noise=None):
        """The PDAE loss of one batch: the SNR-weighted l2 between the noise
        and ``eps + shift_coef * gradient``. ``t`` (int ``[B]``) and ``noise``
        may be injected for deterministic parity tests; by default they are
        drawn from ``generator`` on its own device."""
        batch = x_0.shape[0]
        z = encoder(x_0)
        if t is None:
            t = torch.randint(0, self.timesteps, (batch,), generator=generator,
                              device=generator.device,
                              dtype=torch.int32).to(x_0.device)
        if noise is None:
            noise = torch.randn(x_0.shape, generator=generator,
                                device=generator.device,
                                dtype=x_0.dtype).to(x_0.device)
        x_t = self.q_sample(x_0, t, noise)
        predicted_noise, gradient = decoder(x_t, t, z)
        shift_coef = extract(self.schedule.shift_coef, t, x_0.dim())
        weight = extract(self.schedule.weight, t, x_0.dim())
        loss = self.p_loss(noise, predicted_noise + shift_coef * gradient,
                           weight=weight)
        return {"prediction_loss": loss}

    def ddim_schedule(self, ddim_style: str) -> DDIMSchedule:
        return make_ddim_schedule(self.schedule.alphas_cumprod.numpy(), ddim_style)

    @staticmethod
    def _check_style(style: str) -> None:
        if style.startswith("dpm"):
            raise NotImplementedError(
                f"{style!r}: the DPM-Solver++ loops are not ported yet "
                "(ROADMAP.md, queue 1 item 4, DPM-Solver part); use a "
                "ddim<N> style")

    def representation_learning_ddim_sample(self, ddim_style, encoder, decoder,
                                            x_0, x_T, z=None, stop_percent=0.0):
        self._check_style(ddim_style)
        if z is None:
            z = encoder(x_0)
        return ddim_lib.shift_ddim_sample_loop(
            self.ddim_schedule(ddim_style), decoder, z, x_T,
            stop_percent=stop_percent)

    def representation_learning_ddim_encode(self, ddim_style, encoder, decoder,
                                            x_0, z=None):
        self._check_style(ddim_style)
        if z is None:
            z = encoder(x_0)
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
