"""Gaussian diffusion: the PDAE autoencoding entry points.

Port of the part of ``pdae_tpu/diffusion/gaussian.py`` that serving runs:
the schedules and the shift-DDIM sample/encode/autoencode methods. The model
is a plain callable: ``decoder(x_t, t, z) -> (eps, gradient)`` and
``encoder(x_0) -> z``.
"""

from __future__ import annotations

from . import ddim as ddim_lib
from .schedules import DDIMSchedule, make_ddim_schedule, make_schedule


class GaussianDiffusion:
    """Holds the schedule tables. ``config``: ``{"timesteps": int,
    "betas_type": "linear" | "cosine"}``."""

    def __init__(self, config: dict):
        self.timesteps = int(config["timesteps"])
        self.betas_type = config["betas_type"]
        self.schedule = make_schedule(self.betas_type, self.timesteps)

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
