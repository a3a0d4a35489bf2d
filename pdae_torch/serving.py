"""Batched PDAE inference on one card: ``encode``, ``autoencode``, ``decode``.

Port of ``pdae_tpu/serving.py::PDAEService`` for the ops that need only the
PDAE stage (encoder + ShiftUNet decoder). Images go in and come out NHWC as
in the JAX service; the models run NCHW on ``device``. Batches are padded to
power-of-two buckets (capped at ``max_batch``) by repeating the first image,
and trimmed on the way out.

The service is built from configs and state dicts held in memory (no
checkpoint files, no mesh). It runs fp32, as the JAX service builds float32
models, with TF32 off: the constructor sets ``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` to ``False`` for the whole
process, so convs and matmuls keep full fp32 mantissas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .diffusion import GaussianDiffusion
from .models import build_decoder, build_encoder
from .utils import to_uint8


def _bucket(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch."""
    return min(1 << max(0, (n - 1)).bit_length(), max_batch)


class PDAEService:
    """Resident PDAE inference.

    ``config`` keys: ``trained_ddpm_config`` (the UNet geometry of the
    pre-trained DPM), ``decoder_config`` and ``encoder_config`` (each with
    ``latent_dim``), optional ``diffusion_config`` (default linear, 1000
    steps), ``image_size``, ``image_channel`` (3), ``max_batch`` (64),
    ``encoder_ddim_style``/``decoder_ddim_style`` (``ddim100``).
    ``encoder_state``/``decoder_state`` are state
    dicts in the reference layout (``pdae_torch.utils.convert``).
    ``device``: ``cuda`` unless given; without a card it must be given.
    """

    def __init__(self, config: dict, encoder_state: dict, decoder_state: dict,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.size = int(config["image_size"])
        self.channels = int(config.get("image_channel", 3))
        self.max_batch = int(config.get("max_batch", 64))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.gd = GaussianDiffusion(config.get(
            "diffusion_config", {"timesteps": 1000, "betas_type": "linear"}))
        self.encoder = build_encoder(config["encoder_config"], image_size=self.size)
        self.decoder = build_decoder(config["decoder_config"],
                                     config["trained_ddpm_config"])
        for model, state in ((self.encoder, encoder_state),
                             (self.decoder, decoder_state)):
            model.load_state_dict(state, strict=True)
            model.to(self.device).eval()

    # -- helpers --------------------------------------------------------- #

    def _to_model_input(self, images):
        """uint8 (or float in [-1, 1]) NHWC -> padded fp32 NCHW on the device,
        and the number of real images."""
        arr = np.asarray(images)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0 * 2.0 - 1.0
        arr = np.asarray(arr, np.float32)
        n = arr.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")
        if arr.shape[1:] != (self.size, self.size, self.channels):
            raise ValueError(f"images must be [N, {self.size}, {self.size}, "
                             f"{self.channels}], got {arr.shape}")
        b = _bucket(n, self.max_batch)
        if b > n:
            arr = np.concatenate([arr, np.repeat(arr[:1], b - n, axis=0)], axis=0)
        x = torch.from_numpy(arr).to(self.device).permute(0, 3, 1, 2).contiguous()
        return x, n

    @staticmethod
    def _to_nhwc(x: torch.Tensor, n: int) -> np.ndarray:
        """The first n images of a model output as NHWC numpy; a non-finite
        value raises here rather than turn into pixels."""
        x = x[:n]
        if not torch.isfinite(x).all():
            raise FloatingPointError("the model produced non-finite values")
        return x.permute(0, 2, 3, 1).cpu().numpy()

    # -- ops ------------------------------------------------------------- #

    @torch.inference_mode()
    def encode(self, images) -> np.ndarray:
        """images -> semantic latents z ``[N, latent_dim]``."""
        x, n = self._to_model_input(images)
        return self.encoder(x)[:n].cpu().numpy()

    @torch.inference_mode()
    def autoencode(self, images, encode_style: Optional[str] = None,
                   decode_style: Optional[str] = None) -> np.ndarray:
        """images -> reconstructions (uint8 NHWC)."""
        es = encode_style or self.config.get("encoder_ddim_style", "ddim100")
        ds = decode_style or self.config.get("decoder_ddim_style", "ddim100")
        x, n = self._to_model_input(images)
        out = self.gd.representation_learning_autoencoding(
            es, ds, self.encoder, self.decoder, x)
        return to_uint8(self._to_nhwc(out, n))

    @torch.inference_mode()
    def decode(self, z, x_T, decode_style: Optional[str] = None,
               stop_percent: float = 0.0) -> np.ndarray:
        """(z ``[N, latent_dim]``, x_T NHWC) -> images (uint8 NHWC)."""
        ds = decode_style or self.config.get("decoder_ddim_style", "ddim100")
        x, n = self._to_model_input(np.asarray(x_T, np.float32))
        zz = np.asarray(z, np.float32)
        if zz.shape[0] != n:
            raise ValueError(f"{zz.shape[0]} latents for {n} images")
        if x.shape[0] > n:
            zz = np.concatenate([zz, np.repeat(zz[:1], x.shape[0] - n, axis=0)])
        out = self.gd.representation_learning_ddim_sample(
            ds, None, self.decoder, None, x, torch.from_numpy(zz).to(self.device),
            stop_percent=stop_percent)
        return to_uint8(self._to_nhwc(out, n))
