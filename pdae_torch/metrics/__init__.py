"""Reconstruction metrics of the sampler suite: the port of
``pdae_tpu/metrics/{base,ssim,mse}.py``. LPIPS and FID need pretrained
backbones and are not ported (ROADMAP.md, queue 1 item 13)."""

from .base import BaseMetric
from .mse import MSEMetric, mse
from .ssim import SSIMMetric, ssim

__all__ = ["BaseMetric", "MSEMetric", "mse", "SSIMMetric", "ssim"]
