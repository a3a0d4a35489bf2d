"""The metrics of the sampler suite: the port of ``pdae_tpu/metrics``. SSIM
and MSE of reconstructions, LPIPS (AlexNet), and FID over InceptionV3 pool3
features; the backbones load converted pretrained weights, which the
repository does not ship."""

from .base import BaseMetric
from .fid import (FIDMetric, activation_statistics, frechet_distance, inception_feature_fn,
                  save_stats)
from .lpips import LPIPSMetric, lpips_distance
from .mse import MSEMetric, mse
from .ssim import SSIMMetric, ssim

__all__ = [
    "BaseMetric", "FIDMetric", "activation_statistics", "frechet_distance",
    "inception_feature_fn", "save_stats", "LPIPSMetric", "lpips_distance",
    "MSEMetric", "mse", "SSIMMetric", "ssim",
]
