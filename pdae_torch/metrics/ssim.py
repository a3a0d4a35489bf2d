"""SSIM with the reference's construction (``pdae_tpu/metrics/ssim.py``): an
11x11 Gaussian window of sigma 1.5, a per-channel "same" convolution with
zero padding, C1 = (0.01 * range)^2 and C2 = (0.03 * range)^2, on
[0,1]-scaled images.

The port takes NCHW tensors and convolves on their device with
``F.conv2d(..., groups=C)``: a plain convolution, which the JAX package also
computes outside any kernel of its own."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base import BaseMetric


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """x: [N,C,H,W]; per-channel 'same' convolution with the window."""
    c = x.shape[1]
    k = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(x, k, padding=window.shape[-1] // 2, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of two fp32 [N,C,H,W] batches in [0,1]: the mean over everything,
    or one value per image when not ``size_average``."""
    w = torch.from_numpy(_gaussian_window(window_size, sigma)).to(img1.device)
    mu1 = _depthwise_blur(img1, w)
    mu2 = _depthwise_blur(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, w) - mu12
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


class SSIMMetric(BaseMetric):
    """Per-sample SSIM accumulation."""

    def process(self, images: torch.Tensor, gts: torch.Tensor):
        """images/gts: fp32 [N,C,H,W] in [0,1], on one device."""
        vals = ssim(images, gts, size_average=False)
        self.results.extend(float(v) for v in vals.cpu())
