"""Per-image MSE on [0,1] images, in numpy float64 (``pdae_tpu/metrics/mse.py``).
The layout does not matter: each image's mean runs over all its values."""

from __future__ import annotations

import numpy as np

from .base import BaseMetric


def mse(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    d = np.asarray(img1, np.float64) - np.asarray(img2, np.float64)
    return (d * d).reshape(d.shape[0], -1).mean(axis=1)


class MSEMetric(BaseMetric):
    def process(self, images: np.ndarray, gts: np.ndarray):
        self.results.extend(float(v) for v in mse(images, gts))
