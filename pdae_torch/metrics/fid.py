"""FID: the Frechet distance between two Gaussians fitted to feature sets
(``pdae_tpu/metrics/fid.py``, whose functions are copied here unchanged:
scipy's ``sqrtm``, the ``eps`` retry and the imaginary-part check, float64
statistics, fixed chunks of 64).

The features are InceptionV3 pool3 (``metrics/inception.py``), from the
converted TF-FID weights that ``inception_path`` names; any callable
``features(images_uint8_nhwc) -> [N, D]`` serves in their place.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
from scipy import linalg

from ..parallel import gather_objects
from .base import BaseMetric


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("non-negligible imaginary component "
                             f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix, in float64."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def chunked_features(feature_fn, images: np.ndarray, chunk: int = 64) -> np.ndarray:
    """``feature_fn`` over chunks of exactly ``chunk`` images: the last is
    padded by repeating its first image and the padding's rows dropped. One
    chunk bounds InceptionV3's activation memory, whatever the set's size."""
    n = len(images)
    if n == 0:
        raise ValueError("no images for feature extraction")
    if n <= chunk:
        pad = chunk - n
        if pad:
            images = np.concatenate([images, np.repeat(images[:1], pad, axis=0)], axis=0)
        return np.asarray(feature_fn(images))[:n]
    return np.concatenate([chunked_features(feature_fn, images[i:i + chunk], chunk)
                           for i in range(0, n, chunk)], axis=0)


class FIDMetric(BaseMetric):
    """Features of generated images, accumulated per process and gathered
    (the features, not the images), against target statistics: a ``.npz``
    of mu and sigma, or those of a reference feature matrix."""

    def __init__(self, feature_fn: Callable[[np.ndarray], np.ndarray],
                 target_mu: Optional[np.ndarray] = None,
                 target_sigma: Optional[np.ndarray] = None):
        super().__init__()
        self.feature_fn = feature_fn
        self.target_mu = target_mu
        self.target_sigma = target_sigma
        self.features = []

    @classmethod
    def from_stats_file(cls, feature_fn, path: str) -> "FIDMetric":
        data = np.load(path)
        return cls(feature_fn, data["mu"], data["sigma"])

    def process(self, images_uint8: np.ndarray):
        self.features.append(chunked_features(self.feature_fn, images_uint8))

    def all_gather_results(self):
        self.features = gather_objects(self.features)

    def set_target_from_images(self, images_uint8: np.ndarray):
        self.target_mu, self.target_sigma = activation_statistics(
            chunked_features(self.feature_fn, images_uint8))

    def compute_metrics(self) -> float:
        mu, sigma = activation_statistics(np.concatenate(self.features, axis=0))
        if self.target_mu is None:
            raise ValueError("FID target statistics not set")
        return frechet_distance(mu, sigma, self.target_mu, self.target_sigma)


def save_stats(path: str, features: np.ndarray) -> None:
    mu, sigma = activation_statistics(features)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, mu=mu, sigma=sigma)


def inception_feature_fn(inception_path: Optional[str] = None, device=None):
    """``features(images_uint8_nhwc) -> [N, 2048]`` (numpy in and out),
    InceptionV3 pool3 on ``device`` (the card unless named) from the weights
    at ``inception_path``; raises, naming the file, where there is none."""
    if not inception_path or not os.path.exists(inception_path):
        raise FileNotFoundError(
            f"TF-FID InceptionV3 weights not found at {inception_path!r}: convert the "
            "pt_inception-2015-12-05 weights with python -m pdae_torch.convert "
            "--inception and pass the file as inception_path")
    from .inception import load_inception_feature_fn
    return load_inception_feature_fn(inception_path, device)
