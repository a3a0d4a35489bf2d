"""The port's SSIM and MSE against ``pdae_tpu.metrics`` on the CPU (LPIPS,
FID and the gather across processes: ``tests/test_torch_backbones.py`` and
``tests/test_torch_dist.py``).

SSIM: the same 11x11 window, zero padding and constants in both packages;
the convolutions sum in another order, so values agree within 1e-6. MSE is
numpy float64 in both, so it agrees bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdae_tpu.metrics import MSEMetric as JaxMSEMetric
from pdae_tpu.metrics import SSIMMetric as JaxSSIMMetric
from pdae_tpu.metrics import mse as jax_mse
from pdae_tpu.metrics import ssim as jax_ssim
from pdae_torch.metrics import MSEMetric, SSIMMetric, mse, ssim

torch.set_num_threads(1)


def _pairs(n, h, c, seed):
    """Two [N,H,W,C] batches in [0, 1]: one random, one near it."""
    rs = np.random.RandomState(seed)
    a = rs.uniform(0, 1, (n, h, h, c)).astype(np.float32)
    b = np.clip(a + 0.1 * rs.randn(n, h, h, c), 0, 1).astype(np.float32)
    return a, b


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("h", [16, 7])          # above and below the 11x11 window
@pytest.mark.parametrize("c", [1, 3])
def test_ssim_matches_jax(c, h, size_average):
    a, b = _pairs(3, h, c, seed=10 * c + h)
    want = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average))
    got = ssim(_nchw(a), _nchw(b), size_average=size_average).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ssim_of_an_image_with_itself_is_one():
    a, _ = _pairs(2, 16, 3, seed=0)
    np.testing.assert_allclose(ssim(_nchw(a), _nchw(a), size_average=False).numpy(), 1.0,
                               atol=1e-6)


def test_ssim_metric_matches_jax():
    port, jax_metric = SSIMMetric(), JaxSSIMMetric()
    for seed in (1, 2):
        a, b = _pairs(2, 16, 3, seed)
        port.process(_nchw(a), _nchw(b))
        jax_metric.process(a, b)
    assert len(port) == len(jax_metric) == 4
    np.testing.assert_allclose(port.results, jax_metric.results, rtol=0, atol=1e-6)
    assert abs(port.compute_metrics() - jax_metric.compute_metrics()) <= 1e-6


def test_mse_and_its_metric_equal_jax_bit_for_bit():
    a, b = _pairs(4, 8, 3, seed=3)
    np.testing.assert_array_equal(mse(a, b), jax_mse(a, b))
    port, jax_metric = MSEMetric(), JaxMSEMetric()
    port.process(a, b)
    jax_metric.process(a, b)
    port.all_gather_results()
    assert port.results == jax_metric.results
    assert port.compute_metrics() == jax_metric.compute_metrics()
