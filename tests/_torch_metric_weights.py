"""Seeded weights at the metric backbones' full published widths, in
``pdae_tpu``'s flat layouts, for the tests of the port's LPIPS and
InceptionV3 (``tests/test_torch_backbones.py``, ``tests/test_torch_dist.py``);
the pretrained files are not in the repository."""

import numpy as np

from pdae_tpu.metrics.lpips import _ALEX, _CHANNELS
from test_inception import inception_weight_spec


def seeded_inception(seed=0):
    """The torchvision channel table (``tests/test_inception.py``) with
    He-scaled conv kernels (HWIO) and BN statistics near 1 and 0: features
    that depend on the input (the small uniform init of that test's
    ``random_params`` gives every image the same features)."""
    rs = np.random.RandomState(seed)
    p = {}
    for k, shape in inception_weight_spec().items():
        if k.endswith(".conv.weight"):
            kh, kw, ci, _ = shape
            p[k] = rs.randn(*shape) * np.sqrt(2.0 / (kh * kw * ci))
        elif k.endswith(("running_var", "bn.weight")):
            p[k] = rs.uniform(0.5, 1.5, shape)
        else:
            p[k] = 0.1 * rs.randn(*shape)
    return {k: v.astype(np.float32) for k, v in p.items()}


def seeded_lpips(seed=0):
    """AlexNet 64-192-384-256-256 (He-scaled HWIO kernels) and non-negative
    ``lin`` weights, as ``pdae_tpu``'s flat file holds them."""
    rs = np.random.RandomState(seed)
    p, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(_ALEX):
        p[f"conv{i}_w"] = (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                           ).astype(np.float32)
        p[f"conv{i}_b"] = (0.1 * rs.randn(cout)).astype(np.float32)
        cin = cout
    for i, c in enumerate(_CHANNELS):
        p[f"lin{i}_w"] = (np.abs(rs.randn(c)) / c).astype(np.float32)
    return p
