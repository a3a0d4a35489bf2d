"""[-1, 1] <-> uint8 image conversions, NHWC numpy (as ``pdae_tpu.utils.image``)."""

from __future__ import annotations

import numpy as np


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 NHWC."""
    x = np.asarray(x, dtype=np.float32)
    x = (x + 1.0) * 127.5
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def from_uint8(x: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> [-1,1] float32 NHWC."""
    return np.asarray(x, dtype=np.float32) / 127.5 - 1.0
