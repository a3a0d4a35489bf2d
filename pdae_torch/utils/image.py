"""[-1, 1] <-> uint8 image conversions, NHWC numpy, and sample grids written
as PNG (as ``pdae_tpu.utils.image``). The PNG writer uses ``zlib`` and
``struct`` alone, so saving a grid needs no imaging package."""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 NHWC."""
    x = np.asarray(x, dtype=np.float32)
    x = (x + 1.0) * 127.5
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def from_uint8(x: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> [-1,1] float32 NHWC."""
    return np.asarray(x, dtype=np.float32) / 127.5 - 1.0


def x0_from_transfer(x):
    """A batch's ``x_0`` as it crossed to the device -> float [-1, 1].

    A uint8 tensor (``transfer_uint8``: the raw pixels, 4x fewer bytes to
    move) becomes ``x.float() / 255.0 * 2.0 - 1.0`` in fp32 on its own
    device: the datasets' host op sequence, so the result is bit-equal to
    the host-side float normalisation. Any other tensor passes unchanged."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0 * 2.0 - 1.0
    return x


def make_grid(images: np.ndarray, nrow: Optional[int] = None,
              pad: int = 2, pad_value: int = 255) -> np.ndarray:
    """Tile a [N,H,W,C] uint8 batch into one image array."""
    images = np.asarray(images)
    assert images.dtype == np.uint8 and images.ndim == 4
    n, h, w, c = images.shape
    if nrow is None:
        nrow = int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    grid = np.full((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   pad_value, dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def png_bytes(image: np.ndarray) -> bytes:
    """An 8-bit [H,W] (gray), [H,W,1] or [H,W,3] (RGB) uint8 array as PNG
    bytes: one IDAT of zlib-deflated rows, each with filter type 0."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"a PNG needs [H,W] or [H,W,3] uint8, got {image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write ``image`` (as ``png_bytes`` takes it) to ``path``."""
    data = png_bytes(image)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_image_grid(images: np.ndarray, path: str, nrow: Optional[int] = None,
                    gts: Optional[np.ndarray] = None) -> np.ndarray:
    """Save a sample grid PNG; with ``gts`` interleave ground-truth rows (a gt
    then its result, two to a row). Returns the grid written."""
    if gts is not None:
        stacked = []
        for g, im in zip(gts, images):
            stacked.extend([g, im])
        images = np.stack(stacked)
        nrow = nrow or 2
    grid = make_grid(images, nrow=nrow)
    write_png(path, grid)
    return grid


def paste_rows(rows: Sequence[np.ndarray], path: str) -> np.ndarray:
    """Paste ``[N,H,W,C]`` uint8 rows, each tiled in one line, top to bottom
    into one PNG; a row narrower than the widest is padded with white on the
    right. Returns the image written."""
    row_imgs = [make_grid(r, nrow=r.shape[0]) for r in rows]
    wmax = max(r.shape[1] for r in row_imgs)
    padded = []
    for r in row_imgs:
        if r.shape[1] < wmax:
            pad = np.full((r.shape[0], wmax - r.shape[1], r.shape[2]), 255, np.uint8)
            r = np.concatenate([r, pad], axis=1)
        padded.append(r)
    merged = np.concatenate(padded, axis=0)
    write_png(path, merged)
    return merged
