"""ctypes binding for the native JPEG decode and triangle resize
(``csrc/image_decode.cpp``): the port of ``pdae_tpu/data/native_image.py``.

ctypes calls release the GIL, so decoding in the loader's thread pool scales
with its workers. The resize is PIL.Image.BILINEAR's antialiased triangle
filter and matches PIL within +/-1 uint8 step (rounding). It is the default
decode path of 3-channel LMDB datasets (``fast_decode: false`` opts out); PIL
takes over where the library does not build (no g++ or libjpeg) or the input
is not a JPEG. The library is built with the JAX package's flags
(``utils/_host_build.py``), so both packages decode the same pixels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

SOURCE = "image_decode.cpp"


def _declare(lib) -> None:
    lib.pdae_jpeg_decode.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.pdae_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.pdae_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.pdae_resize_triangle.restype = ctypes.c_int
    lib.pdae_resize_triangle.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]


def _lib():
    from ..utils import _host_build
    return _host_build.load(SOURCE, _declare)


def available() -> bool:
    return _lib() is not None


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> RGB uint8 [H, W, 3]; None if not decodable natively."""
    lib = _lib()
    if lib is None or len(data) < 3 or data[:2] != b"\xff\xd8":
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    ptr = lib.pdae_jpeg_decode(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        return None
    try:
        buf = ctypes.cast(ptr, ctypes.POINTER(
            ctypes.c_uint8 * (w.value * h.value * 3))).contents
        arr = np.frombuffer(buf, np.uint8).reshape(h.value, w.value, 3).copy()
    finally:
        lib.pdae_buffer_free(ptr)
    return arr


def resize_triangle(img: np.ndarray, size: int) -> np.ndarray:
    """PIL-BILINEAR-style antialiased resize of an RGB uint8 array to
    ``size`` x ``size``."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native image library is unavailable")
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_triangle takes an RGB [H, W, 3] array, got {img.shape}")
    sh, sw = img.shape[:2]
    if (sh, sw) == (size, size):
        return img
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.pdae_resize_triangle(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), sw, sh,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size, size)
    if rc != 0:
        raise RuntimeError("native resize failed")
    return out


def load_jpeg_resized(data: bytes, size: int, crop=None) -> Optional[np.ndarray]:
    """Decode -> optional (top, left, h, w) crop -> resize. None where the
    native path cannot take the input (the caller falls back to PIL)."""
    arr = decode_jpeg(data)
    if arr is None:
        return None
    if crop is not None:
        top, left, ch, cw = crop
        arr = arr[top:top + ch, left:left + cw]
    return resize_triangle(arr, size)
