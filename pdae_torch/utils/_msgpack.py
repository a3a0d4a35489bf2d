"""The subset of msgpack that flax's ``msgpack_serialize``/``msgpack_restore``
write and read, in pure Python: the port's checkpoint codec.

``pdae_tpu`` stores every checkpoint as ``flax.serialization.msgpack_serialize``
of a nested dict with numpy leaves. This module writes the same bytes for the
same tree and reads such files back, without flax or the ``msgpack`` package:

* maps with str keys, written in sorted key order (flax's
  ``msgpack_serialize`` passes the tree through ``jax.tree_util.tree_map``,
  which sorts dict keys); str, bin, int, float (float64), bool and nil;
  arrays from lists (a sharded checkpoint's manifest and piece starts);
* ``ExtType(1)``: an ndarray, as ``packb((shape, dtype.name, C-order
  bytes))``; ``ExtType(3)``: a numpy scalar, the same body;
* arrays above ``MAX_CHUNK_SIZE`` bytes in flax's chunked form
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat[:n], ...}}``, whose keys keep that insertion order;
* an empty dict (optax's ``EmptyState`` after ``to_state_dict``) as an
  empty map.

Arrays go out as one ``bin`` each, from the array's own memory, so the cost
is per leaf, not per byte. ``bfloat16`` and complex leaves raise by name: the
port's checkpoints hold fp32, int32 and bool leaves.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: read at call time, so a test can lower it
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3     # flax's ext codes (2, complex: not read)


def _check_dtype(dtype: np.dtype) -> None:
    if dtype.name == "bfloat16":
        raise TypeError("bfloat16 leaves are not supported by the port's "
                        "checkpoint codec")
    if dtype.kind == "c":
        raise TypeError(f"complex leaves ({dtype.name}) are not supported by the "
                        "port's checkpoint codec")
    if dtype.hasobject or dtype.fields is not None or dtype.kind in "VUS":
        raise TypeError(f"dtype {dtype} cannot be serialized")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff), (0xcf, ">Q", 2 ** 64 - 1)):
            if v <= top:
                return bytes((code,)) + struct.pack(fmt, v)
        raise OverflowError(f"integer {v} does not fit in 64 bits")
    if v >= -32:
        return struct.pack(">b", v)
    for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                           (0xd2, ">i", -0x80000000), (0xd3, ">q", -2 ** 63)):
        if v >= low:
            return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a str/bin/array/map of ``n`` items: the fix form where one
    exists, else the 8/16/32-bit length forms in ``codes``."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, fmt, top in codes:
        if code is not None and n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} items/bytes is too large")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xa0, 31, ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                                       (0xdb, ">I", 0xffffffff))) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                               (0xc6, ">I", 0xffffffff)))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, ((None, "", 0), (0xdc, ">H", 0xffff),
                                (0xdd, ">I", 0xffffffff)))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, ((None, "", 0), (0xde, ">H", 0xffff),
                                (0xdf, ">I", 0xffffffff)))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes((fixed[n], code))
    for c, fmt, top in ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                        (0xc9, ">I", 0xffffffff)):
        if n <= top:
            return bytes((c,)) + struct.pack(fmt, n) + bytes((code,))
    raise ValueError(f"an ext body of {n} bytes is too large")


def _ndarray(arr: np.ndarray, code: int, out: List) -> None:
    _check_dtype(arr.dtype)
    if not arr.flags.c_contiguous:        # (np.ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    head = (b"\x93" + _array_header(arr.ndim) + b"".join(_int(int(d)) for d in arr.shape)
            + _str(arr.dtype.name) + _bin_header(arr.nbytes))
    out.append(_ext_header(code, len(head) + arr.nbytes) + head)
    if arr.nbytes:
        out.append(memoryview(arr.reshape(-1).view(np.uint8)))


def _chunk(arr: np.ndarray, out: List) -> None:
    """flax's ``_chunk``: the flat array cut into MAX_CHUNK_SIZE-byte pieces."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    out.append(_map_header(3) + _str(_CHUNKED) + b"\xc3" + _str("shape")
               + _map_header(arr.ndim))
    for i, d in enumerate(arr.shape):
        out.append(_str(str(i)) + _int(int(d)))
    out.append(_str("chunks") + _map_header(len(chunks)))
    for i, c in enumerate(chunks):
        out.append(_str(str(i)))
        _ndarray(c, _EXT_NDARRAY, out)


def _pack(obj: Any, out: List, chunk_ok: bool) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        if chunk_ok and obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _chunk(obj, out)
        else:
            _ndarray(obj, _EXT_NDARRAY, out)
    elif isinstance(obj, np.generic):
        _ndarray(np.asarray(obj), _EXT_NPSCALAR, out)
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out.append(_bin_header(len(obj)) + obj)
    elif type(obj) is list:
        out.append(_array_header(len(obj)))
        for v in obj:
            _pack(v, out, True)
    elif type(obj) is dict:
        keys = sorted(obj)
        if not all(type(k) is str for k in keys):
            raise TypeError("checkpoint dict keys must be str")
        out.append(_map_header(len(keys)))
        for k in keys:
            out.append(_str(k))
            _pack(obj[k], out, True)
    elif type(obj) is complex:
        raise TypeError("complex leaves are not supported by the port's checkpoint "
                        "codec")
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} in a checkpoint")


def pack_pieces(tree: Any) -> List:
    """The encoding of ``tree`` as a list of bytes-like pieces (arrays as
    memoryviews of their own data, not copies)."""
    out: List = []
    _pack(tree, out, isinstance(tree, dict))
    return out


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    return b"".join(pack_pieces(tree))


# --------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------- #

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.raw = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.buf[p:p + n]

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.bin_length(b)))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b], {0xc7: 1, 0xc8: 2, 0xc9: 4}[b])
            code = self.take(1)[0]
            return self.ext(code, n)
        if b in (0xca, 0xcb):
            return float(self.unpack(">f", 4) if b == 0xca else self.unpack(">d", 8))
        if 0xcc <= b <= 0xd3:
            fmt, n = {0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
                      0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4),
                      0xd3: (">q", 8)}[b]
            return self.unpack(fmt, n)
        if 0xd4 <= b <= 0xd8:
            code = self.take(1)[0]
            return self.ext(code, 1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            n = self.unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b], {0xd9: 1, 0xda: 2, 0xdb: 4}[b])
            return str(self.take(n), "utf-8")
        if b in (0xdc, 0xdd):
            n = self.unpack(">H" if b == 0xdc else ">I", 2 if b == 0xdc else 4)
            return [self.value() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I", 2 if b == 0xde else 4))
        raise ValueError(f"msgpack type byte {b:#x} is not supported")

    def bin_length(self, b: int) -> int:
        if b not in (0xc4, 0xc5, 0xc6):
            raise ValueError(f"expected a msgpack bin, got type byte {b:#x}")
        return self.unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b],
                           {0xc4: 1, 0xc5: 2, 0xc6: 4}[b])

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise TypeError(f"msgpack ext type {code} is not supported by the port's "
                            "checkpoint codec")
        # (shape, dtype name, bin): the bin is read in place, not copied
        if self.take(1)[0] != 0x93:
            raise ValueError("malformed ndarray ext")
        shape, name = self.value(), self.value()
        if name == "bfloat16" or name.startswith("complex"):
            raise TypeError(f"{name} leaves are not supported by the port's "
                            "checkpoint codec")
        nbytes = self.bin_length(self.take(1)[0])
        start = self.pos
        self.take(nbytes)
        if self.pos != end:
            raise ValueError("malformed ndarray ext (length mismatch)")
        dtype = np.dtype(name)
        arr = np.frombuffer(self.raw, dtype=dtype, count=nbytes // dtype.itemsize,
                            offset=start).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(node):
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for k, v in node.items():
            if isinstance(v, dict):
                node[k] = _unchunk(v)
    return node


def unpackb(data) -> Any:
    """``flax.serialization.msgpack_restore(data)``: arrays come back as
    read-only views of ``data``, numpy scalars as numpy scalars, chunked
    arrays joined."""
    if not isinstance(data, bytes):
        data = bytes(data)
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)
