"""LMDB environments without the ``lmdb`` binding: the port's copy of
``pdae_tpu/data/lmdb_store.py``.

The reference reads its image datasets from LMDB environments through the
``lmdb`` C binding; the port parses the on-disk format directly, as the JAX
package does: ``Reader``, an mmap'd B+tree in pure Python with ``get``,
``items`` and ``__len__``; ``NativeReader``, the C++ reader of
``csrc/lmdb_reader.cpp`` behind the same ``get``/``__len__``/``close``; and
``write_lmdb``/``write_lmdb_stream``, which pack sorted items into a fresh
environment whose ``data.mdb`` is byte-equal to the JAX package's for the same
items and page size.

Format notes (the public LMDB layout of mdb.c, 64-bit, little endian):
  * pages of ``mm_psize`` bytes; pages 0 and 1 hold MDB_meta; the live
    meta is the one with the larger txnid
  * page header: pgno u64, pad u16, flags u16, lower u16, upper u16
  * flags: BRANCH=0x01 LEAF=0x02 OVERFLOW=0x04 META=0x08 LEAF2=0x20
  * node: lo u16, hi u16, flags u16, ksize u16, key bytes, data bytes;
    branch nodes pack the child pgno into (lo, hi, flags-as-hi16);
    leaf nodes with F_BIGDATA=0x01 store an 8-byte overflow pgno
  * meta: magic 0xBEEFC0DE, version 1, address, mapsize, dbs[2]
    (md_pad/u32 holds the page size in dbs[0]), last_pg, txnid;
    dbs[1] is the main DB whose md_root is the B+tree root.

``open_lmdb`` reads through the C++ reader where g++ builds it
(``utils/_host_build.py``, at first use) and through ``Reader`` where it does
not; both give the same bytes.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01

PAGE_HDR = 16  # pgno(8) pad(2) flags(2) lower(2) upper(2)
NODE_HDR = 8   # lo(2) hi(2) flags(2) ksize(2)
META_FMT = "<IIQQ" + "IHHQQQQQ" * 2 + "QQ"  # magic ver addr mapsize dbs[2] lastpg txnid


class LMDBError(RuntimeError):
    pass


class Reader:
    """Read-only LMDB environment (subdir layout ``<path>/data.mdb`` or a
    direct file path)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        self.psize: int = meta["psize"]
        self.entries: int = meta["entries"]
        self.depth: int = meta["depth"]   # B+tree depth (diagnostics)
        self._root: int = meta["root"]

    # -- meta ---------------------------------------------------------- #

    def _parse_meta(self, off: int) -> Optional[dict]:
        # meta body sits after the page header
        body = off + PAGE_HDR
        try:
            vals = struct.unpack_from(META_FMT, self._mm, body)
        except struct.error:
            return None
        magic, version = vals[0], vals[1]
        if magic != MAGIC or version != VERSION:
            return None
        # dbs[0] starts at index 4: pad flags depth branch leaf ovf entries root
        psize = vals[4]
        main = vals[12:20]  # dbs[1]
        return {
            "psize": psize,
            "depth": main[2],
            "entries": main[6],
            "root": main[7],
            "txnid": vals[21],
        }

    def _pick_meta(self) -> dict:
        m0 = self._parse_meta(0)
        if m0 is None:
            raise LMDBError("not an LMDB file (bad meta page 0)")
        m1 = self._parse_meta(m0["psize"])
        if m1 is not None and m1["txnid"] > m0["txnid"]:
            return m1
        return m0

    # -- pages --------------------------------------------------------- #

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + PAGE_HDR > len(self._mm):
            raise LMDBError(f"page {pgno} out of range")
        return off

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self._mm, off + 10)[0]

    def _num_keys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        return (lower - PAGE_HDR) >> 1

    def _node_off(self, page_off: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self._mm, page_off + PAGE_HDR + 2 * i)[0]
        return page_off + ptr

    def _node(self, page_off: int, i: int) -> Tuple[bytes, int, int, int]:
        """Returns (key, flags, lo, hi) plus implicit data location."""
        off = self._node_off(page_off, i)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, off)
        key = bytes(self._mm[off + NODE_HDR: off + NODE_HDR + ksize])
        return key, flags, lo, hi, off, ksize

    def _branch_child(self, page_off: int, i: int) -> int:
        key, flags, lo, hi, off, ksize = self._node(page_off, i)
        return lo | (hi << 16) | (flags << 32)

    def _leaf_data(self, page_off: int, i: int) -> bytes:
        key, flags, lo, hi, off, ksize = self._node(page_off, i)
        dsize = lo | (hi << 16)
        data_off = off + NODE_HDR + ksize
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", self._mm, data_off)[0]
            ovf_off = self._page(ovf_pgno)
            return bytes(self._mm[ovf_off + PAGE_HDR: ovf_off + PAGE_HDR + dsize])
        return bytes(self._mm[data_off: data_off + dsize])

    # -- lookup -------------------------------------------------------- #

    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == 0xFFFFFFFFFFFFFFFF:  # P_INVALID: empty db
            return None
        off = self._page(self._root)
        while True:
            flags = self._page_flags(off)
            n = self._num_keys(off)
            if flags & P_BRANCH:
                # first branch key is empty; find rightmost node whose
                # key <= target
                lo_i, hi_i, pos = 1, n - 1, 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k = self._node(off, mid)[0]
                    if k <= key:
                        pos = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                off = self._page(self._branch_child(off, pos))
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k = self._node(off, mid)[0]
                    if k == key:
                        return self._leaf_data(off, mid)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise LMDBError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over all (key, value) pairs."""
        if self._root == 0xFFFFFFFFFFFFFFFF:
            return
        stack = [self._page(self._root)]
        # depth-first with explicit ordering
        def walk(off):
            flags = self._page_flags(off)
            n = self._num_keys(off)
            if flags & P_BRANCH:
                for i in range(n):
                    yield from walk(self._page(self._branch_child(off, i)))
            elif flags & P_LEAF:
                for i in range(n):
                    yield self._node(off, i)[0], self._leaf_data(off, i)
        yield from walk(stack[0])

    def __len__(self) -> int:
        return self.entries

    def close(self):
        self._mm.close()
        self._f.close()


# ---------------------------------------------------------------------- #
# writer: a single-commit environment, built bottom-up
# ---------------------------------------------------------------------- #


def write_lmdb(path: str, items: Dict[bytes, bytes], psize: int = 4096,
               subdir: bool = True) -> str:
    """Create a fresh LMDB environment containing ``items`` (a dict)."""
    return write_lmdb_stream(path, iter(sorted(items.items())), psize=psize,
                             subdir=subdir)


def write_lmdb_stream(path: str, sorted_items, psize: int = 4096,
                      subdir: bool = True) -> str:
    """Create a fresh LMDB environment from an ITERATOR of sorted
    ``(key, value)`` pairs, streaming pages to disk.

    Bottom-up B+tree build: sorted keys packed into leaf pages (values too
    big for a page go to overflow pages), then branch levels until a single
    root.  Meta 0 carries txnid 1; meta 1 left older.

    Peak memory is one leaf's worth of values plus ~(key + 16 bytes) per
    LEAF (not per item) for the branch build, so a multi-million-image LSUN
    pack (``python -m pdae_torch.prepare_lmdb``) never holds the whole
    dataset in RAM.  Keys must arrive in sorted order (raises ValueError otherwise);
    zero-padded ``%05d``/``%07d`` key formats generate them sorted.
    """
    if subdir:
        os.makedirs(path, exist_ok=True)
        file_path = os.path.join(path, "data.mdb")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        file_path = path

    f = open(file_path, "wb")
    try:
        _write_stream_pages(f, sorted_items, psize)
    except BaseException:
        # don't leave a partially written data.mdb (zeroed meta pages read
        # as a corrupt database) at the destination -- e.g. prepare_lmdb's
        # item iterator hitting one bad image millions of entries in
        f.close()
        try:
            os.unlink(file_path)
        except OSError:
            pass
        raise
    f.close()
    return file_path


def _write_stream_pages(f, sorted_items, psize: int) -> None:
    f.write(b"\x00" * (2 * psize))  # meta placeholders, patched at the end
    next_pg = [2]
    n_ovf = [0]
    n_entries = [0]

    def page_header(pgno, flags, lower, upper):
        return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)

    def alloc(raw: bytes) -> int:
        pgno = next_pg[0]
        f.write(raw)
        next_pg[0] += 1
        return pgno

    def leaf_budget(n_in_chunk):
        # max node size that still fits: conservative half-page
        return psize // 2 - PAGE_HDR

    def build_leaf(chunk: List[Tuple[bytes, bytes]]) -> int:
        ptrs = []
        # nodes are appended from the page end downward
        upper = psize
        for k, v in chunk:
            big = NODE_HDR + len(k) + len(v) > leaf_budget(len(chunk))
            if big:
                ovf_pages = -(-(len(v) + PAGE_HDR) // psize)
                first = next_pg[0]
                # overflow page header uses the page count in lower/upper
                data = struct.pack("<QHHI", first, 0, P_OVERFLOW, ovf_pages)
                payload = data + v
                payload += b"\x00" * (ovf_pages * psize - len(payload))
                for i in range(ovf_pages):
                    alloc(payload[i * psize:(i + 1) * psize])
                n_ovf[0] += ovf_pages
                node = struct.pack("<HHHH", len(v) & 0xFFFF,
                                   (len(v) >> 16) & 0xFFFF, F_BIGDATA,
                                   len(k)) + k + struct.pack("<Q", first)
            else:
                node = struct.pack("<HHHH", len(v) & 0xFFFF,
                                   (len(v) >> 16) & 0xFFFF, 0, len(k)) + k + v
            if len(node) % 2:
                node += b"\x00"
            upper -= len(node)
            ptrs.append((upper, node))
        lower = PAGE_HDR + 2 * len(chunk)
        assert lower <= upper, "leaf overflow: chunk too large"
        buf = bytearray(psize)
        buf[:PAGE_HDR] = page_header(next_pg[0], P_LEAF, lower,
                                     min(u for u, _ in ptrs))
        for i, (off, node) in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGE_HDR + 2 * i, off)
            buf[off:off + len(node)] = node
        return alloc(bytes(buf))

    def build_branch(children: List[Tuple[bytes, int]]) -> int:
        ptrs = []
        upper = psize
        for idx, (k, child) in enumerate(children):
            kk = b"" if idx == 0 else k  # first branch key is implicit/empty
            node = struct.pack("<HHHH", child & 0xFFFF,
                               (child >> 16) & 0xFFFF,
                               (child >> 32) & 0xFFFF, len(kk)) + kk
            if len(node) % 2:
                node += b"\x00"
            upper -= len(node)
            ptrs.append((upper, node))
        lower = PAGE_HDR + 2 * len(children)
        assert lower <= upper, "branch overflow"
        buf = bytearray(psize)
        buf[:PAGE_HDR] = page_header(next_pg[0], P_BRANCH, lower,
                                     min(u for u, _ in ptrs))
        for i, (off, node) in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGE_HDR + 2 * i, off)
            buf[off:off + len(node)] = node
        return alloc(bytes(buf))

    # stream items into greedily-filled leaves; only the CURRENT leaf's
    # items are held in memory
    n_leaf = 0
    n_branch = 0
    depth = 1
    leaves: List[Tuple[bytes, int]] = []
    chunk: List[Tuple[bytes, bytes]] = []
    used = 0
    prev_key = None
    for k, v in sorted_items:
        if prev_key is not None and k <= prev_key:
            raise ValueError(f"write_lmdb_stream requires strictly sorted "
                             f"keys; got {k!r} after {prev_key!r}")
        prev_key = k
        n_entries[0] += 1
        node_sz = NODE_HDR + len(k) + (
            8 if NODE_HDR + len(k) + len(v) > leaf_budget(1) else len(v))
        node_sz += node_sz % 2 + 2  # ptr slot
        if chunk and PAGE_HDR + used + node_sz > psize:
            leaves.append((chunk[0][0], build_leaf(chunk)))
            chunk, used = [], 0
        chunk.append((k, v))
        used += node_sz
    if chunk:
        leaves.append((chunk[0][0], build_leaf(chunk)))
    n_leaf = len(leaves)

    if leaves:
        level = leaves
        while len(level) > 1:
            depth += 1
            nxt = []
            group: List[Tuple[bytes, int]] = []
            used = 0
            for k, child in level:
                node_sz = NODE_HDR + len(k) + (len(k) % 2) + 2
                if group and PAGE_HDR + used + node_sz > psize:
                    nxt.append((group[0][0], build_branch(group)))
                    n_branch += 1
                    group, used = [], 0
                group.append((k, child))
                used += node_sz
            if group:
                nxt.append((group[0][0], build_branch(group)))
                n_branch += 1
            level = nxt
        root = level[0][1]
    else:
        root = 0xFFFFFFFFFFFFFFFF

    # meta pages (seek back over the placeholders)
    def meta_page(pgno, txnid):
        buf = bytearray(psize)
        buf[:PAGE_HDR] = page_header(pgno, P_META, 0, 0)
        main_db = (0, 0, depth if n_leaf else 0, n_branch, n_leaf,
                   n_ovf[0], n_entries[0], root)
        free_db = (psize, 0, 0, 0, 0, 0, 0, 0xFFFFFFFFFFFFFFFF)
        struct.pack_into(META_FMT, buf, PAGE_HDR, MAGIC, VERSION, 0,
                         psize * max(next_pg[0], 16),
                         *free_db, *main_db, next_pg[0] - 1, txnid)
        return bytes(buf)

    f.seek(0)
    f.write(meta_page(0, 1))
    f.write(meta_page(1, 0))


# ---------------------------------------------------------------------- #
# native (C++) reader binding
# ---------------------------------------------------------------------- #


def _declare(lib) -> None:
    lib.pdae_lmdb_open.restype = ctypes.c_void_p
    lib.pdae_lmdb_open.argtypes = [ctypes.c_char_p]
    lib.pdae_lmdb_entries.restype = ctypes.c_uint64
    lib.pdae_lmdb_entries.argtypes = [ctypes.c_void_p]
    lib.pdae_lmdb_get.restype = ctypes.c_int
    lib.pdae_lmdb_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
    lib.pdae_lmdb_close.argtypes = [ctypes.c_void_p]


def native_lib():
    """The C++ reader's library, built at first use; None where g++ cannot
    build it (``utils._host_build.build_logs`` says why)."""
    from ..utils import _host_build
    return _host_build.load("lmdb_reader.cpp", _declare)


class NativeReader:
    """The C++ mmap reader (``csrc/lmdb_reader.cpp``) behind the Reader API.
    ``get`` copies the value out of the map before it returns, so the bytes
    stay valid after the next call and after ``close``."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        lib = native_lib()
        if lib is None:
            raise LMDBError("native reader unavailable")
        self._lib = lib
        self._h = lib.pdae_lmdb_open(path.encode())
        if not self._h:
            raise LMDBError(f"native open failed: {path}")
        self._path = path

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over all (key, value) pairs, through the
        pure-Python parser: the C++ reader has no cursor."""
        reader = Reader(self._path)
        try:
            yield from reader.items()
        finally:
            reader.close()

    def get(self, key: bytes) -> Optional[bytes]:
        val = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        rc = self._lib.pdae_lmdb_get(self._h, key, len(key), ctypes.byref(val),
                                     ctypes.byref(vlen))
        if rc == -1:
            return None
        if rc != 0:
            raise LMDBError(f"native get failed rc={rc}")
        return ctypes.string_at(val, vlen.value)

    def __len__(self) -> int:
        return int(self._lib.pdae_lmdb_entries(self._h))

    def close(self):
        if self._h:
            self._lib.pdae_lmdb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_lmdb(path: str, prefer_native: bool = True):
    """The reference-compatible entry point: a reader over ``path`` (an
    environment directory holding ``data.mdb``, or the file itself), the C++
    one where it builds and opens the file, the pure-Python one otherwise."""
    if prefer_native and native_lib() is not None:
        try:
            return NativeReader(path)
        except LMDBError:
            pass
    return Reader(path)
