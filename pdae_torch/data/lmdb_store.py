"""A read-only LMDB reader in pure Python: the port's copy of the reader in
``pdae_tpu/data/lmdb_store.py``.

The reference reads its image datasets from LMDB environments through the
``lmdb`` C binding; the port parses the on-disk format directly, as the JAX
package does: an mmap'd B+tree with ``get``, ``items`` and ``__len__``.

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

The JAX package's C++ reader (``native/``) is built at run time and is not
part of a checkout, so the port reads through this one alone.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

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


def open_lmdb(path: str) -> Reader:
    """The reference-compatible entry point: a reader over ``path`` (an
    environment directory holding ``data.mdb``, or the file itself)."""
    return Reader(path)
