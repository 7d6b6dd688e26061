"""Minimal pure-Python read-only LMDB reader for LSUN archives.

The reference loads LSUN through torchvision's LMDB-backed dataset class
(the reference's utils/mydataset.py:132-141: `datasets.LSUN(path,
classes=['church_outdoor_train'], ...)`), which needs the `lmdb` C extension.
This module needs neither torchvision nor py-lmdb: it parses the on-disk
LMDB format directly — read-only, single data.mdb file, full-scan iteration
(all an in-memory preload dataset needs).

Format notes (derived from the LMDB file-format spec / mdb.c layout, 64-bit
little-endian files as produced by the stock liblmdb the LSUN distribution
uses):

  * pages 0 and 1 are meta pages; each holds an MDB_meta after the 16-byte
    page header: magic 0xBEEFC0DE, version, address, mapsize, two MDB_db
    records (FREE_DBI and MAIN_DBI), last_pg, txnid. The live meta is the
    one with the larger txnid. The page size is stored in the FREE_DBI
    record's md_pad field.
  * an MDB_db record is md_pad u32, md_flags u16, md_depth u16, then
    branch/leaf/overflow page counts, md_entries, md_root (all u64).
  * data pages: 16-byte header {pgno u64, pad u16, flags u16, lower u16,
    upper u16}; flags 0x01=branch, 0x02=leaf, 0x04=overflow, 0x20=LEAF2.
    The node-offset array (u16 each) starts at byte 16; node count is
    (lower - 16) / 2.
  * a node is {lo u16, hi u16, flags u16, ksize u16, key[ksize], ...}.
    Leaf: datasize = lo | hi<<16; inline data follows the key, unless node
    flag 0x01 (F_BIGDATA) in which case an u64 overflow-page number follows
    the key and the data lives contiguously after that page's header
    (overflow header stores the page-span count at bytes 12..16).
    Branch: child page = lo | hi<<16 | flags<<32 (keys ordered, child 0
    covers everything below key 1).

LSUN values are JPEG/WebP-encoded images; keys are opaque hashes. This
reader walks the MAIN_DBI B+tree depth-first (leftmost first), yielding
(key, value) in key order — byte-identical to what `lmdb` cursors return.

A copy of masked_diffusion_tpu/data/lmdb_reader.py; the port imports nothing
of the JAX package. tests/test_torch_port_lmdb.py holds it equal to the
original on the same archives.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Tuple

_MAGIC = 0xBEEFC0DE
_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_LEAF2 = 0x20
_F_BIGDATA = 0x01
_P_INVALID = 0xFFFFFFFFFFFFFFFF
_PAGE_HDR = 16


class LMDBFormatError(ValueError):
    pass


class LMDBReader:
    """Read-only iterator over the main database of one LMDB environment.

    `path` may be the environment directory (containing data.mdb — the
    torchvision-LSUN layout, e.g. church_outdoor_train_lmdb/) or the
    data.mdb file itself.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        self.path = path
        self._f = open(path, "rb")
        try:
            self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:  # zero-length file
            self._f.close()
            raise LMDBFormatError(f"{path}: empty file") from e
        self.psize, self.entries, self._root = self._read_meta()

    # ------------------------------------------------------------------ meta
    def _meta_at(self, base: int):
        """Parse one meta page; returns (psize, entries, root, txnid) or None."""
        meta = self._m[base + _PAGE_HDR : base + _PAGE_HDR + 136]
        if len(meta) < 136:
            return None
        magic, _version = struct.unpack_from("<II", meta, 0)
        if magic != _MAGIC:
            return None
        # layout after magic+version: address u64, mapsize u64, then
        # MDB_db FREE_DBI at 24 and MAIN_DBI at 72; entries/root are the
        # last two u64 of each 48-byte record; txnid at 128
        psize = struct.unpack_from("<I", meta, 24)[0]
        entries, root = struct.unpack_from("<QQ", meta, 72 + 32)
        txnid = struct.unpack_from("<Q", meta, 128)[0]
        return psize, entries, root, txnid

    def _read_meta(self) -> Tuple[int, int, int]:
        m0 = self._meta_at(0)
        if m0 is None:
            raise LMDBFormatError(f"{self.path}: bad LMDB magic on meta page 0")
        psize = m0[0]
        if psize < 512 or psize > (1 << 16) or psize & (psize - 1):
            raise LMDBFormatError(f"{self.path}: implausible page size {psize}")
        m1 = self._meta_at(psize)  # meta page 1 sits one page in
        best = m0 if (m1 is None or m0[3] >= m1[3]) else m1
        return psize, best[1], best[2]

    # ------------------------------------------------------------------ pages
    def _page(self, pgno: int) -> Tuple[int, int, int, memoryview]:
        base = pgno * self.psize
        if base + _PAGE_HDR > len(self._m):
            raise LMDBFormatError(f"{self.path}: page {pgno} out of range")
        flags, lower, upper = struct.unpack_from("<HHH", self._m, base + 10)
        return base, flags, lower, memoryview(self._m)

    def _iter_page(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        base, flags, lower, m = self._page(pgno)
        if flags & _P_LEAF2:
            raise LMDBFormatError("LEAF2 (fixed-key) pages unsupported")
        n_nodes = max(0, (lower - _PAGE_HDR) // 2)
        for i in range(n_nodes):
            (noff,) = struct.unpack_from("<H", m, base + _PAGE_HDR + 2 * i)
            node = base + noff
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", m, node)
            key = bytes(m[node + 8 : node + 8 + ksize])
            if flags & _P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
            elif flags & _P_LEAF:
                dsize = lo | (hi << 16)
                dstart = node + 8 + ksize
                if nflags & _F_BIGDATA:
                    (ovf,) = struct.unpack_from("<Q", m, dstart)
                    obase = ovf * self.psize
                    data = bytes(m[obase + _PAGE_HDR : obase + _PAGE_HDR + dsize])
                else:
                    data = bytes(m[dstart : dstart + dsize])
                yield key, data
            else:
                raise LMDBFormatError(
                    f"{self.path}: page {pgno} has unexpected flags {flags:#x}"
                )

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """(key, value) pairs in key order."""
        if self._root == _P_INVALID:
            return
        yield from self._iter_page(self._root)

    def __len__(self) -> int:
        return int(self.entries)

    def close(self) -> None:
        self._m.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
