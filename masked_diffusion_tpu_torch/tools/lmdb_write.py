"""Write a minimal LMDB environment (one data.mdb) for test fixtures.

The layout follows the LMDB file format, as tests/test_lmdb.py's writer
lays it out: 4096-byte pages with 16-byte headers, two meta pages (a stale
one at txnid 1 and the live one at txnid 2, so that a reader must choose by
txnid), sorted node-offset arrays, one branch page over two leaves when
asked, and F_BIGDATA overflow chains for values that do not fit a node.

This is for fixtures only: the port's tests and chip_smoke.py write the
LSUN archives they read with it. No loader calls it; the product code is
the reader, data/lmdb_reader.py.

    write_lmdb(path, {key: value}, use_branch=False, bigdata_keys=())

writes path/data.mdb and returns path.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable

PSIZE = 4096
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF


def _page_header(pgno: int, flags: int, lower: int, upper: int) -> bytes:
    return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)


def _node(lo: int, hi: int, nflags: int, key: bytes, payload: bytes = b"") -> bytes:
    body = struct.pack("<HHHH", lo, hi, nflags, len(key)) + key + payload
    if len(body) % 2:
        body += b"\x00"
    return body


def _build_page(pgno: int, flags: int, nodes) -> bytes:
    """Pack nodes (pre-packed, in key order) bottom-up from the page's top,
    the offset array after the header."""
    if 16 + 2 * len(nodes) + sum(len(nb) for nb in nodes) > PSIZE:
        raise ValueError(f"page {pgno}: {len(nodes)} nodes do not fit {PSIZE} bytes")
    placed = []  # (offset, node) in key order
    upper = PSIZE
    for nb in reversed(nodes):
        upper -= len(nb)
        placed.append((upper, nb))
    placed.reverse()
    page = bytearray(PSIZE)
    page[:16] = _page_header(pgno, flags, 16 + 2 * len(nodes), upper)
    for i, (off, nb) in enumerate(placed):
        struct.pack_into("<H", page, 16 + 2 * i, off)
        page[off : off + len(nb)] = nb
    return bytes(page)


def _meta_page(pgno: int, root: int, entries: int, last_pg: int, txnid: int,
               depth: int = 1) -> bytes:
    db_free = struct.pack("<IHHQQQQQ", PSIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
    db_main = struct.pack("<IHHQQQQQ", 0, 0, depth, 0, 1, 0, entries, root)
    meta = (
        struct.pack("<II", 0xBEEFC0DE, 1)
        + struct.pack("<QQ", 0, PSIZE * (last_pg + 1))
        + db_free
        + db_main
        + struct.pack("<QQ", last_pg, txnid)
    )
    page = bytearray(PSIZE)
    page[:16] = _page_header(pgno, P_META, 0, 0)
    page[16 : 16 + len(meta)] = meta
    return bytes(page)


def write_lmdb(path: str, items: Dict[bytes, bytes], use_branch: bool = False,
               bigdata_keys: Iterable[bytes] = ()) -> str:
    """Write items ({key: value} bytes) as path/data.mdb: one leaf page, or
    with use_branch a branch page over two leaves. A value in bigdata_keys,
    or one larger than a third of a page with its node, goes to an overflow
    chain, as LMDB spills values that do not fit a node."""
    os.makedirs(path, exist_ok=True)
    bigdata_keys = set(bigdata_keys)
    keys = sorted(items)
    pages: Dict[int, bytes] = {}
    next_pg = 2

    def put_overflow(data: bytes) -> int:
        nonlocal next_pg
        n_pages = -(-(len(data) + 16) // PSIZE)
        pgno = next_pg
        blob = bytearray(n_pages * PSIZE)
        blob[:16] = struct.pack("<QHHI", pgno, 0, P_OVERFLOW, n_pages)
        blob[16 : 16 + len(data)] = data
        for i in range(n_pages):
            pages[pgno + i] = bytes(blob[i * PSIZE : (i + 1) * PSIZE])
        next_pg += n_pages
        return pgno

    def leaf_nodes(subkeys):
        # overflow pages are allocated while the nodes are packed, so every
        # node list is built before a tree page gets its number
        nodes = []
        for k in subkeys:
            v = items[k]
            if k in bigdata_keys or (8 + len(k) + len(v)) > PSIZE // 3:
                nodes.append(_node(len(v) & 0xFFFF, len(v) >> 16, F_BIGDATA, k,
                                   struct.pack("<Q", put_overflow(v))))
            else:
                nodes.append(_node(len(v) & 0xFFFF, len(v) >> 16, 0, k, v))
        return nodes

    if not use_branch:
        nodes = leaf_nodes(keys)
        root = next_pg
        next_pg += 1
        pages[root] = _build_page(root, P_LEAF, nodes)
        depth = 1
    else:
        half = len(keys) // 2
        nodes_a, nodes_b = leaf_nodes(keys[:half]), leaf_nodes(keys[half:])
        leaf_a, leaf_b = next_pg, next_pg + 1
        root = next_pg + 2
        next_pg += 3
        pages[leaf_a] = _build_page(leaf_a, P_LEAF, nodes_a)
        pages[leaf_b] = _build_page(leaf_b, P_LEAF, nodes_b)
        pages[root] = _build_page(root, P_BRANCH, [
            _node(leaf_a & 0xFFFF, (leaf_a >> 16) & 0xFFFF, leaf_a >> 32, b""),
            _node(leaf_b & 0xFFFF, (leaf_b >> 16) & 0xFFFF, leaf_b >> 32, keys[half]),
        ])
        depth = 2

    last_pg = next_pg - 1
    blob = bytearray(PSIZE * (last_pg + 1))
    blob[0:PSIZE] = _meta_page(0, P_INVALID, 0, 1, txnid=1)
    blob[PSIZE : 2 * PSIZE] = _meta_page(1, root, len(keys), last_pg, txnid=2, depth=depth)
    for pgno, pg in pages.items():
        blob[pgno * PSIZE : pgno * PSIZE + len(pg)] = pg
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(bytes(blob))
    return path
