"""LMDB read/write without liblmdb: a memory-mapped B+tree reader and a
bulk (sorted, single-txn) writer for the on-disk format.

A copy of the JAX package's `data/lmdb_io.py` (the port imports nothing
of that package): the machine that runs the port has no lmdb binding
either.  The reference reads Caffe LMDBs through lmdbjni inside a custom
Spark RDD (`caffe-grid/.../LmdbRDD.scala:97-155`: txn cursor iteration,
key-range partitioning :41-95); here the format itself is implemented:

  * ``LmdbReader`` — mmap the data file, locate the live meta page
    (higher txnid of pages 0/1), walk the main DB's B+tree; supports
    full scans, ``seek(key)``, and key-range partitioning for the
    LmdbRDD-style sharded read.
  * ``LmdbWriter`` — bottom-up bulk build of leaf/branch/overflow pages
    from sorted records + twin meta pages; produces files this reader
    (and liblmdb) can open.  Used by chip_smoke.py and test fixtures.

Format notes (64-bit layout): 16-byte page header {pgno u64, pad u16,
flags u16, lower u16, upper u16}; meta page = header + {magic 0xBEEFC0DE,
version 1, address, mapsize, dbs[2] (48B each: pad/flags/depth/branch/
leaf/overflow/entries/root — dbs[0].pad doubles as the page size),
last_pg, txnid}; leaf/branch nodes = {lo u16, hi u16, flags u16,
ksize u16, key..., data...} with node offsets in a u16 array after the
header; branch pgno packed in lo|hi<<16|flags<<32; F_BIGDATA (0x01)
nodes store an 8-byte overflow pgno instead of inline data.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

PAGE_HDR = 16
META_OFF = PAGE_HDR  # MDB_meta starts after the page header


def _db_record(buf, off) -> dict:
    pad, flags, depth = struct.unpack_from("<IHH", buf, off)
    branch, leaf, overflow, entries, root = struct.unpack_from(
        "<QQQQQ", buf, off + 8)
    return dict(pad=pad, flags=flags, depth=depth, branch=branch,
                leaf=leaf, overflow=overflow, entries=entries, root=root)


class LmdbReader:
    """Read-only scan/seek over an LMDB main database."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        try:
            self._map = mmap.mmap(self._f.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError as e:           # empty file
            self._f.close()
            raise ValueError(f"{path}: not an LMDB data file: {e}") \
                from e
        try:
            self._read_meta(path)
        except (struct.error, IndexError, OverflowError) as e:
            self.close()
            raise self._corrupt(e) from e
        except BaseException:     # bad magic etc. — no fd/mmap leak
            self.close()
            raise

    def _corrupt(self, e: BaseException) -> ValueError:
        """Malformed files surface as ValueError — the readers' one
        documented failure mode (mirrors proto.descriptor); a corrupt
        byte must never leak struct.error or recurse forever."""
        return ValueError(f"{self.path}: corrupt LMDB file: "
                          f"{type(e).__name__}: {e}")

    def _read_meta(self, path: str) -> None:
        m = self._map
        metas = []
        for pg in (0, 1):
            off = pg * 4096 + META_OFF  # meta pages are at most 4096 apart?
            # page size unknown before reading meta; try offset with the
            # minimum page size first, re-derive after
            magic, version = struct.unpack_from("<II", m, off)
            if magic != MAGIC:
                continue
            dbs0 = _db_record(m, off + 24)
            psize = dbs0["pad"] or 4096
            main = _db_record(m, off + 72)
            last_pg, txnid = struct.unpack_from("<QQ", m, off + 120)
            metas.append((txnid, psize, main))
        if not metas:
            raise ValueError(f"{path}: not an LMDB data file (bad magic)")
        metas.sort()
        txnid, self.psize, self.main = metas[-1]
        # page-1 meta lives at offset psize, not 4096 — re-read if needed
        if self.psize != 4096:
            metas = []
            for pg in (0, 1):
                off = pg * self.psize + META_OFF
                magic, version = struct.unpack_from("<II", m, off)
                if magic != MAGIC:
                    continue
                main = _db_record(m, off + 72)
                _, txnid = struct.unpack_from("<QQ", m, off + 120)
                metas.append((txnid, main))
            metas.sort()
            self.main = metas[-1][1]
        self.entries = int(self.main["entries"])

    def close(self):
        self._map.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- page access -------------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """Returns (base_offset, flags, lower, upper)."""
        base = pgno * self.psize
        _, _, flags, lower, upper = struct.unpack_from(
            "<QHHHH", self._map, base)
        return base, flags, lower, upper

    def _num_keys(self, lower: int) -> int:
        return (lower - PAGE_HDR) // 2

    def _node(self, base: int, idx: int) -> int:
        (ptr,) = struct.unpack_from("<H", self._map,
                                    base + PAGE_HDR + 2 * idx)
        return base + ptr

    def _leaf_kv(self, base: int, idx: int) -> Tuple[bytes, bytes]:
        m = self._map
        noff = self._node(base, idx)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", m, noff)
        dsize = lo | (hi << 16)
        key = bytes(m[noff + 8:noff + 8 + ksize])
        if flags & F_BIGDATA:
            (opgno,) = struct.unpack_from("<Q", m, noff + 8 + ksize)
            obase = opgno * self.psize
            data = bytes(m[obase + PAGE_HDR:obase + PAGE_HDR + dsize])
        else:
            doff = noff + 8 + ksize
            data = bytes(m[doff:doff + dsize])
        return key, data

    def _branch_child(self, base: int, idx: int) -> Tuple[bytes, int]:
        m = self._map
        noff = self._node(base, idx)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", m, noff)
        pgno = lo | (hi << 16) | (flags << 32)
        key = bytes(m[noff + 8:noff + 8 + ksize])
        return key, pgno

    # -- iteration ---------------------------------------------------------

    def items(self, start_key: Optional[bytes] = None,
              stop_key: Optional[bytes] = None
              ) -> Iterator[Tuple[bytes, bytes]]:
        """Sorted (key, value) pairs in [start_key, stop_key)."""
        root = int(self.main["root"])
        if root == 2 ** 64 - 1:  # P_INVALID: empty db
            return
        try:
            yield from self._walk(root, start_key, stop_key, set())
        except (struct.error, IndexError, OverflowError,
                RecursionError) as e:
            raise self._corrupt(e) from e

    def _walk(self, pgno, start_key, stop_key, seen):
        if pgno in seen:
            # a corrupted child pointer forming a page cycle would
            # otherwise recurse/loop forever
            raise ValueError(
                f"{self.path}: corrupt LMDB file: page cycle at "
                f"pgno {pgno}")
        seen.add(pgno)
        base, flags, lower, upper = self._page(pgno)
        n = self._num_keys(lower)
        if flags & P_LEAF:
            for i in range(n):
                k, v = self._leaf_kv(base, i)
                if start_key is not None and k < start_key:
                    continue
                if stop_key is not None and k >= stop_key:
                    return
                yield k, v
        elif flags & P_BRANCH:
            for i in range(n):
                _, child = self._branch_child(base, i)
                # subtree key range pruning via separator keys
                if start_key is not None and i + 1 < n:
                    nxt_key, _ = self._branch_child(base, i + 1)
                    if nxt_key and nxt_key <= start_key:
                        continue
                if stop_key is not None and i > 0:
                    this_key, _ = self._branch_child(base, i)
                    if this_key and this_key >= stop_key:
                        return
                yield from self._walk(child, start_key, stop_key, seen)
        else:
            raise ValueError(f"unexpected page flags {flags:#x}")

    def keys(self) -> Iterator[bytes]:
        for k, _ in self.items():
            yield k

    def partition_ranges(self, num_partitions: int
                         ) -> List[Tuple[Optional[bytes], Optional[bytes]]]:
        """Split the key space into ~equal ranges (LmdbRDD.scala:41-95
        analog: scan keys, emit [start, stop) bounds per partition)."""
        if num_partitions <= 1:
            return [(None, None)]
        ks = list(self.keys())
        n = num_partitions
        bounds: List[Tuple[Optional[bytes], Optional[bytes]]] = []
        # exactly n ranges, each rank a DISTINCT (possibly empty) slice:
        # an empty range is (k, k) — items() is [start, stop) so it
        # yields nothing — rather than being dropped, which would alias
        # ranks onto the same keys via `rank % len(ranges)`
        for i in range(n):
            si = i * len(ks) // n
            ei = (i + 1) * len(ks) // n
            if si >= ei:
                k0 = ks[0] if ks else b""
                bounds.append((k0, k0))
                continue
            lo = None if si == 0 else ks[si]
            hi = None if ei >= len(ks) else ks[ei]
            bounds.append((lo, hi))
        return bounds


class LmdbWriter:
    """Bulk-build an LMDB file from sorted (key, value) records."""

    def __init__(self, path: str, psize: int = 4096):
        if os.path.isdir(path) or path.endswith(os.sep) or "." not in \
                os.path.basename(path):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        self.path = path
        self.psize = psize
        self._pages: List[bytes] = []  # data pages, pgno = index + 2

    # node byte size (8-byte header + key + inline data, even-aligned)
    def _leaf_node(self, key: bytes, data: bytes, *,
                   overflow_pgno: Optional[int] = None) -> bytes:
        if overflow_pgno is None:
            body = struct.pack("<HHHH", len(data) & 0xFFFF,
                               len(data) >> 16, 0, len(key)) + key + data
        else:
            body = struct.pack("<HHHH", len(data) & 0xFFFF,
                               len(data) >> 16, F_BIGDATA, len(key)) \
                + key + struct.pack("<Q", overflow_pgno)
        if len(body) % 2:
            body += b"\x00"
        return body

    def _branch_node(self, key: bytes, pgno: int) -> bytes:
        body = struct.pack("<HHHH", pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                           (pgno >> 32) & 0xFFFF, len(key)) + key
        if len(body) % 2:
            body += b"\x00"
        return body

    def _flush_page(self, flags: int, nodes: List[bytes]) -> int:
        """Pack nodes into one page; returns pgno."""
        psize = self.psize
        pgno = len(self._pages) + 2
        ptrs = []
        off = psize
        payload = bytearray(psize)
        for nb in nodes:
            off -= len(nb)
            payload[off:off + len(nb)] = nb
            ptrs.append(off)
        lower = PAGE_HDR + 2 * len(nodes)
        assert lower <= off, "page overflow"
        struct.pack_into("<QHHHH", payload, 0, pgno, 0, flags, lower, off)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", payload, PAGE_HDR + 2 * i, p)
        self._pages.append(bytes(payload))
        return pgno

    def _flush_overflow(self, data: bytes) -> int:
        psize = self.psize
        pgno = len(self._pages) + 2
        npages = (PAGE_HDR + len(data) + psize - 1) // psize
        buf = bytearray(npages * psize)
        struct.pack_into("<QHHI", buf, 0, pgno, 0, P_OVERFLOW, npages)
        buf[PAGE_HDR:PAGE_HDR + len(data)] = data
        for i in range(npages):
            self._pages.append(bytes(buf[i * psize:(i + 1) * psize]))
        return pgno

    def write(self, records: List[Tuple[bytes, bytes]]) -> None:
        records = sorted(records)
        psize = self.psize
        max_inline = (psize - PAGE_HDR) // 2 - 16  # conservative node cap
        leaf_stats = dict(leaf=0, overflow=0, branch=0)

        # ---- leaves ----
        level: List[Tuple[bytes, int]] = []  # (first_key, pgno)
        nodes: List[bytes] = []
        used = PAGE_HDR
        first_key = None
        for k, v in records:
            if len(v) + len(k) + 8 > max_inline:
                opg = self._flush_overflow(v)
                leaf_stats["overflow"] += 1
                nb = self._leaf_node(k, v, overflow_pgno=opg)
            else:
                nb = self._leaf_node(k, v)
            if nodes and used + len(nb) + 2 > psize:
                pg = self._flush_page(P_LEAF, nodes)
                leaf_stats["leaf"] += 1
                level.append((first_key, pg))
                nodes, used, first_key = [], PAGE_HDR, None
            if first_key is None:
                first_key = k
            nodes.append(nb)
            used += len(nb) + 2
        if nodes:
            pg = self._flush_page(P_LEAF, nodes)
            leaf_stats["leaf"] += 1
            level.append((first_key, pg))

        # ---- branches (bottom-up) ----
        depth = 1
        while len(level) > 1:
            nxt: List[Tuple[bytes, int]] = []
            nodes, used, first_key = [], PAGE_HDR, None
            for i, (k, pg) in enumerate(level):
                bk = b"" if not nodes else k  # leftmost branch key empty
                nb = self._branch_node(bk, pg)
                if nodes and used + len(nb) + 2 > psize:
                    bpg = self._flush_page(P_BRANCH, nodes)
                    leaf_stats["branch"] += 1
                    nxt.append((first_key, bpg))
                    nodes, used = [], PAGE_HDR
                    nb = self._branch_node(b"", pg)
                    first_key = k
                if first_key is None:
                    first_key = k
                nodes.append(nb)
                used += len(nb) + 2
            if nodes:
                bpg = self._flush_page(P_BRANCH, nodes)
                leaf_stats["branch"] += 1
                nxt.append((first_key, bpg))
            level = nxt
            depth += 1

        root = level[0][1] if level else 2 ** 64 - 1
        if not records:
            depth = 0

        # ---- metas ----
        last_pg = len(self._pages) + 1
        mapsize = (last_pg + 1) * psize

        def meta(txnid: int) -> bytes:
            buf = bytearray(psize)
            struct.pack_into("<QHHHH", buf, 0, txnid & 1, 0, P_META, 0, 0)
            o = META_OFF
            struct.pack_into("<II", buf, o, MAGIC, VERSION)
            struct.pack_into("<QQ", buf, o + 8, 0, mapsize)
            # dbs[0] (free db): pad carries psize
            struct.pack_into("<IHH", buf, o + 24, psize, 0, 0)
            struct.pack_into("<QQQQQ", buf, o + 32, 0, 0, 0, 0,
                             2 ** 64 - 1)
            # dbs[1] (main db)
            struct.pack_into("<IHH", buf, o + 72, 0, 0, depth)
            struct.pack_into("<QQQQQ", buf, o + 80,
                             leaf_stats["branch"], leaf_stats["leaf"],
                             leaf_stats["overflow"], len(records), root)
            struct.pack_into("<QQ", buf, o + 120, last_pg, txnid)
            return bytes(buf)

        with open(self.path, "wb") as f:
            f.write(meta(0))
            f.write(meta(1))
            for p in self._pages:
                f.write(p)
