"""Minimal LevelDB: the `data_param.backend: LEVELDB` path.

The port's copy of `caffeonspark_tpu/data/leveldb_io.py`: databases
written by either package read identically in the other, and the two
writers give the same bytes.

Caffe's Data layer reads either LMDB or LevelDB databases of serialized
`Datum` records (reference: caffe-public db_leveldb.cpp, reached from
CoS via `source_class`-less `Data` layers); the rebuild's LMDB side has
its own reader/writer (`lmdb_io.py`), and this module closes the
LevelDB half:

  * `LevelDBReader` — merges the database's LIVE SSTables and
    write-ahead logs into one sorted key→value stream, newest sequence
    number wins, deletions honored.  Live = the CURRENT→MANIFEST
    VersionEdit replay (new_file/deleted_file set + log_number floor);
    without a usable manifest it falls back to scanning every
    `*.ldb`/`*.sst`/`*.log` in the directory (fixture-grade databases).
    Tables are streamed block-by-block (one decompressed block per
    table in memory); only log entries are buffered (they are the
    recent, small tail of a database).
  * `LevelDBWriter` — enough of the on-disk format to build databases
    for tests/tools: sorted SSTables + a real CURRENT/MANIFEST
    (VersionEdit records in log framing).  It can emit blocks
    "snappy-compressed" as all-literal streams, which exercises the
    real decompression path on read.
  * pure-Python `snappy_decompress` (block format: varint length +
    literal/copy tags) — no native snappy library exists in this
    environment, and Caffe-written databases default to snappy.

Format notes (from the public LevelDB docs, table_format.md and
log_format.md):
  SSTable: [data blocks][meta][metaindex][index][footer(48B)]; each
  block = entries (shared_len, non_shared_len, value_len varints +
  key tail + value), restart array, then 1 trailer byte (0 = raw,
  1 = snappy) + crc32c(4).  Footer = metaindex handle + index handle
  (varint64 pairs) padded to 40 bytes + magic 0xdb4775248b80fb57.
  Index block values are handles of data blocks; keys are internal
  keys = user_key + 8 bytes (sequence<<8 | value_type).
  Log: 32 KiB blocks of records (crc32c(4), length(2), type(1) —
  FULL/FIRST/MIDDLE/LAST); payloads concatenate into WriteBatches:
  seq(8) count(4) then per entry type(1) + varint-framed key[/value].
"""

from __future__ import annotations

import glob
import heapq
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = 0xDB4775248B80FB57
TYPE_DELETION = 0
TYPE_VALUE = 1

# log record types
LOG_FULL, LOG_FIRST, LOG_MIDDLE, LOG_LAST = 1, 2, 3, 4
LOG_BLOCK = 32768
LOG_HEADER = 7

_CRC_POLY = 0x82F63B78           # crc32c (Castagnoli)
_CRC_TABLE: List[int] = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC_POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc_mask(crc: int) -> int:
    """LevelDB stores masked crcs (log_format.md)."""
    return ((crc >> 15) | (crc << 17)) % (1 << 32) + 0xA282EAD8 & 0xFFFFFFFF


def _uvarint(buf: bytes, off: int) -> Tuple[int, int]:
    x = shift = 0
    while True:
        b = buf[off]
        off += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, off
        shift += 7


def internal_key(key: bytes, seq: int = 1,
                 etype: int = TYPE_VALUE) -> bytes:
    """user key + 8-byte trailer (sequence << 8 | type) — the SSTable
    entry / manifest-boundary key encoding (table_format.md)."""
    return key + struct.pack("<Q", (seq << 8) | etype)


def _put_uvarint(x: int) -> bytes:
    out = bytearray()
    while x >= 0x80:
        out.append((x & 0x7F) | 0x80)
        x >>= 7
    out.append(x)
    return bytes(out)


def snappy_decompress(buf: bytes) -> bytes:
    """Snappy block format: uncompressed-length varint, then tagged
    elements (literal / copy with 1-, 2-, 4-byte offsets)."""
    n, off = _uvarint(buf, 0)
    out = bytearray()
    while off < len(buf):
        tag = buf[off]
        off += 1
        kind = tag & 3
        if kind == 0:                        # literal
            ln = (tag >> 2) + 1
            if ln > 60:                      # length in next 1-4 bytes
                nb = ln - 60
                ln = int.from_bytes(buf[off:off + nb], "little") + 1
                off += nb
            out += buf[off:off + ln]
            off += ln
            continue
        if kind == 1:                        # copy, 1-byte offset
            ln = ((tag >> 2) & 7) + 4
            o = ((tag >> 5) << 8) | buf[off]
            off += 1
        elif kind == 2:                      # copy, 2-byte offset
            ln = (tag >> 2) + 1
            o = int.from_bytes(buf[off:off + 2], "little")
            off += 2
        else:                                # copy, 4-byte offset
            ln = (tag >> 2) + 1
            o = int.from_bytes(buf[off:off + 4], "little")
            off += 4
        if o == 0 or o > len(out):
            raise ValueError("snappy: bad copy offset")
        for _ in range(ln):                  # may overlap itself
            out.append(out[-o])
    if len(out) != n:
        raise ValueError(f"snappy: length {len(out)} != header {n}")
    return bytes(out)


def _parse_block(raw: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) from one decoded block (restart-prefix
    entries)."""
    if len(raw) < 4:
        return
    n_restarts = struct.unpack("<I", raw[-4:])[0]
    end = len(raw) - 4 - 4 * n_restarts
    off = 0
    key = b""
    while off < end:
        shared, off = _uvarint(raw, off)
        non_shared, off = _uvarint(raw, off)
        vlen, off = _uvarint(raw, off)
        key = key[:shared] + raw[off:off + non_shared]
        off += non_shared
        yield key, raw[off:off + vlen]
        off += vlen


class _Table:
    """One SSTable, streamed block by block via the index block."""

    def __init__(self, path: str, *, verify_crc: bool = True):
        self.path = path
        self.verify_crc = verify_crc
        self._f = open(path, "rb")
        self._size = os.path.getsize(path)
        if self._size < 48:
            raise ValueError(f"{path}: too small for an SSTable")
        self._f.seek(self._size - 48)
        footer = self._f.read(48)
        if struct.unpack("<Q", footer[40:])[0] != MAGIC:
            raise ValueError(f"{path}: bad SSTable magic")
        _, off = _uvarint(footer, 0)         # metaindex handle offset
        _, off = _uvarint(footer, off)       # metaindex handle size
        idx_off, off = _uvarint(footer, off)
        idx_size, off = _uvarint(footer, off)
        self._index = list(_parse_block(self._read_block(idx_off,
                                                         idx_size)))

    def _read_block(self, off: int, size: int) -> bytes:
        self._f.seek(off)
        raw = self._f.read(size + 5)         # + type byte + crc32c
        block, ctype, crc = raw[:size], raw[size], raw[size + 1:size + 5]
        if self.verify_crc:
            want = struct.unpack("<I", crc)[0]
            if crc_mask(crc32c(raw[:size + 1])) != want:
                raise ValueError(f"{self.path}: block crc mismatch "
                                 f"@{off}")
        if ctype == 1:
            block = snappy_decompress(block)
        elif ctype != 0:
            raise ValueError(f"{self.path}: unknown block compression "
                             f"{ctype}")
        return block

    def entries(self, lo: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, int, int, bytes]]:
        """Yield (user_key, seq, type, value) in key order, starting at
        the first block that can contain `lo` (index keys are >= the
        block's last key, so earlier blocks are skipped undecoded)."""
        for idx_key, handle in self._index:
            if lo is not None and len(idx_key) >= 8 \
                    and idx_key[:-8] < lo:
                continue
            boff, p = _uvarint(handle, 0)
            bsize, _ = _uvarint(handle, p)
            for ikey, val in _parse_block(self._read_block(boff, bsize)):
                if len(ikey) < 8:
                    continue
                tag = struct.unpack("<Q", ikey[-8:])[0]
                yield ikey[:-8], tag >> 8, tag & 0xFF, val

    def close(self):
        self._f.close()


def _log_records(path: str, *, verify_crc: bool = True
                 ) -> List[bytes]:
    """Reassembled record payloads from a LevelDB log-format file
    (32 KiB blocks, FULL/FIRST/MIDDLE/LAST fragments).  Both the WAL
    (WriteBatch payloads) and the MANIFEST (VersionEdit payloads) use
    this framing."""
    with open(path, "rb") as f:
        data = f.read()
    payload = bytearray()
    off = 0
    records: List[bytes] = []
    while off + LOG_HEADER <= len(data):
        block_left = LOG_BLOCK - off % LOG_BLOCK
        if block_left < LOG_HEADER:          # trailer padding
            off += block_left
            continue
        crc, length, rtype = struct.unpack("<IHB",
                                           data[off:off + LOG_HEADER])
        off += LOG_HEADER
        if rtype == 0 and length == 0 and crc == 0:
            break                            # zero padding = EOF
        frag = data[off:off + length]
        off += length
        if verify_crc and crc != crc_mask(
                crc32c(frag, crc32c(bytes([rtype])))):
            raise ValueError(f"{path}: log record crc mismatch")
        if rtype in (LOG_FULL, LOG_FIRST):
            payload = bytearray(frag)
        else:
            payload += frag
        if rtype in (LOG_FULL, LOG_LAST):
            records.append(bytes(payload))
    return records


def _log_entries(path: str, *, verify_crc: bool = True
                 ) -> Iterator[Tuple[bytes, int, int, bytes]]:
    """(user_key, seq, type, value) from a write-ahead log file."""
    batches = _log_records(path, verify_crc=verify_crc)
    for batch in batches:
        if len(batch) < 12:
            continue
        seq = struct.unpack("<Q", batch[:8])[0]
        count = struct.unpack("<I", batch[8:12])[0]
        p = 12
        for i in range(count):
            etype = batch[p]
            p += 1
            klen, p = _uvarint(batch, p)
            key = batch[p:p + klen]
            p += klen
            if etype == TYPE_VALUE:
                vlen, p = _uvarint(batch, p)
                val = batch[p:p + vlen]
                p += vlen
            else:
                val = b""
            yield key, seq + i, etype, val


# VersionEdit tags (leveldb version_edit.cc)
_VE_COMPARATOR = 1
_VE_LOG_NUMBER = 2
_VE_NEXT_FILE = 3
_VE_LAST_SEQ = 4
_VE_COMPACT_POINTER = 5
_VE_DELETED_FILE = 6
_VE_NEW_FILE = 7
_VE_PREV_LOG = 9


def _live_file_set(path: str, *, verify_crc: bool = True
                   ) -> Optional[Tuple[set, int, int]]:
    """Replay CURRENT -> MANIFEST VersionEdits into (live-SSTable
    file-number set, log_number, prev_log_number).  Live WALs are those
    numbered >= log_number OR == prev_log_number — LevelDB's own
    recovery rule; anything else is obsolete (a min() floor would
    replay logs strictly between prev_log and log_number and resurrect
    deleted keys).  Returns None when the database has no usable
    manifest (absent, stub, or unparseable) — callers then fall back to
    scanning every file, which is fine for
    fixtures but can resurrect deleted keys from crash-leftover
    obsolete tables in real Caffe-written databases."""
    try:
        with open(os.path.join(path, "CURRENT"), "r") as f:
            name = f.read().strip()
    except OSError:
        return None
    man = os.path.join(path, name)
    if not os.path.isfile(man) or os.path.getsize(man) == 0:
        return None
    live: set = set()
    log_floor = 0
    prev_log = 0

    def _skip_string(payload, p):
        ln, p = _uvarint(payload, p)
        return p + ln

    try:
        for payload in _log_records(man, verify_crc=verify_crc):
            p = 0
            while p < len(payload):
                tag, p = _uvarint(payload, p)
                if tag == _VE_COMPARATOR:
                    p = _skip_string(payload, p)
                elif tag == _VE_LOG_NUMBER:
                    log_floor, p = _uvarint(payload, p)
                elif tag in (_VE_NEXT_FILE, _VE_LAST_SEQ):
                    _, p = _uvarint(payload, p)
                elif tag == _VE_COMPACT_POINTER:
                    _, p = _uvarint(payload, p)          # level
                    p = _skip_string(payload, p)         # internal key
                elif tag == _VE_DELETED_FILE:
                    _, p = _uvarint(payload, p)          # level
                    fn, p = _uvarint(payload, p)
                    live.discard(fn)
                elif tag == _VE_NEW_FILE:
                    _, p = _uvarint(payload, p)          # level
                    fn, p = _uvarint(payload, p)
                    _, p = _uvarint(payload, p)          # file size
                    p = _skip_string(payload, p)         # smallest
                    p = _skip_string(payload, p)         # largest
                    live.add(fn)
                elif tag == _VE_PREV_LOG:
                    prev_log, p = _uvarint(payload, p)
                else:
                    raise ValueError(
                        f"{man}: unknown VersionEdit tag {tag}")
            if p != len(payload):
                raise ValueError(f"{man}: trailing VersionEdit bytes")
    except (ValueError, IndexError):
        return None
    return live, log_floor, prev_log


def _file_number(p: str) -> Optional[int]:
    stem = os.path.basename(p).split(".", 1)[0]
    return int(stem) if stem.isdigit() else None


class LevelDBReader:
    """Directory of SSTables + logs → one sorted (key, value) stream.

    API mirrors `LmdbReader`: context manager, `items(lo, hi)`,
    `partition_ranges(n)` — so `CaffeDataSource` treats both backends
    uniformly."""

    def __init__(self, path: str, *, verify_crc: bool = True):
        self.path = path
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"LevelDB directory not found: {path!r}")
        table_paths = sorted(glob.glob(os.path.join(path, "*.ldb"))
                             + glob.glob(os.path.join(path, "*.sst")))
        log_paths = sorted(glob.glob(os.path.join(path, "*.log")))
        if not table_paths and not log_paths:
            raise ValueError(
                f"{path!r} has no *.ldb/*.sst/*.log files — not a "
                "LevelDB database")
        # honor the MANIFEST's live-file set when one exists: a
        # crash-leftover obsolete table whose deletion marker was
        # compacted away would otherwise resurrect deleted keys
        live = _live_file_set(path, verify_crc=verify_crc)
        if live is not None:
            live_nums, log_num, prev_log = live
            table_paths = [p for p in table_paths
                           if _file_number(p) in live_nums]
            log_paths = [p for p in log_paths
                         if (_file_number(p) or 0) >= log_num
                         or _file_number(p) == prev_log]
        self._tables = [_Table(p, verify_crc=verify_crc)
                        for p in table_paths]
        self._logs = log_paths
        self._verify_crc = verify_crc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        for t in self._tables:
            t.close()

    def _merged(self, lo: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, bytes]]:
        streams = [t.entries(lo) for t in self._tables]
        log_items: List[Tuple[bytes, int, int, bytes]] = []
        for lp in self._logs:
            log_items.extend(_log_entries(lp,
                                          verify_crc=self._verify_crc))
        log_items.sort(key=lambda e: (e[0], -e[1]))
        streams.append(iter(log_items))
        # highest sequence first within a user key: newest version wins
        merged = heapq.merge(*streams,
                             key=lambda e: (e[0], -e[1]))
        prev: Optional[bytes] = None
        for key, seq, etype, val in merged:
            if key == prev:
                continue                     # older version, shadowed
            prev = key
            if etype == TYPE_VALUE:
                yield key, val

    def items(self, lo: Optional[bytes] = None,
              hi: Optional[bytes] = None
              ) -> Iterator[Tuple[bytes, bytes]]:
        for k, v in self._merged(lo=lo):
            if lo is not None and k < lo:
                continue
            if hi is not None and k >= hi:
                break
            yield k, v

    def keys(self) -> List[bytes]:
        return [k for k, _ in self._merged()]

    def partition_ranges(self, num_partitions: int
                         ) -> List[Tuple[Optional[bytes],
                                         Optional[bytes]]]:
        """Exactly num_partitions contiguous key ranges (the
        LmdbRDD.scala:41-95 key-scan partitioning idea).  Like
        LmdbReader, a surplus rank gets a DISTINCT empty (k, k) range —
        never an alias of another rank's keys.  Bounds come from the
        SSTable index blocks when they are fine-grained enough (no data
        decode), else from a full key scan."""
        n = num_partitions
        if n <= 1:
            return [(None, None)]
        ks = self._index_keys()
        if len(ks) >= 4 * n:
            count, key_at = len(ks), ks      # list indexes like the dict
        else:
            count, key_at = self._stream_boundaries(n)
        bounds: List[Tuple[Optional[bytes], Optional[bytes]]] = []
        for i in range(n):
            si = count * i // n
            ei = count * (i + 1) // n
            if si >= ei:
                k0 = key_at[0] if count else b""
                bounds.append((k0, k0))
                continue
            lo = None if i == 0 else key_at[si]
            hi = None if ei >= count else key_at[ei]
            bounds.append((lo, hi))
        return bounds

    def _stream_boundaries(self, n: int
                           ) -> Tuple[int, Dict[int, bytes]]:
        """Boundary keys for n partitions from two streaming scans —
        O(n) memory, never a materialized full key list (real
        Caffe-written databases hold millions of keys)."""
        count = sum(1 for _ in self._merged())
        needed = {0} | {count * i // n for i in range(1, n)}
        key_at: Dict[int, bytes] = {}
        for idx, (k, _) in enumerate(self._merged()):
            if idx in needed:
                key_at[idx] = k
                if len(key_at) == len(needed):
                    break
        return count, key_at

    def _index_keys(self) -> List[bytes]:
        """Sorted user keys from the tables' index blocks — block-level
        granularity, no data-block decompression."""
        ks = set()
        for t in self._tables:
            for ikey, _ in t._index:
                if len(ikey) >= 8:
                    ks.add(ikey[:-8])
        return sorted(ks)


class LevelDBWriter:
    """Write a sorted single-SSTable LevelDB (enough for tests and the
    `cos_tools leveldb2lmdb`/fixture tooling; real Caffe databases are
    far bigger but structurally identical).  `snappy=True` stores
    blocks as all-literal snappy streams (valid per the format, and
    exercises read-side decompression)."""

    def __init__(self, path: str, *, block_size: int = 16384,
                 snappy: bool = False):
        self.path = path
        self.block_size = block_size
        self.snappy = snappy

    @staticmethod
    def _block(entries: List[Tuple[bytes, bytes]]) -> bytes:
        out = bytearray()
        prev = b""
        restarts = [0]
        for i, (k, v) in enumerate(entries):
            if i % 16 == 0:
                if i:
                    restarts.append(len(out))
                shared = 0
            else:
                shared = 0
                while (shared < len(prev) and shared < len(k)
                       and prev[shared] == k[shared]):
                    shared += 1
            out += _put_uvarint(shared) + _put_uvarint(len(k) - shared)
            out += _put_uvarint(len(v)) + k[shared:] + v
            prev = k
        for r in restarts:
            out += struct.pack("<I", r)
        out += struct.pack("<I", len(restarts))
        return bytes(out)

    @staticmethod
    def _snappy_literal(data: bytes) -> bytes:
        """Valid snappy stream using only literal elements."""
        out = bytearray(_put_uvarint(len(data)))
        off = 0
        while off < len(data):
            chunk = data[off:off + 65536]
            ln = len(chunk) - 1
            if ln < 60:
                out.append(ln << 2)
            else:
                out.append(61 << 2)          # 61 = 2-byte length literal
                out += struct.pack("<H", ln)
            out += chunk
            off += len(chunk)
        return bytes(out)

    def write(self, records: List[Tuple[bytes, bytes]], *,
              file_number: int = 5) -> None:
        self.write_table(records, file_number=file_number)
        records = sorted(records)
        files = []
        if records:
            size = os.path.getsize(os.path.join(
                self.path, f"{file_number:06d}.ldb"))
            files.append((file_number, size,
                          internal_key(records[0][0]),
                          internal_key(records[-1][0])))
        self.write_manifest(files, log_number=0)

    def write_table(self, records: List[Tuple[bytes, bytes]], *,
                    file_number: int = 5) -> None:
        """One sorted SSTable, no CURRENT/MANIFEST bookkeeping — tests
        use this to plant crash-leftover obsolete tables."""
        os.makedirs(self.path, exist_ok=True)
        records = sorted(records)
        with open(os.path.join(self.path,
                               f"{file_number:06d}.ldb"), "wb") as f:
            index: List[Tuple[bytes, bytes]] = []

            def emit(block_entries):
                raw = self._block(block_entries)
                if self.snappy:
                    payload, ctype = self._snappy_literal(raw), 1
                else:
                    payload, ctype = raw, 0
                off = f.tell()
                crc = crc_mask(crc32c(payload + bytes([ctype])))
                f.write(payload + bytes([ctype])
                        + struct.pack("<I", crc))
                handle = _put_uvarint(off) + _put_uvarint(len(payload))
                # index key: any key >= last key in block works; use it
                index.append((block_entries[-1][0], handle))

            cur: List[Tuple[bytes, bytes]] = []
            size = 0
            for k, v in records:
                ikey = internal_key(k)
                cur.append((ikey, v))
                size += len(ikey) + len(v)
                if size >= self.block_size:
                    emit(cur)
                    cur, size = [], 0
            if cur:
                emit(cur)
            # metaindex (empty block) + index + footer
            meta_raw = self._block([])
            meta_off = f.tell()
            crc = crc_mask(crc32c(meta_raw + b"\x00"))
            f.write(meta_raw + b"\x00" + struct.pack("<I", crc))
            meta_handle = (_put_uvarint(meta_off)
                           + _put_uvarint(len(meta_raw)))
            idx_raw = self._block(index)
            idx_off = f.tell()
            crc = crc_mask(crc32c(idx_raw + b"\x00"))
            f.write(idx_raw + b"\x00" + struct.pack("<I", crc))
            idx_handle = (_put_uvarint(idx_off)
                          + _put_uvarint(len(idx_raw)))
            footer = meta_handle + idx_handle
            footer += b"\x00" * (40 - len(footer))
            footer += struct.pack("<Q", MAGIC)
            f.write(footer)

    def write_manifest(self, files: List[Tuple[int, int, bytes, bytes]],
                       *, log_number: int = 0,
                       manifest_number: int = 4) -> None:
        """Real CURRENT + MANIFEST: one VersionEdit record declaring
        comparator, live log floor, and the live table set as
        (file_number, size, smallest_ikey, largest_ikey) level-0
        entries — the read side replays this in `_live_file_set`."""
        os.makedirs(self.path, exist_ok=True)
        cmp_name = b"leveldb.BytewiseComparator"
        edit = bytearray()
        edit += _put_uvarint(_VE_COMPARATOR)
        edit += _put_uvarint(len(cmp_name)) + cmp_name
        edit += _put_uvarint(_VE_LOG_NUMBER) + _put_uvarint(log_number)
        for num, size, smallest, largest in files:
            edit += _put_uvarint(_VE_NEW_FILE) + _put_uvarint(0)
            edit += _put_uvarint(num) + _put_uvarint(size)
            edit += _put_uvarint(len(smallest)) + smallest
            edit += _put_uvarint(len(largest)) + largest
        name = f"MANIFEST-{manifest_number:06d}"
        with open(os.path.join(self.path, name), "wb") as f:
            self._append_framed(f, bytes(edit))
        with open(os.path.join(self.path, "CURRENT"), "w") as f:
            f.write(name + "\n")

    @staticmethod
    def _append_framed(f, payload: bytes) -> None:
        """Write one record in log framing (32 KiB blocks, fragment
        types) — shared by the WAL and the MANIFEST."""
        off = 0
        first = True
        while first or off < len(payload):
            room = LOG_BLOCK - f.tell() % LOG_BLOCK - LOG_HEADER
            frag = payload[off:off + room]
            off += len(frag)
            end = off >= len(payload)
            rtype = (LOG_FULL if first and end else
                     LOG_FIRST if first else
                     LOG_LAST if end else LOG_MIDDLE)
            crc = crc_mask(crc32c(frag, crc32c(bytes([rtype]))))
            f.write(struct.pack("<IHB", crc, len(frag), rtype) + frag)
            first = False

    def write_log(self, records: List[Tuple[bytes, bytes]],
                  seq_start: int = 100, *,
                  file_number: int = 7) -> None:
        """Append records as a write-ahead log file (the un-compacted
        recent-writes path)."""
        batch = bytearray(struct.pack("<QI", seq_start, len(records)))
        for k, v in records:
            batch += bytes([TYPE_VALUE]) + _put_uvarint(len(k)) + k
            batch += _put_uvarint(len(v)) + v
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path,
                               f"{file_number:06d}.log"), "wb") as f:
            self._append_framed(f, bytes(batch))
