"""Hadoop SequenceFile reader/writer.

The port's copy of `caffeonspark_tpu/data/sequencefile.py`; a file
written by either package reads identically in the other, and the two
writers give the same bytes (but under GzipCodec, whose header carries
the time of writing).

The reference trains CaffeNet-ImageNet from SequenceFiles produced by
`tools/Binary2Sequence.scala:18-89` and read back via Spark's
`sc.sequenceFile` in `SeqImageDataSource.scala:35-64`.  This is a
dependency-free implementation of the same container: version-6 header,
Text/BytesWritable serialization, 16-byte sync markers every few KB.

Key class `org.apache.hadoop.io.Text` (VInt length + UTF-8), value class
`org.apache.hadoop.io.BytesWritable` (4-byte big-endian length + bytes).
Uncompressed/record-compressed records: {recordLen i32be, keyLen i32be,
key, value}; recordLen == -1 escapes a sync marker.  Record compression
compresses each value's serialized form; block compression groups records
into 4 compressed buffers (keyLengths/keys/valueLengths/values) per block,
each preceded by a VInt compressed size, block preceded by a sync escape
and a VInt record count.  Codecs: DefaultCodec (zlib), GzipCodec, Bzip2.
"""

from __future__ import annotations

import bz2
import gzip
import os
import struct
import zlib
from typing import Iterator, Tuple

SEQ_MAGIC = b"SEQ\x06"
TEXT_CLASS = "org.apache.hadoop.io.Text"
BYTES_CLASS = "org.apache.hadoop.io.BytesWritable"
DEFAULT_CODEC = "org.apache.hadoop.io.compress.DefaultCodec"
GZIP_CODEC = "org.apache.hadoop.io.compress.GzipCodec"
BZIP2_CODEC = "org.apache.hadoop.io.compress.BZip2Codec"
SYNC_INTERVAL = 2000  # bytes between sync markers (hadoop default ~2000)

_CODECS = {
    DEFAULT_CODEC: (zlib.compress, zlib.decompress),
    GZIP_CODEC: (gzip.compress, gzip.decompress),
    BZIP2_CODEC: (bz2.compress, bz2.decompress),
}


def _codec(name: str):
    if name not in _CODECS:
        raise NotImplementedError(f"SequenceFile codec {name!r}")
    return _CODECS[name]


def write_vint(v: int) -> bytes:
    if -112 <= v <= 127:
        return struct.pack("b", v)
    out = bytearray()
    neg = v < 0
    if neg:
        v = ~v
    length = (v.bit_length() + 7) // 8
    out.append((-121 if neg else -113) - (length - 1) & 0xFF)
    out.extend(v.to_bytes(length, "big"))
    return bytes(out)


def read_vint(buf: bytes, pos: int) -> Tuple[int, int]:
    (first,) = struct.unpack_from("b", buf, pos)
    pos += 1
    if first >= -112:
        return first, pos
    neg = first <= -121
    length = (-first - 120) if neg else (-first - 112)
    v = int.from_bytes(buf[pos:pos + length], "big")
    pos += length
    return (~v if neg else v), pos


def _write_text(s: str) -> bytes:
    b = s.encode("utf-8")
    return write_vint(len(b)) + b


def _read_text(buf: bytes, pos: int) -> Tuple[str, int]:
    n, pos = read_vint(buf, pos)
    return buf[pos:pos + n].decode("utf-8"), pos + n


class SequenceFileWriter:
    """(Text key, BytesWritable value) records.

    compression: None (default), "record" (each value's serialization
    compressed individually) or "block" (records buffered and flushed as
    4 compressed buffers per block, the hadoop BlockCompressWriter
    layout).
    """

    def __init__(self, path: str, *, key_class: str = TEXT_CLASS,
                 value_class: str = BYTES_CLASS,
                 compression: str | None = None,
                 codec: str = DEFAULT_CODEC,
                 block_size: int = 1 << 20,
                 sync_seed: int = 0x53455106):
        if compression not in (None, "record", "block"):
            raise ValueError(f"compression={compression!r}")
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        self.key_class = key_class
        self.value_class = value_class
        self.compression = compression
        self.codec = codec
        self._compress = _codec(codec)[0] if compression else None
        self._block_size = block_size
        import hashlib
        self.sync = hashlib.md5(
            f"cos-tpu-sync-{sync_seed}".encode()).digest()
        hdr = SEQ_MAGIC + _write_text(key_class) + _write_text(value_class)
        hdr += bytes([compression is not None, compression == "block"])
        if compression:
            hdr += _write_text(codec)
        hdr += struct.pack(">i", 0)   # metadata entries
        hdr += self.sync
        self._f.write(hdr)
        self._since_sync = 0
        # block-mode buffers: serialized key lengths / keys / value
        # lengths / values
        self._blk = ([], [], [], [])
        self._blk_bytes = 0

    def append(self, key: str, value: bytes) -> None:
        kb = _write_text(key)  # Text writable: VInt + utf8
        vb = struct.pack(">i", len(value)) + value  # BytesWritable
        if self.compression == "block":
            self._blk[0].append(write_vint(len(kb)))
            self._blk[1].append(kb)
            self._blk[2].append(write_vint(len(vb)))
            self._blk[3].append(vb)
            self._blk_bytes += len(kb) + len(vb)
            if self._blk_bytes >= self._block_size:
                self._flush_block()
            return
        if self.compression == "record":
            vb = self._compress(vb)
        rec = struct.pack(">ii", len(kb) + len(vb), len(kb))
        self._f.write(rec + kb + vb)
        self._since_sync += len(kb) + len(vb) + 8
        if self._since_sync >= SYNC_INTERVAL:
            self._f.write(struct.pack(">i", -1) + self.sync)
            self._since_sync = 0

    def _flush_block(self) -> None:
        n = len(self._blk[0])
        if n == 0:
            return
        out = [struct.pack(">i", -1), self.sync, write_vint(n)]
        for parts in self._blk:
            cb = self._compress(b"".join(parts))
            out.append(write_vint(len(cb)))
            out.append(cb)
        self._f.write(b"".join(out))
        self._blk = ([], [], [], [])
        self._blk_bytes = 0

    def close(self):
        if self.compression == "block":
            self._flush_block()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# exception classes a corrupt byte can surface as from the wire/codec
# internals — converted to ValueError at the reader boundaries.  The
# RECORD wrapper additionally catches OSError/EOFError (gzip's
# BadGzipFile and bz2 raise OSError subclasses; EOFError on truncated
# streams); the HEADER wrapper must NOT — it would relabel a genuine
# FileNotFoundError as corruption.
_WIRE_ERRORS = (struct.error, IndexError, OverflowError, zlib.error)
_DECOMPRESS_ERRORS = _WIRE_ERRORS + (OSError, EOFError)


class SequenceFileReader:
    def __init__(self, path: str):
        try:
            self._init(path)
        except _WIRE_ERRORS as e:
            raise ValueError(
                f"{path}: corrupt SequenceFile header: "
                f"{type(e).__name__}: {e}") from e

    def _init(self, path: str):
        # the whole file is read into memory, as the JAX reader does: a
        # part of a SequenceFile directory costs its size in host memory
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        buf = self._buf
        if buf[:4] != SEQ_MAGIC:
            raise ValueError(f"{path}: not a SequenceFile (v6)")
        pos = 4
        self.key_class, pos = _read_text(buf, pos)
        self.value_class, pos = _read_text(buf, pos)
        compressed, block = buf[pos], buf[pos + 1]
        pos += 2
        self.compression = ("block" if block else
                            "record" if compressed else None)
        self.codec = None
        self._decompress = None
        if compressed or block:
            self.codec, pos = _read_text(buf, pos)
            self._decompress = _codec(self.codec)[1]
        (nmeta,) = struct.unpack_from(">i", buf, pos)
        pos += 4
        self.metadata = {}
        for _ in range(nmeta):
            k, pos = _read_text(buf, pos)
            v, pos = _read_text(buf, pos)
            self.metadata[k] = v
        self.sync = buf[pos:pos + 16]
        self._data_start = pos + 16

    def records(self) -> Iterator[Tuple[str, bytes]]:
        # malformed/truncated files surface as ValueError (the data
        # readers' one documented failure mode — matches LmdbReader and
        # proto.descriptor); a struct.error leak or a silently-dropped
        # truncated tail record would otherwise shorten epochs without
        # a trace
        try:
            if self.compression == "block":
                yield from self._block_records()
            else:
                yield from self._plain_records()
        except _DECOMPRESS_ERRORS as e:
            raise ValueError(
                f"{self.path}: corrupt SequenceFile: "
                f"{type(e).__name__}: {e}") from e

    def _plain_records(self) -> Iterator[Tuple[str, bytes]]:
        buf = self._buf
        pos = self._data_start
        n = len(buf)
        while pos < n:
            (rec_len,) = struct.unpack_from(">i", buf, pos)
            pos += 4
            if rec_len == -1:
                if buf[pos:pos + 16] != self.sync:
                    raise ValueError("sync marker mismatch (corrupt file)")
                pos += 16
                continue
            (key_len,) = struct.unpack_from(">i", buf, pos)
            pos += 4
            kend = pos + key_len
            if rec_len < key_len or key_len < 0 \
                    or pos + (rec_len - key_len) + key_len > n:
                raise ValueError(
                    f"{self.path}: truncated record at offset "
                    f"{pos - 8} (rec_len {rec_len}, key_len {key_len}, "
                    f"{n - pos} bytes left)")
            _, kpos = read_vint(buf, pos)
            key = buf[kpos:kend].decode("utf-8")   # UnicodeDecodeError
            #                       IS a ValueError — strict by design
            vsec = buf[kend:kend + (rec_len - key_len)]
            pos = kend + (rec_len - key_len)  # value section incl. length
            if self.compression == "record":
                vsec = self._decompress(bytes(vsec))
            (vlen,) = struct.unpack_from(">i", vsec, 0)
            if not 0 <= vlen <= len(vsec) - 4:
                raise ValueError(
                    f"{self.path}: corrupt BytesWritable length "
                    f"{vlen} (section {len(vsec) - 4} bytes)")
            yield key, bytes(vsec[4:4 + vlen])

    def _block_records(self) -> Iterator[Tuple[str, bytes]]:
        buf = self._buf
        pos = self._data_start
        n = len(buf)
        while pos < n:
            (esc,) = struct.unpack_from(">i", buf, pos)
            pos += 4
            if esc != -1 or buf[pos:pos + 16] != self.sync:
                raise ValueError("block boundary sync mismatch")
            pos += 16
            count, pos = read_vint(buf, pos)
            bufs = []
            for _ in range(4):  # keyLengths, keys, valueLengths, values
                clen, pos = read_vint(buf, pos)
                bufs.append(self._decompress(bytes(buf[pos:pos + clen])))
                pos += clen
            klens_b, keys_b, vlens_b, vals_b = bufs
            kp = vp = 0
            koff = voff = 0
            for _ in range(count):
                klen, kp = read_vint(klens_b, kp)
                vlen, vp = read_vint(vlens_b, vp)
                kser = keys_b[koff:koff + klen]
                koff += klen
                vser = vals_b[voff:voff + vlen]
                voff += vlen
                _, kdata = read_vint(kser, 0)
                (vraw,) = struct.unpack_from(">i", vser, 0)
                if not 0 <= vraw <= len(vser) - 4:
                    raise ValueError(
                        f"{self.path}: corrupt BytesWritable length "
                        f"{vraw} (section {len(vser) - 4} bytes)")
                yield (kser[kdata:].decode("utf-8"),
                       bytes(vser[4:4 + vraw]))

    def __iter__(self):
        return self.records()
