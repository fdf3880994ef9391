"""Streaming data source: follow a GROWING directory of part files.

The port's copy of `caffeonspark_tpu/data/streaming.py` (source_class
"StreamingDir"), whose continuous-deployment loop trains on data that
keeps arriving.  The filesystem contract is the one every stream lands
on disk with (Flume/Spark-streaming style): a writer builds each part
under a dot-prefixed temp name and `os.rename`s it into place, so a
part is either absent or complete, never half readable.
`StreamingDirSource` re-lists the directory on `poll()`, absorbs new
parts, and serves **the data seen so far** as its record set; "epoch"
therefore means one pass over everything absorbed up to the latest
poll.

Part formats (auto-detected per entry):
  * an LMDB part: a directory containing `data.mdb` (or a bare `*.mdb`
    file) of serialized Caffe `Datum` records;
  * a SequenceFile part: any other regular file, read through
    `SequenceFileReader` as (id, Datum) pairs.

Robustness: a poll that fails (a transient listing or read error on
flaky shared storage, or a fault raised by the `injector` passed to
`poll`: any object with a `storage_fault()` method) is retried with
capped exponential backoff inside the SAME poll call, and
`wait_for_records` keeps re-polling until growth arrives or its
deadline passes, so a slow stream degrades to a skipped round rather
than an error.  An entry that keeps failing is quarantined.

This is an ordinary `DataSource`: the transformer pool's ordered
packing (`pack_batch` / `make_draw_fn`) applies to it unchanged.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterator, List, Optional, Tuple

from .lmdb_io import LmdbReader, LmdbWriter
from .sequencefile import SequenceFileReader
from .source import DataSource, ImageRecord, datum_to_record

_LOG = logging.getLogger(__name__)


def _is_part_name(name: str) -> bool:
    """Visible, committed entries only: dot/underscore prefixes are
    in-flight temp parts or markers (the rename-commit contract)."""
    return not name.startswith((".", "_"))


def _part_is_lmdb(path: str) -> bool:
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, "data.mdb"))
    return path.endswith(".mdb")


class _Part:
    """One committed, immutable part: path + cached record count."""

    __slots__ = ("path", "count")

    def __init__(self, path: str):
        self.path = path
        if _part_is_lmdb(path):
            with LmdbReader(path) as r:
                self.count = int(r.entries)
        else:
            self.count = sum(1 for _ in SequenceFileReader(path))

    def records(self) -> Iterator[ImageRecord]:
        if _part_is_lmdb(self.path):
            with LmdbReader(self.path) as r:
                for k, v in r.items(None, None):
                    yield datum_to_record(k, v)
        else:
            for key, val in SequenceFileReader(self.path):
                yield datum_to_record(key.encode("latin-1"), val)


class StreamingDirSource(DataSource):
    """Follow a growing part directory (source_class "StreamingDir").

    `records()` iterates everything absorbed by the last `poll()`;
    `poll()` absorbs newly committed parts (bounded retry on storage
    faults); `wait_for_records()` is the fine-tune trigger's bounded
    re-poll with capped exponential backoff."""

    POLL_ATTEMPTS = 8
    # a single entry that keeps failing across this many attempts is
    # QUARANTINED (skipped forever, warned once) — one corrupt part or
    # stray non-part file must not block absorption of everything
    # committed after it
    PART_STRIKES = 8

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._parts: List[_Part] = []
        self._seen: set = set()
        self._strikes: dict = {}
        self._broken: set = set()
        self.polls = 0
        self.poll_faults = 0
        # the first poll happens at construction so a pre-populated
        # directory serves immediately (later growth needs poll())
        self.poll()

    # -- stream following ---------------------------------------------
    def _list_parts(self, injector=None) -> List[str]:
        if injector is not None:
            injector.storage_fault()
        root = self.source_uri()
        if not os.path.isdir(root):
            return []
        return sorted(n for n in os.listdir(root) if _is_part_name(n))

    def poll(self, injector=None) -> int:
        """Absorb newly committed parts; returns how many RECORDS were
        added.  Transient listing/open failures (flaky storage, real
        or raised by `injector.storage_fault()`) are retried with capped
        exponential backoff inside this call; a poll that stays broken
        past the attempt budget returns 0 (the stream tail is simply
        not visible yet — the caller's re-poll loop owns the deadline)."""
        self.polls += 1
        delay = 0.01
        # `added` accumulates ACROSS retry attempts: a fault that
        # lands mid-listing after some parts were already absorbed
        # must not lose their record count (the fine-tune trigger's
        # min_new growth check reads this return value)
        added = 0
        for attempt in range(self.POLL_ATTEMPTS):
            try:
                names = self._list_parts(injector)
            except (OSError, ValueError) as e:
                self.poll_faults += 1
                if attempt == self.POLL_ATTEMPTS - 1:
                    _LOG.warning(
                        "streaming poll failed %d times (%s) — "
                        "treating the tail as not yet visible",
                        self.POLL_ATTEMPTS, e)
                    return added
                time.sleep(delay)
                delay = min(delay * 2, 0.5)
                continue
            # absorb each pending part INDEPENDENTLY: one entry that
            # cannot be read (corrupt part, stray non-part file) must
            # not block the parts sorted after it.  Transient failures
            # retry on the next attempt; an entry that keeps failing
            # collects strikes (across polls too) and is quarantined.
            pending = [n for n in names if n not in self._seen
                       and n not in self._broken]
            failed_transient = False
            for name in pending:
                path = os.path.join(self.source_uri(), name)
                try:
                    part = _Part(path)
                except (OSError, ValueError) as e:
                    self.poll_faults += 1
                    self._strikes[name] = \
                        self._strikes.get(name, 0) + 1
                    if self._strikes[name] >= self.PART_STRIKES:
                        self._broken.add(name)
                        _LOG.warning(
                            "streaming: quarantining unreadable "
                            "entry %s after %d failures (%s) — "
                            "later parts keep absorbing", path,
                            self._strikes[name], e)
                    else:
                        failed_transient = True
                    continue
                self._parts.append(part)
                self._seen.add(name)
                added += part.count
            if not failed_transient:
                return added
            if attempt < self.POLL_ATTEMPTS - 1:
                time.sleep(delay)
                delay = min(delay * 2, 0.5)
        return added

    def wait_for_records(self, min_new: int = 1, *,
                         timeout_s: float = 30.0,
                         injector=None,
                         base_s: float = 0.02,
                         cap_s: float = 1.0) -> int:
        """Bounded re-poll with capped exponential backoff until at
        least `min_new` new records are visible; returns the number of
        new records absorbed (possibly 0 on timeout — the caller skips
        the round instead of failing)."""
        deadline = time.monotonic() + timeout_s
        total = self.poll(injector)
        delay = base_s
        while total < min_new and time.monotonic() < deadline:
            time.sleep(min(delay, max(0.0,
                                      deadline - time.monotonic())))
            delay = min(delay * 2, cap_s)
            total += self.poll(injector)
        return total

    # -- DataSource SPI -----------------------------------------------
    def records(self) -> Iterator[ImageRecord]:
        """Everything seen so far (snapshot of the parts list at call
        time — a concurrent poll() appending mid-iteration does not
        change this pass)."""
        for part in list(self._parts):
            yield from part.records()

    # -- reporting ----------------------------------------------------
    @property
    def total_records(self) -> int:
        return sum(p.count for p in self._parts)

    @property
    def part_count(self) -> int:
        return len(self._parts)

    def describe(self) -> dict:
        out = {"dir": self.source_uri(), "parts": self.part_count,
               "records": self.total_records, "polls": self.polls,
               "poll_faults": self.poll_faults}
        if self._broken:
            out["quarantined"] = sorted(self._broken)
        return out


# ---------------------------------------------------------------------------
# stream writer helpers (tests, and operators seeding a stream)
# ---------------------------------------------------------------------------

def append_stream_part(stream_dir: str,
                       records: List[Tuple[bytes, bytes]],
                       name: Optional[str] = None) -> str:
    """Commit one immutable LMDB part atomically: build it under a
    dot-prefixed temp name, then `os.rename` into place — a reader's
    poll either sees the whole part or none of it."""
    os.makedirs(stream_dir, exist_ok=True)
    if name is None:
        existing = [n for n in os.listdir(stream_dir)
                    if _is_part_name(n)]
        name = f"part-{len(existing):05d}"
    tmp = os.path.join(stream_dir, f".tmp-{name}-{os.getpid()}")
    # pre-create the directory so LmdbWriter lays out <part>/data.mdb
    # (the LMDB-directory shape _part_is_lmdb detects after the rename)
    os.makedirs(tmp, exist_ok=True)
    LmdbWriter(tmp).write(records)
    final = os.path.join(stream_dir, name)
    os.rename(tmp, final)
    return final


def datum_records(images, labels,
                  start_id: int = 0) -> List[Tuple[bytes, bytes]]:
    """(N,C,H,W) float images in [0,1] + int labels → sorted LMDB
    (key, Datum bytes) records, 8-bit storage (data/synthetic.py's
    images as the drills store them)."""
    import numpy as np

    from ..proto.caffe import Datum
    out = []
    for i in range(len(images)):
        img = images[i]
        c, h, w = img.shape
        out.append((b"%08d" % (start_id + i),
                    Datum(channels=c, height=h, width=w,
                          data=(img * 255).astype(np.uint8).tobytes(),
                          label=int(labels[i])).to_binary()))
    return out
