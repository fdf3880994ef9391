"""Dynamic micro-batcher: bounded queue -> bucketed batch flushes.

A copy of `caffeonspark_tpu/serving/batcher.py`'s MicroBatcher,
make_buckets and bucket_for.  Requests arrive one at a time; the batcher
coalesces whatever is queued into one flush when either `max_batch`
requests are waiting or `max_wait_ms` has passed since the first
request of the window.  Batch shapes are bucketed (powers of two up to
max_batch): a flush of n requests pads to the smallest bucket >= n, and
warm-up runs every bucket once before traffic.

Batching is continuous: an assembler thread gathers requests into
flushes and an executor thread runs them, joined by a depth-1 handoff
queue, so newly arriving requests are admitted into flush N+1 while
flush N executes.  Robustness: queue-full fast-reject (QueueFullError),
per-request deadlines (DeadlineExceeded, the rest of the flush still
runs), graceful drain on stop(drain=True).

Metrics ride in the PipelineMetrics JSON format (series: latency /
assemble / fwd_flush / exec_wait / time_to_first_flush; gauges:
queue_depth / batch_fill; counters: served_rows / flushes /
flush_bucket_<n> / overlapped_flushes / rejected_queue_full /
expired_deadline / failed_flushes).
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..metrics import PipelineMetrics

_LOG = logging.getLogger(__name__)

_STOP = object()


class QueueFullError(RuntimeError):
    """Fast-reject: the bounded request queue is at depth (the service
    is saturated) — callers should back off / shed load upstream."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its flush executed."""


class ServingStopped(RuntimeError):
    """submit() after stop(): the service is draining or down."""


# -- config knobs (env, COS_SERVE_*) ------------------------------------
# lenient: a bad knob warns and falls back, it never takes a server down

def _env_num(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        v = float("nan")
    if not math.isfinite(v):
        _LOG.warning("ignoring non-numeric %s=%r", name, raw)
        return default
    return v


def _env_int(name: str, default: int) -> int:
    v = _env_num(name, default)
    if v != int(v):
        _LOG.warning("ignoring non-integer %s=%r", name,
                     os.environ.get(name))
        return default
    return int(v)


def serve_max_batch(default: int = 64) -> int:
    """COS_SERVE_MAX_BATCH: flush size cap = largest bucket."""
    return max(1, _env_int("COS_SERVE_MAX_BATCH", default))


def serve_max_wait_ms(default: float = 5.0) -> float:
    """COS_SERVE_MAX_WAIT_MS: max time the first request of a window
    waits for co-batchers before a partial flush."""
    return max(0.0, _env_num("COS_SERVE_MAX_WAIT_MS", default))


# -- buckets ------------------------------------------------------------

def make_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to max_batch, plus max_batch itself when it is
    not one: the fixed set of batch shapes warm-up runs."""
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (n is always <= max_batch, the last one)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket "
                     f"{buckets[-1]}")


# -- requests -----------------------------------------------------------

def _deadline(timeout_ms: Optional[float]) -> Optional[float]:
    return (time.monotonic() + timeout_ms / 1e3
            if timeout_ms is not None else None)


class _Request:
    __slots__ = ("record", "deadline", "t_submit", "_event", "_row",
                 "_error", "version")

    def __init__(self, record, deadline: Optional[float]):
        self.record = record
        self.deadline = deadline          # time.monotonic() or None
        self.t_submit = time.monotonic()
        self._event = threading.Event()
        self._row = None
        self._error: Optional[BaseException] = None
        self.version: Optional[int] = None

    def complete(self, row, version: Optional[int]):
        self._row = row
        self.version = version
        self._event.set()

    def fail(self, err: BaseException):
        self._error = err
        self._event.set()


class PendingResult:
    """Caller-side handle: wait() returns the row or raises the
    request's error (DeadlineExceeded / model failure)."""

    def __init__(self, req: _Request):
        self._req = req

    def wait(self, timeout: Optional[float] = None):
        if not self._req._event.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._req._error is not None:
            raise self._req._error
        return self._req._row

    @property
    def model_version(self) -> Optional[int]:
        return self._req.version


# -- batcher ------------------------------------------------------------

class MicroBatcher:
    """Bounded request queue + assembler/executor thread pair
    (continuous batching: the assembler admits arrivals into the next
    flush while the executor runs the current one).

    `run_batch(records, bucket)` is the model hook: it must return
    (rows, version) with one row per record (padding to `bucket` is
    the hook's business so pack and pad live next to the model).  A
    hook exception fails that flush's requests — the dispatcher
    survives (per-request failure tolerance, the serving analog of the
    processor's drop policy)."""

    def __init__(self, run_batch: Callable[[List[Any], int],
                                           Tuple[List[Any], Any]], *,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 metrics: Optional[PipelineMetrics] = None):
        self.run_batch = run_batch
        self.max_batch = max_batch if max_batch else serve_max_batch()
        self.max_wait_s = (serve_max_wait_ms()
                           if max_wait_ms is None else
                           max(0.0, float(max_wait_ms))) / 1e3
        self.buckets = make_buckets(self.max_batch)
        # default depth scales with THIS instance's (rounded) max_batch
        # (the env knob only supplies an explicit depth), so a wide
        # constructor max_batch still gets room for ~4 full flushes
        depth = queue_depth if queue_depth \
            else _env_int("COS_SERVE_QUEUE_DEPTH", 0)
        if depth <= 0:
            depth = 4 * self.max_batch
        self.metrics = metrics or PipelineMetrics()
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        # assembler → executor handoff; depth 1 so at most one flush is
        # staged ahead of the one executing (deeper staging would age
        # batches against their deadlines behind a slow execution)
        self._exec_q: "queue.Queue[Any]" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None
        self._exec_thread: Optional[threading.Thread] = None
        self._executing = False
        self._stopping = False
        self._drain = True
        # orders submit's check-then-put against stop's final sweep: a
        # put that raced past the _stopping check would otherwise land
        # after the sweep and hang its caller
        self._submit_lock = threading.Lock()
        self._t_start: Optional[float] = None
        self._first_flush_seen = False

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "MicroBatcher":
        assert self._thread is None, "batcher already started"
        self._t_start = time.monotonic()
        self._exec_thread = threading.Thread(target=self._exec_loop,
                                             name="cos-serve-exec",
                                             daemon=True)
        self._exec_thread.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="cos-serve-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, join_timeout: float = 60.0):
        """Reject new submits; with drain, everything already queued is
        flushed before the dispatcher exits, else pending requests fail
        with ServingStopped."""
        # _drain must be visible before _stopping: the dispatcher reads
        # them in the reverse order, so a reordered pair could flush a
        # no-drain stop's backlog
        self._drain = drain
        with self._submit_lock:
            self._stopping = True
        try:
            self._q.put_nowait(_STOP)
        except queue.Full:
            # dispatcher is behind; it checks _stopping on every take
            pass
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                raise RuntimeError("serving dispatcher failed to "
                                   "drain within join timeout")
            self._thread = None
        if self._exec_thread is not None:
            # the assembler's last act is the handoff sentinel, so by
            # here the executor is exiting (or failing staged batches
            # on the no-drain path)
            self._exec_thread.join(timeout=join_timeout)
            if self._exec_thread.is_alive():
                raise RuntimeError("serving executor failed to drain "
                                   "within join timeout")
            self._exec_thread = None
        # no dispatcher ever ran (or it exited on _STOP before our
        # sentinel): fail anything still queued so no caller hangs.
        # Under the submit lock so no put can land after this sweep.
        with self._submit_lock:
            self._reject_queued()

    def _reject_queued(self):
        # _q holds _Request items; _exec_q holds staged
        # ([_Request, ...], t_staged) flushes
        for q in (self._q, self._exec_q):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    continue
                reqs = item[0] if isinstance(item, tuple) else [item]
                for r in reqs:
                    r.fail(ServingStopped("serving stopped"))

    # -- submit -------------------------------------------------------
    def submit(self, record, timeout_ms: Optional[float] = None
               ) -> PendingResult:
        req = _Request(record, _deadline(timeout_ms))
        with self._submit_lock:
            if self._stopping:
                raise ServingStopped("serving is stopping")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self.metrics.incr("rejected_queue_full")
                raise QueueFullError(
                    f"request queue at depth {self._q.maxsize} — "
                    "service saturated") from None
        return PendingResult(req)

    def submit_many(self, records: Sequence[Any],
                    timeout_ms: Optional[float] = None
                    ) -> List[PendingResult]:
        """All-or-nothing multi-record submit: either every record is
        enqueued or none is.  Per-record submit would strand the
        already-accepted prefix of a list that hits queue-full — those
        rows would burn flush capacity for a caller who was told 429
        and will retry, amplifying exactly the overload the fast-reject
        sheds."""
        deadline = _deadline(timeout_ms)
        with self._submit_lock:
            if self._stopping:
                raise ServingStopped("serving is stopping")
            # qsize is exact for admission here: all producers hold
            # this lock, and the dispatcher only ever REMOVES (a stale
            # read can only under-count free slots, never oversubscribe)
            if self._q.maxsize \
                    and self._q.qsize() + len(records) > self._q.maxsize:
                self.metrics.incr("rejected_queue_full")
                raise QueueFullError(
                    f"{len(records)} records do not fit the request "
                    f"queue (depth {self._q.maxsize}) — service "
                    "saturated or list larger than the queue")
            reqs = [_Request(r, deadline) for r in records]
            for req in reqs:
                self._q.put_nowait(req)
        return [PendingResult(r) for r in reqs]

    def depth(self) -> int:
        """Requests waiting: queued arrivals plus any staged flush not
        yet executing — what /metrics reports as queue depth and the
        router reads to spot a backed-up replica."""
        staged = 0
        try:
            item = self._exec_q.queue[0]     # peek, no lock needed for
            if item is not _STOP:            # an advisory metric
                staged = len(item[0])
        except IndexError:
            pass
        return self._q.qsize() + staged

    # -- assembler ----------------------------------------------------
    def _loop(self):
        """Assembler: gather arrivals into flushes and hand each to the
        executor.  The handoff returns as soon as the staged slot is
        free, so assembly of the NEXT flush runs concurrently with the
        execution of the current one (continuous batching)."""
        draining = False
        try:
            while True:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    if self._stopping:
                        break
                    continue
                if first is _STOP:
                    draining = True
                    first = None
                batch: List[_Request] = \
                    [first] if first is not None else []
                if not draining:
                    batch = self._assemble(batch)
                    draining = any(b is _STOP for b in batch)
                    batch = [b for b in batch if b is not _STOP]
                else:
                    batch.extend(self._drain_ready())
                if self._stopping and not self._drain:
                    # no-drain stop (checked AFTER assembly so the
                    # sentinel path through _assemble takes it too):
                    # answer accepted work with the stop error instead
                    # of flushing it
                    for r in batch:
                        r.fail(ServingStopped("serving stopped"))
                    self._reject_queued()
                    break
                if batch:
                    self._submit_exec(batch)
                if draining:
                    # hand over whatever else was accepted pre-stop
                    while True:
                        rest = self._drain_ready()
                        if not rest:
                            break
                        self._submit_exec(rest)
                    break
        finally:
            # always wake the executor for exit — even on an assembler
            # crash, staged work is flushed/failed rather than hung
            self._exec_q.put(_STOP)

    def _submit_exec(self, batch: List[_Request]):
        if self._executing:
            self.metrics.incr("overlapped_flushes")
        batch_t = (batch, time.monotonic())
        self._exec_q.put(batch_t)

    # -- executor -----------------------------------------------------
    def _exec_loop(self):
        while True:
            item = self._exec_q.get()
            if item is _STOP:
                break
            batch, t_staged = item
            self.metrics.add("exec_wait", time.monotonic() - t_staged)
            if self._stopping and not self._drain:
                for r in batch:
                    r.fail(ServingStopped("serving stopped"))
                continue
            self._executing = True
            try:
                self._flush(batch)
            finally:
                self._executing = False

    def _assemble(self, batch: List[Any]) -> List[Any]:
        """Gather co-batchers until max_batch, the window's max_wait,
        or the nearest request deadline — an expired request must
        flush (to be answered with its error) without waiting out the
        full window."""
        t0 = time.monotonic()
        flush_at = t0 + self.max_wait_s
        while len(batch) < self.max_batch:
            dl = flush_at
            for r in batch:
                if r is not _STOP and r.deadline is not None:
                    dl = min(dl, r.deadline)
            now = time.monotonic()
            if now >= dl:
                break
            try:
                item = self._q.get(timeout=dl - now)
            except queue.Empty:
                break
            batch.append(item)
            if item is _STOP:
                break
        self.metrics.add("assemble", time.monotonic() - t0)
        return batch

    def _drain_ready(self) -> List[_Request]:
        out: List[_Request] = []
        while len(out) < self.max_batch:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                out.append(item)
        return out

    def _flush(self, batch: List[_Request]):
        m = self.metrics
        now = time.monotonic()
        # partial-batch salvage: answer expired requests with the
        # deadline error, execute the flush for the survivors
        live: List[_Request] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                m.incr("expired_deadline")
                r.fail(DeadlineExceeded(
                    "deadline passed before flush "
                    f"(+{(now - r.deadline) * 1e3:.1f} ms)"))
            else:
                live.append(r)
        if not live:
            return
        bucket = bucket_for(len(live), self.buckets)
        m.gauge("queue_depth", self._q.qsize())
        m.gauge("batch_fill", len(live) / bucket)
        t0 = time.monotonic()
        try:
            rows, version = self.run_batch([r.record for r in live],
                                           bucket)
        except BaseException as e:     # noqa: BLE001 — per-flush fault
            _LOG.warning("serving flush failed: %s", e)
            m.incr("failed_flushes")
            for r in live:
                r.fail(e)
            return
        done = time.monotonic()
        m.add("fwd_flush", done - t0)
        if not self._first_flush_seen:
            self._first_flush_seen = True
            if self._t_start is not None:
                m.add("time_to_first_flush", done - self._t_start)
        m.incr("flushes")
        m.incr(f"flush_bucket_{bucket}")
        m.incr("served_rows", len(live))
        for r, row in zip(live, rows):
            r.complete(row, version)
            m.add("latency", done - r.t_submit)
