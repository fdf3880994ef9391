"""Feed plumbing between the record loop and the solver thread.

The counterpart of `caffeonspark_tpu/data/queue_runner.py`:
  * the bounded `FeedQueue` with the STOP_MARK epoch protocol
    (CaffeProcessor.scala:192-198);
  * `TransformerPool`, the ordered multi-threaded pack pool
    (COS_TRANSFORM_THREADS workers, default 2; 0 packs inline on the
    solver thread): one dispatcher groups records into batches and
    draws each batch's augmentation in feed order, the workers pack,
    and the output comes back in feed order;
  * `PipelinedFeed`: a reader thread streaming a source's records into a
    FeedQueue for a TransformerPool, for generator-based callers
    (mini_cluster);
  * `combine_batches` for `iter_size`;
  * `device_prefetch`, the host-to-device stage, with the device-side
    transform's float stage behind the copy; on a card it runs by
    default on a stager thread and a side CUDA stream (COS_STAGE_BG,
    COS_STAGE_DEPTH batches ahead), and the consumer's stream waits on
    each batch's event;
  * the multi-step loop's feed (COS_STEPS_PER_LOOP=K, `steps_per_loop`):
    `chunk_schedule` cuts the run into K-step chunks and single-step
    remainders at the boundaries a train loop acts on, `stack_chunks`
    stacks each chunk's batches into one (K, batch...) block and
    `chunked_feed` ties the two together; `device_prefetch(chunked=True)`
    stages the `(n, block)` pairs, the device-side transform running over
    a block's K batches in one call;
  * `tune_decode_threads`: under a pool of more than one worker the
    native decoder runs on one thread a call.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .source import STOP_MARK
from .transformer import DEVICE_AUX_SUFFIX

_LOG = logging.getLogger(__name__)

SOURCE_QUEUE_CAPACITY = 1024
# consecutive failed packs after which the solver gives up (a systematic
# data or config error, not a bad record)
DROP_LIMIT_DEFAULT = 20

# the ordered slot of a batch the pool dropped after a pack error: it
# still advances the sequence, so a validation round can count it
DROPPED = object()

_END = object()          # worker / stager shutdown sentinel


def _env_int(name: str, default: int, least: int) -> int:
    try:
        return max(least, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


def transform_threads(default: int = 2) -> int:
    """Transformer-pool width (COS_TRANSFORM_THREADS; 0 = pack inline
    on the solver thread)."""
    return _env_int("COS_TRANSFORM_THREADS", default, 0)


def steps_per_loop(default: int = 1) -> int:
    """Solver steps a chunk (COS_STEPS_PER_LOOP; 1 = one step at a
    time): on a card K steps replay as one CUDA graph
    (Solver.train_step_many)."""
    return _env_int("COS_STEPS_PER_LOOP", default, 1)


def tune_decode_threads(src, pool_width: int) -> None:
    """Under a transformer pool of more than one worker the pool's own
    parallelism replaces the decoder's threads (N workers each starting
    one decode thread per core oversubscribe the host): pin the decode
    to one thread unless the source's num_threads was set."""
    if pool_width > 1 and getattr(src, "num_threads", None) == 0:
        src.num_threads = 1


def stage_depth(default: int = 2) -> int:
    """Batches the background stager runs ahead (COS_STAGE_DEPTH)."""
    return _env_int("COS_STAGE_DEPTH", default, 1)


def stage_background(device: torch.device) -> bool:
    """Stage on a thread of its own?  By default on a CUDA device (the
    copy rides a DMA engine on a side stream) and not on the CPU, where
    a stager thread would only compete with the step for the cores.
    COS_STAGE_BG=0/1 overrides."""
    env = os.environ.get("COS_STAGE_BG")
    if env is not None:
        return env.lower() not in ("0", "", "false", "no")
    return torch.device(device).type == "cuda"


class FeedQueue:
    """Bounded record queue with the STOP_MARK epoch protocol."""

    def __init__(self, capacity: int = SOURCE_QUEUE_CAPACITY):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._stopped = False

    def offer(self, item, timeout: Optional[float] = None) -> bool:
        """Put with backpressure; False if stopped or the deadline passes.
        timeout=None blocks until there is space (polling in short slices
        so stop() stays responsive); a number is a deadline for the whole
        call, 0 being one non-blocking attempt."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stopped:
            if deadline is None:
                wait = 0.1
            else:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    try:
                        self._q.put_nowait(item)
                        return True
                    except queue.Full:
                        return False
                wait = min(0.1, wait)
            try:
                self._q.put(item, timeout=wait)
                return True
            except queue.Full:
                continue
        return False

    def reset(self):
        """Re-arm a stopped queue and drop what it still holds."""
        self._stopped = False
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def mark_epoch_end(self):
        self.offer(STOP_MARK)

    def take(self, timeout: Optional[float] = None):
        """Blocking get; a numeric timeout (0 included) raises queue.Empty
        when it expires."""
        if timeout is None:
            return self._q.get()
        return self._q.get(timeout=timeout)

    def stop(self):
        self._stopped = True
        try:                     # wake a consumer blocked in take()
            self._q.put_nowait(STOP_MARK)
        except queue.Full:
            pass

    @property
    def stopped(self) -> bool:
        return self._stopped

    def __len__(self):
        return self._q.qsize()


class TransformerPool:
    """Ordered multi-threaded pack pool (transform_thread_per_device,
    CaffeProcessor.scala:54-55): host transform work off the solver
    thread.

    One dispatcher thread drains `feed`, groups records into
    batch-sized buffers (STOP_MARK drops the ragged epoch tail, a `None`
    record ends the pool), draws each batch's augmentation through
    `draw_fn` in feed order, and hands (seq, buffer, draw) to
    `num_threads` workers calling `pack(buffer, draw)`.  `take()` and
    iteration give the batches in feed order whatever the workers'
    scheduling, with one terminal condition per pool; the results window
    is bounded, so a slow consumer holds the whole pool back.  A batch
    whose pack fails has still consumed its draw, so on dirty data the
    pooled stream leaves the inline one after the first drop.

    A failed pack becomes a DROPPED slot (skipped by train consumers,
    counted by validation rounds); `drop_limit` consecutive failures
    abort the pipeline and the error re-raises from `take()`.
    `on_pack_ok` / `on_pack_error` hand the accounting to the caller
    (CaffeProcessor keeps one set of counters per phase); an
    `on_pack_error` that raises aborts the pool the same way.
    """

    def __init__(self, feed: FeedQueue, batch_size: int,
                 pack: Callable, *, num_threads: int = 2,
                 draw_fn: Optional[Callable] = None,
                 on_pack_ok: Optional[Callable] = None,
                 on_pack_error: Optional[Callable] = None,
                 drop_limit: int = DROP_LIMIT_DEFAULT,
                 metrics=None,
                 should_stop: Optional[Callable[[], bool]] = None):
        self.feed = feed
        self.batch_size = int(batch_size)
        self.pack = pack
        self.num_threads = max(1, int(num_threads))
        self.draw_fn = draw_fn
        self.on_pack_ok = on_pack_ok
        self.on_pack_error = on_pack_error
        self.drop_limit = drop_limit
        self.depth = 2 * self.num_threads      # work items queued ahead
        self.metrics = metrics
        self._ext_stop = should_stop or (lambda: False)
        self._stopped = False
        self._work: queue.Queue = queue.Queue(maxsize=max(1, self.depth))
        # a worker blocks depositing seq >= next_emit + window
        self._window = self.depth + self.num_threads
        self._cond = threading.Condition()
        self._results: Dict[int, object] = {}
        self._next_emit = 0
        self._in_seq: Optional[int] = None   # batches dispatched, at the end
        self._error: Optional[BaseException] = None
        self._consecutive = 0
        self.drops = 0
        self._threads: list = []
        self._started = False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "TransformerPool":
        if self._started:
            raise RuntimeError("pool already started")
        self._started = True
        self._threads.append(threading.Thread(
            target=self._dispatch, daemon=True, name="cos-xform-dispatch"))
        for i in range(self.num_threads):
            self._threads.append(threading.Thread(
                target=self._worker, daemon=True, name=f"cos-xform-{i}"))
        for t in self._threads:
            t.start()
        return self

    def stop(self, join_timeout: Optional[float] = None):
        """Flag every pool thread down; with a timeout, reap them."""
        self._stopped = True
        with self._cond:
            self._cond.notify_all()
        if join_timeout is not None:
            self.join(timeout=join_timeout)

    def join(self, timeout: float):
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _should_stop(self) -> bool:
        # an abort halts the dispatcher and the workers too
        return (self._stopped or self._error is not None
                or self._ext_stop())

    def _fail(self, exc: BaseException):
        with self._cond:
            if self._error is None:
                self._error = exc
            self._cond.notify_all()

    # -- dispatcher: feed order, epoch boundaries, ordered draws --------
    def _dispatch(self):
        buf: list = []
        seq = 0
        try:
            while not self._should_stop():
                try:
                    item = self.feed.take(timeout=0.2)
                except queue.Empty:
                    if self.feed.stopped:
                        break
                    continue
                if item is None:
                    break               # terminal sentinel
                if item is STOP_MARK:
                    if buf and self.metrics is not None:
                        self.metrics.incr("ragged_tail_records", len(buf))
                    buf = []            # epoch boundary: drop the tail
                    if self.feed.stopped:
                        break           # stop()'s wake-up, not an epoch
                    continue
                buf.append(item)
                if len(buf) == self.batch_size:
                    draw = (self.draw_fn(len(buf))
                            if self.draw_fn is not None else None)
                    if not self._put_work((seq, buf, draw)):
                        return
                    seq += 1
                    buf = []
        except BaseException as e:      # noqa: BLE001 — surfaced on take()
            self._fail(e)
        finally:
            with self._cond:
                self._in_seq = seq
                self._cond.notify_all()
            for _ in range(self.num_threads):
                self._put_work(_END, force=True)

    def _put_work(self, item, force: bool = False) -> bool:
        while True:
            if not force and self._should_stop():
                return False
            try:
                self._work.put(item, timeout=0.2)
                return True
            except queue.Full:
                if force and self._should_stop():
                    return False    # the workers exit on their own
                continue

    # -- workers: pack + drop accounting ---------------------------------
    def _record_ok(self):
        if self.on_pack_ok is not None:
            self.on_pack_ok()
            return
        with self._cond:
            self._consecutive = 0

    def _record_drop(self, exc: Exception):
        with self._cond:
            self.drops += 1
        if self.on_pack_error is not None:
            self.on_pack_error(exc)     # may raise to abort the pool
            return
        if self.metrics is not None:
            self.metrics.incr("dropped_batches")
        _LOG.warning("dropping batch after record error: %s", exc)
        with self._cond:
            self._consecutive += 1
            n = self._consecutive
        if n >= self.drop_limit:
            raise RuntimeError(
                f"{n} consecutive batch failures — systematic "
                f"data/config error; last: {exc}") from exc

    def _worker(self):
        while True:
            try:
                item = self._work.get(timeout=0.2)
            except queue.Empty:
                if self._should_stop():
                    return
                continue
            if item is _END:
                return
            seq, buf, draw = item
            t0 = time.perf_counter()
            try:
                batch = self.pack(buf, draw)
            except Exception as e:      # noqa: BLE001 — a DROPPED slot
                batch = DROPPED
                try:
                    self._record_drop(e)
                except BaseException as abort:  # noqa: BLE001
                    self._fail(abort)
            else:
                if self.metrics is not None:
                    self.metrics.add("pack", time.perf_counter() - t0)
                try:
                    self._record_ok()
                except BaseException as abort:  # noqa: BLE001
                    self._fail(abort)
            self._deposit(seq, batch)

    def _deposit(self, seq: int, batch):
        with self._cond:
            while (self._error is None and not self._should_stop()
                   and seq - self._next_emit >= self._window):
                self._cond.wait(0.2)
            self._results[seq] = batch
            self._cond.notify_all()

    # -- consumer -------------------------------------------------------
    def take(self, timeout: Optional[float] = None, *,
             skip_dropped: bool = True):
        """The next packed batch in feed order.  Raises queue.Empty when
        `timeout` expires, re-raises a pipeline abort, returns None when
        the input is exhausted or the pool is stopping.  With
        skip_dropped=False a failed slot comes back as DROPPED."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while True:
                if self._error is not None:
                    raise self._error
                if self._next_emit in self._results:
                    batch = self._results.pop(self._next_emit)
                    self._next_emit += 1
                    self._cond.notify_all()
                    if batch is DROPPED and skip_dropped:
                        continue
                    return batch
                if (self._in_seq is not None
                        and self._next_emit >= self._in_seq):
                    return None          # input exhausted, all emitted
                if self._should_stop():
                    return None
                wait = 0.2
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        raise queue.Empty
                    wait = min(0.2, wait)
                self._cond.wait(wait)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self.take()
            if batch is None:
                return
            yield batch


class PipelinedFeed:
    """records -> FeedQueue -> TransformerPool for generator-based callers
    (mini_cluster): a reader thread streams `src` records into a bounded
    feed queue (shuffled at TRAIN, as DataSource.batches does), the pool
    packs them off-thread.  Iterate for ordered batches; close() tears
    the threads down."""

    def __init__(self, src, *, loop: bool = True,
                 shuffle: Optional[bool] = None, num_threads: int = 2,
                 metrics=None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 capacity: int = SOURCE_QUEUE_CAPACITY):
        self._closed = False
        ext = should_stop or (lambda: False)
        self.feed = FeedQueue(capacity)
        self._reader_error: dict = {}
        do_shuffle = src.phase_train if shuffle is None else shuffle

        def read():
            # mirrors DataSource.batches()'s record loop (shuffle, empty
            # source, epoch count, a looping epoch's tail carried into
            # the next); with loop=False the ragged tail is dropped, as
            # the pool packs only whole batches
            epoch = 0
            try:
                while not self._closed and not ext():
                    got_any = False
                    records = (src.shuffled_records(epoch) if do_shuffle
                               else src.records())
                    for rec in records:
                        got_any = True
                        if not self.feed.offer(rec):
                            return
                    if not got_any:
                        return
                    if not loop:
                        self.feed.mark_epoch_end()
                        return
                    epoch += 1
            except BaseException as e:  # noqa: BLE001 — surfaced below
                self._reader_error["e"] = e
            finally:
                self.feed.offer(None)   # terminal sentinel
                self.feed.stop()

        self.pool = TransformerPool(
            self.feed, src.batch_size, pack=src.pack_batch,
            draw_fn=src.make_draw_fn(), num_threads=num_threads,
            metrics=metrics, should_stop=lambda: self._closed or ext())
        self.pool.start()
        self._reader = threading.Thread(target=read, daemon=True,
                                        name="cos-feed-reader")
        self._reader.start()

    def __iter__(self):
        for batch in self.pool:
            yield batch
        err = self._reader_error.get("e")
        if err is not None:
            raise err

    def close(self, join_timeout: Optional[float] = 2.0):
        self._closed = True
        self.feed.stop()
        self.pool.stop(join_timeout=join_timeout)
        self._reader.join(timeout=join_timeout)


def combine_batches(batches: Iterator[Dict[str, np.ndarray]], k: int,
                    time_major: frozenset = frozenset()
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Concatenate k consecutive batches along the batch axis (axis 1
    for the time-major keys): the (iter_size * B, ...) input of one
    solver step, which the solver splits into its iter_size sub-batches
    again."""
    if k <= 1:
        yield from batches
        return
    buf: list = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield {key: np.concatenate(
                [x[key] for x in buf], axis=1 if key in time_major else 0)
                for key in buf[0]}
            buf = []
    if buf:
        _LOG.info("combine_batches: dropping %d trailing sub-batch(es) "
                  "short of an iter_size=%d group", len(buf), k)


def chunk_schedule(start_iter: int, max_iter: int, k: int,
                   boundaries=()) -> Iterator[int]:
    """Steps of each chunk of the multi-step loop: `k` while the next k
    iterations cross no boundary (`test_interval`, `snapshot`,
    `display`; zeros are ignored) and stay within `max_iter`, else 1
    until the boundary.  A chunk may end on a boundary, never span one,
    so every action between chunks keeps its iteration.  A pure function
    of (start_iter, configuration): a run resumed mid-schedule derives
    the same chunks.  Entering a run of single steps logs once per
    boundary."""
    if k < 1:
        raise ValueError(f"steps-per-loop k must be >= 1, got {k}")
    bset = sorted({int(b) for b in boundaries if b and int(b) > 0})
    it = int(start_iter)
    in_single_run = False
    while max_iter <= 0 or it < max_iter:
        dist = min((b - it % b) for b in bset) if bset else k
        if max_iter > 0:
            dist = min(dist, max_iter - it)
        if dist >= k:
            in_single_run = False
            yield k
            it += k
        else:
            if k > 1 and not in_single_run:
                _LOG.info("steps_per_loop: boundary at iter %d forces %d "
                          "single-step remainder chunk(s) (configured "
                          "chunk size %d)", it + dist, dist, k)
                in_single_run = True
            yield 1
            it += 1


def stack_chunks(batches: Iterator[Dict[str, np.ndarray]],
                 schedule: Iterator[int], *, metrics=None
                 ) -> Iterator[tuple]:
    """Per-step batches -> `(n, block)` chunks following `schedule`:
    n == 1 passes the batch through, n > 1 stacks n batches on a new
    axis 0 (a fresh buffer; the "stack" series times it).  A stream that
    ends mid-chunk flushes its leftovers as single steps."""
    it = iter(batches)
    for n in schedule:
        if n <= 1:
            try:
                b = next(it)
            except StopIteration:
                return
            yield 1, b
            continue
        buf = []
        for _ in range(n):
            try:
                buf.append(next(it))
            except StopIteration:
                break
        if len(buf) == n:
            t0 = time.perf_counter()
            block = {key: np.stack([b[key] for b in buf])
                     for key in buf[0]}
            if metrics is not None:
                metrics.add("stack", time.perf_counter() - t0)
            yield n, block
        else:
            for b in buf:
                yield 1, b
            return


def chunked_feed(batches: Iterator[Dict[str, np.ndarray]], *,
                 start_iter: int, max_iter: int, k: int,
                 boundaries=(), metrics=None) -> Iterator[tuple]:
    """The `(n, batch)` stream both train loops consume: chunk_schedule
    and stack_chunks for K > 1, single steps for K == 1."""
    if k > 1:
        return stack_chunks(
            batches, chunk_schedule(start_iter, max_iter, k, boundaries),
            metrics=metrics)
    return ((1, b) for b in batches)


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device`.  To a card the copy goes from
    pinned host memory with non_blocking=True, on the current stream;
    the caching host allocator keeps the pinned block until the copy
    is done."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if torch.device(device).type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def stage_batch(batch: Dict[str, np.ndarray], device,
                fns: Optional[Dict[str, Callable]] = None,
                chunk: bool = False) -> Dict[str, torch.Tensor]:
    """to_device, then the device-side transform's float stage on every
    top that carries an aux array (`fns`: {top: fn(u8, aux)}, from
    DataSource.enable_device_transform); the aux keys go.  With `chunk`
    the arrays are (n, batch...) blocks: the stage runs once over the
    n * batch samples (it is per sample) and the result takes the
    block's leading axes again."""
    staged = to_device(batch, device)
    if not fns:
        return staged
    out = {}
    for k, v in staged.items():
        if k.endswith(DEVICE_AUX_SUFFIX):
            continue
        aux = staged.get(k + DEVICE_AUX_SUFFIX)
        fn = fns.get(k)
        if fn is None or aux is None:
            out[k] = v
        elif chunk:
            y = fn(v.flatten(0, 1), aux.flatten(0, 1))
            out[k] = y.unflatten(0, v.shape[:2])
        else:
            out[k] = fn(v, aux)
    return out


def device_prefetch(batches: Iterator, device, *,
                    depth: int = 2, device_transforms=None,
                    background: bool = False, metrics=None,
                    chunked: bool = False) -> Iterator:
    """Host batches -> batches on `device` (stage_batch), the "stage"
    series timing each.  In the foreground each batch is staged on the
    consumer's thread and stream when it is asked for: on one stream a
    copy queues behind the step before it anyway, and no look-ahead
    means no wait on records the feeder has not sent yet (a validation
    round fed between two training intervals).

    With `background=True` a stager thread stages up to `depth` batches
    ahead, on a CUDA device on a side stream, so the copy and the float
    stage overlap the step.  The consumer's current stream waits on each
    batch's event, and every tensor is recorded on that stream, so the
    caching allocator does not hand its memory back while a kernel still
    reads it.  Closing the generator stops the stager.

    With `chunked=True` the input is `(n, batch)` pairs (chunked_feed)
    and so is the output: an n > 1 block stages as one (n, batch...)
    tensor per top, its device transform in one call over the block."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the stager thread selects the card by its index
        device = torch.device("cuda", torch.cuda.current_device())
    fns = device_transforms or {}

    def timed_put(item):
        t0 = time.perf_counter()
        if chunked:
            n, b = item
            staged = (n, stage_batch(b, device, fns, chunk=n > 1))
        else:
            staged = stage_batch(item, device, fns)
        if metrics is not None:
            metrics.add("stage", time.perf_counter() - t0)
        return staged

    if background:
        return _background_stage(batches, timed_put, depth, metrics, device)
    return (timed_put(b) for b in batches)


def _background_stage(batches, timed_put, depth, metrics, device):
    outq: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    state: dict = {}
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def handoff(item) -> bool:
        while not stop.is_set():
            try:
                outq.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            if cuda:
                torch.cuda.set_device(device)
            for b in batches:
                if cuda:
                    with torch.cuda.stream(side):
                        staged = timed_put(b)
                        ready = torch.cuda.Event()
                        ready.record(side)
                else:
                    staged, ready = timed_put(b), None
                if metrics is not None:
                    metrics.gauge("stage_depth", outq.qsize())
                if not handoff((staged, ready)):
                    return
        except BaseException as e:      # noqa: BLE001 — re-raised below
            state["err"] = e
        finally:
            handoff(_END)

    def gen():
        # the thread starts with the first next(): a generator built and
        # never driven leaves no stager behind
        t = threading.Thread(target=run, daemon=True, name="cos-stager")
        t.start()
        try:
            while True:
                item = outq.get()
                if item is _END:
                    if "err" in state:
                        raise state["err"]
                    return
                staged, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(ready)
                    tensors = staged[1] if isinstance(staged, tuple) \
                        else staged
                    for v in tensors.values():
                        v.record_stream(consumer)
                yield staged
        finally:
            stop.set()

    return gen()
