"""Feed plumbing between the record loop and the solver thread.

The part of `caffeonspark_tpu/data/queue_runner.py` the training slice
needs: the bounded `FeedQueue` with the STOP_MARK epoch protocol
(CaffeProcessor.scala:192-198), `combine_batches` for `iter_size`, and
the host-to-device copy of a packed batch.  The threaded transformer
pool, the device-side transform and the fused multi-step loop wait for
later slices.
"""

from __future__ import annotations

import logging
import queue
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .source import STOP_MARK

_LOG = logging.getLogger(__name__)

SOURCE_QUEUE_CAPACITY = 1024
# consecutive failed packs after which the solver gives up (a systematic
# data or config error, not a bad record)
DROP_LIMIT_DEFAULT = 20


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

    def __len__(self):
        return self._q.qsize()


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


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device`.  To a card the copy goes from
    pinned host memory with non_blocking=True, so it runs on the stream
    behind the previous step instead of stalling the host."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out
