"""Per-stage timeline metrics (a copy of the JAX package's
`PipelineMetrics`): lock-guarded ring buffers per stage, O(1) per
sample, summarized on demand.

The serving path records its stages through it (latency / assemble /
pack / fwd / exec_wait / time_to_first_flush series, queue_depth /
batch_fill gauges, served_rows / flushes / flush_bucket_<n> counters),
so serving metrics dump in the JAX package's JSON format.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

_DEFAULT_CAPACITY = 8192


class _Series:
    """Total/count plus a bounded sample ring for percentiles."""

    __slots__ = ("total", "count", "max", "_ring", "_cap", "_i")

    def __init__(self, capacity: int):
        self.total = 0.0
        self.count = 0
        self.max = 0.0
        self._ring: List[float] = []
        self._cap = capacity
        self._i = 0

    def add(self, v: float):
        self.total += v
        self.count += 1
        if v > self.max:
            self.max = v
        if len(self._ring) < self._cap:
            self._ring.append(v)
        else:
            self._ring[self._i] = v
            self._i = (self._i + 1) % self._cap

    def summary(self) -> Dict[str, float]:
        s = sorted(self._ring)
        n = len(s)

        def pct(p):
            return s[min(n - 1, int(p * n))] if n else 0.0

        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "mean_ms": round(1e3 * self.total / self.count, 4)
            if self.count else 0.0,
            "p50_ms": round(1e3 * pct(0.50), 4),
            "p95_ms": round(1e3 * pct(0.95), 4),
            "p99_ms": round(1e3 * pct(0.99), 4),
            "p99_9_ms": round(1e3 * pct(0.999), 4),
            "max_ms": round(1e3 * self.max, 4),
        }


class _Gauge:
    """Sampled depth/level: count, mean, max."""

    __slots__ = ("total", "count", "max")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, v: float):
        self.total += v
        self.count += 1
        if v > self.max:
            self.max = v

    def summary(self) -> Dict[str, float]:
        return {
            "samples": self.count,
            "mean": round(self.total / self.count, 3) if self.count else 0.0,
            "max": self.max,
        }


class PipelineMetrics:
    """Thread-safe per-stage timeline: durations, counters, gauges."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, _Gauge] = {}
        self._info: Dict[str, object] = {}
        self._cap = capacity
        self._created = time.monotonic()

    # -- recording (hot path: one lock, O(1)) ---------------------------
    def add(self, stage: str, seconds: float):
        with self._lock:
            s = self._series.get(stage)
            if s is None:
                s = self._series[stage] = _Series(self._cap)
            s.add(seconds)

    def incr(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float):
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = _Gauge()
            g.observe(value)

    def set_info(self, name: str, value) -> None:
        """Attach a static (JSON-serializable) fact to the summary."""
        with self._lock:
            self._info[name] = value

    # -- reading --------------------------------------------------------
    def get_counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def summary(self) -> dict:
        with self._lock:
            stages = {k: v.summary() for k, v in self._series.items()}
            counters = dict(self._counters)
            gauges = {k: v.summary() for k, v in self._gauges.items()}
            info = dict(self._info)
        out = {
            "stages": stages,
            "counters": counters,
            "queue_depths": gauges,
            "uptime_s": round(time.monotonic() - self._created, 3),
        }
        if info:
            out["info"] = info
        return out
