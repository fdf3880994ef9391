"""Per-stage timeline metrics (a copy of the JAX package's
`PipelineMetrics`): lock-guarded ring buffers per stage, O(1) per
sample, summarized on demand.

The serving path records its stages through it (latency / assemble /
pack / fwd / exec_wait / time_to_first_flush series, queue_depth /
batch_fill gauges, served_rows / flushes / flush_bucket_<n> counters),
and the trainer its own, under the JAX package's names: pack (on the
transformer pool's workers, or inline), stage (the host-to-device
stager), queue_wait and step series, and with COS_STEPS_PER_LOOP > 1
stack (a chunk's batches stacked on the host) and scan_step (one
multi-step chunk; `add_chunk`); feed_depth and stage_depth gauges;
dropped_batches, dropped_val_batches and ragged_tail_records counters;
and one `mark_step` per solver step for the steady steps/s.  Both dump
in the JAX package's JSON format.  With COS_METRICS_FLUSH_S > 0 a
`MetricsFlusher` thread rewrites the summary to `<output>/metrics.json`
every that many seconds (atomically), so a killed run keeps telemetry no
older than one interval.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from .utils.fsutils import write_atomic

_DEFAULT_CAPACITY = 8192
_LOG = logging.getLogger(__name__)


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
        self._steps: List[float] = []
        self._step_i = 0
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

    def mark_step(self, n: int = 1):
        """Timestamp `n` completed solver steps (throughput series); a
        K-step chunk lands K marks at one instant, so a chunked run's
        steps/s compares with a step-at-a-time run's."""
        with self._lock:
            now = time.monotonic()
            for _ in range(max(1, n)):
                if len(self._steps) < self._cap:
                    self._steps.append(now)
                else:
                    self._steps[self._step_i] = now
                    self._step_i = (self._step_i + 1) % self._cap

    def add_chunk(self, n: int, seconds: float):
        """One multi-step chunk: a `scan_step` sample for the chunk, its
        time over n into the `step` series n times (per-step percentiles
        stay comparable with K=1 runs), and n step marks."""
        self.add("scan_step", seconds)
        per = seconds / max(1, n)
        for _ in range(max(1, n)):
            self.add("step", per)
        self.mark_step(n)

    def set_info(self, name: str, value) -> None:
        """Attach a static (JSON-serializable) fact to the summary."""
        with self._lock:
            self._info[name] = value

    # -- reading --------------------------------------------------------
    def get_counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def has_samples(self) -> bool:
        with self._lock:
            return bool(self._series or self._counters or self._steps
                        or self._info)

    def steady_steps_per_sec(self, skip: int = 5) -> Optional[float]:
        """Steps per second over the step marks after the first `skip`
        (warm-up); None if too few."""
        with self._lock:
            ts = self._steps[self._step_i:] + self._steps[:self._step_i]
        ts = ts[skip:]
        if len(ts) < 2 or ts[-1] <= ts[0]:
            return None
        return (len(ts) - 1) / (ts[-1] - ts[0])

    def summary(self) -> dict:
        with self._lock:
            stages = {k: v.summary() for k, v in self._series.items()}
            counters = dict(self._counters)
            gauges = {k: v.summary() for k, v in self._gauges.items()}
            nsteps = len(self._steps)
            info = dict(self._info)
        out = {
            "stages": stages,
            "counters": counters,
            "queue_depths": gauges,
            "steps": nsteps,
            "uptime_s": round(time.monotonic() - self._created, 3),
        }
        if info:
            out["info"] = info
        sps = self.steady_steps_per_sec()
        if sps is not None:
            out["steady_steps_per_sec"] = round(sps, 3)
        return out

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    def dump_atomic(self, path: str) -> str:
        """The summary through a temporary file, fsynced and renamed into
        place: a reader (or a post-mortem after SIGKILL) only ever sees a
        complete document."""
        write_atomic(path, (json.dumps(self.summary(), indent=2,
                                       sort_keys=True) + "\n").encode())
        return path


def metrics_flush_s() -> float:
    """COS_METRICS_FLUSH_S: the background flush interval of the summary
    artifact in seconds; 0 or unset keeps the dump-at-stop behaviour (a
    value that is not a number is ignored with a warning)."""
    v = os.environ.get("COS_METRICS_FLUSH_S", "")
    if not v:
        return 0.0
    try:
        return max(0.0, float(v))
    except ValueError:
        _LOG.warning("ignoring non-numeric COS_METRICS_FLUSH_S=%r", v)
        return 0.0


class MetricsFlusher:
    """A thread that writes a PipelineMetrics summary to `path` every
    `interval_s` (atomically); `stop()` lands one final flush."""

    def __init__(self, metrics: PipelineMetrics, path: str,
                 interval_s: float):
        self.metrics = metrics
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.flushes = 0
        self.errors = 0

    def _flush_once(self) -> None:
        try:
            self.metrics.dump_atomic(self.path)
            self.flushes += 1
        except OSError:
            # a bad path or a full disk never takes the run down
            self.errors += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._flush_once()

    def start(self) -> "MetricsFlusher":
        if self._thread is not None:
            raise RuntimeError("flusher already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="cos-metrics-flush",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._flush_once()


def maybe_start_flusher(metrics: PipelineMetrics,
                        output_dir: Optional[str],
                        filename: str = "metrics.json"
                        ) -> Optional[MetricsFlusher]:
    """Start the flusher when COS_METRICS_FLUSH_S > 0 and there is an
    output directory for `<output>/metrics.json`."""
    interval = metrics_flush_s()
    if interval <= 0 or not output_dir:
        return None
    return MetricsFlusher(metrics, os.path.join(output_dir, filename),
                          interval).start()
