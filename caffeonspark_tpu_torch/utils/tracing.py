"""Step timing and profiling, a copy of the JAX package's
`utils/tracing.py`:

  * StepTimer - per-step wall clock with EMA smoothing, records/s, and
    the totals line a trainer prints at the end;
  * profile_trace - a context manager around `torch.profiler` that
    writes a Chrome trace (`trace.json`, loadable in chrome://tracing or
    Perfetto) into a directory (mini_cluster's `-profile DIR`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


class StepTimer:
    def __init__(self, *, batch_size: int = 0, ema: float = 0.05):
        self.batch_size = batch_size
        self.ema = ema
        self._t0: Optional[float] = None
        self._last: Optional[float] = None
        self.step_time: Optional[float] = None   # EMA seconds/step
        self.steps = 0

    def start(self) -> None:
        self._t0 = self._last = time.perf_counter()

    def tick(self, n: int = 1) -> float:
        """Call once per completed dispatch covering `n` solver steps;
        returns the seconds since the previous tick."""
        now = time.perf_counter()
        if self._last is None:
            self.start()
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        n = max(1, n)
        self.steps += n
        per = dt / n
        self.step_time = per if self.step_time is None else (
            (1 - self.ema) * self.step_time + self.ema * per)
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.step_time if self.step_time else 0.0

    @property
    def records_per_sec(self) -> float:
        return self.batch_size * self.steps_per_sec

    def summary(self) -> str:
        """Totals from wall-clock averages (steps / total), not the EMA."""
        total = (time.perf_counter() - self._t0) if self._t0 else 0.0
        avg = self.steps / total if total > 0 else 0.0
        return (f"{self.steps} steps in {total:.1f}s "
                f"({avg:.1f} it/s"
                + (f", {self.batch_size * avg:.0f} rec/s"
                   if self.batch_size else "") + ")")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block (CPU, and CUDA when a card is
    visible) when `log_dir` is set, its Chrome trace written to
    `<log_dir>/trace.json` on exit; a no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
