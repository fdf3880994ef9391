"""Utilities: step timing and profiling (the JAX package's
`utils/tracing.py`) and atomic file writes (`utils/fsutils.py`)."""

from .tracing import StepTimer, profile_trace

__all__ = ["StepTimer", "profile_trace"]
