"""Atomic file writes (the JAX package's `utils/fsutils.py`
`atomic_write_local`)."""

from __future__ import annotations

import os


def write_atomic(path: str, data: bytes) -> None:
    """tmp + fsync + rename: a reader never sees half a file.  The
    directory is made when it does not exist yet (-output of a run that
    writes no snapshot before its final model)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
