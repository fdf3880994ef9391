"""Atomic file writes (the JAX package's `utils/fsutils.py`
`atomic_write_local`): a file lands through a temporary file, fsync and
`os.replace`, so a reader never sees half of one."""

from __future__ import annotations

import os


def write_atomic(path: str, data: bytes) -> None:
    """tmp + fsync + rename: a reader never sees half a file.  The
    directory is made when it does not exist yet (-output of a run that
    writes no snapshot before its final model)."""
    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(data)

    write_atomic_with(path, write)


def write_atomic_with(path: str, write_fn) -> None:
    """`write_fn(tmp)` writes the file at a temporary path (an HDF5
    library that opens the file itself), then fsync + rename into
    place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    write_fn(tmp)
    fd = os.open(tmp, os.O_RDWR)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
