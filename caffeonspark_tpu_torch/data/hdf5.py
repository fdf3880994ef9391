"""HDF5Data source: Caffe's hdf5_data_layer.cpp semantics.

The port's copy of `caffeonspark_tpu/data/hdf5.py`.  h5py is imported
where a file is read or written, and its absence is refused by name
(`_h5py`).

`hdf5_data_param.source` is a TEXT FILE listing .h5 paths (one per
line); each file carries one dataset per top blob, first axis = rows.
Shapes come from the first listed file (hdf5_data_layer.cpp
LoadHDF5FileData); no transform_param (Caffe forbids it on HDF5Data).
The reference never shipped an HDF5 CoS source; this provides the
layer end to end: the shape probe of net construction
(net.py::data_layer_input_specs) and a DataSource that feeds row
batches, which packs its own tops and takes no augmentation draw (so
the transformer pool gives it none, as DataFrameSource).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from .source import DataSource, _strip_scheme


def _h5py():
    """The h5py module, or an ImportError naming it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("HDF5Data / HDF5Output files need the h5py "
                          "package, which is not installed") from e
    return h5py


def _file_list(list_path: str) -> List[str]:
    base = os.path.dirname(os.path.abspath(list_path))
    out = []
    with open(list_path) as f:
        for line in f:
            p = line.strip()
            if not p:
                continue
            if not os.path.isabs(p):
                p = os.path.join(base, p)
            out.append(p)
    if not out:
        raise ValueError(f"HDF5 source list {list_path} is empty")
    return out


# h5py surfaces corruption as a zoo of exception types (OSError,
# KeyError, IndexError on short datasets, RuntimeError, AttributeError
# on partially-parsed object headers) — converted to the data readers'
# one documented failure mode (ValueError) at the per-file read
# boundaries.  A genuine FileNotFoundError is re-raised untouched (a
# missing file is not a corrupt one — same rule as
# sequencefile._DECOMPRESS_ERRORS).
_H5_ERRORS = (OSError, KeyError, IndexError, RuntimeError,
              AttributeError)


@contextmanager
def _h5_boundary(path: str, what: str):
    try:
        yield
    except FileNotFoundError:
        raise
    except _H5_ERRORS as e:
        raise ValueError(f"{path}: corrupt/unreadable HDF5 {what}: "
                         f"{type(e).__name__}: {e}") from e


def hdf5_top_shapes(list_path: str, tops: Sequence[str],
                    batch_size: int) -> Dict[str, Tuple[int, ...]]:
    """(batch,) + per-row shape for each top, probed from the first
    file — the hdf5_data_layer.cpp top-sizing rule."""
    h5py = _h5py()
    first = _file_list(_strip_scheme(list_path))[0]
    shapes: Dict[str, Tuple[int, ...]] = {}
    with _h5_boundary(first, "file"):
        with h5py.File(first, "r") as f:
            for top in tops:
                if top not in f:
                    raise ValueError(
                        f"dataset {top!r} missing from {first} "
                        f"(has: {sorted(f.keys())})")
                shapes[top] = (batch_size,) + tuple(f[top].shape[1:])
    return shapes


class HDF5Source(DataSource):
    """Yields (row_id, {top: row_array}) records; next_batch stacks."""

    def _batch_size(self) -> int:
        return int(self.layer.hdf5_data_param.batch_size)

    def source_uri(self) -> str:
        return _strip_scheme(self.layer.hdf5_data_param.source)

    def image_dims(self):  # not an image source
        raise NotImplementedError("HDF5Data has no image dims")

    def records(self) -> Iterator[tuple]:
        tops = list(self.layer.top)
        files = _file_list(self.source_uri())
        # rank sharding: round-robin whole files when possible, else
        # row-striping within the single file
        if len(files) >= self.num_ranks > 1:
            files = files[self.rank::self.num_ranks]
            stride, offset = 1, 0
        else:
            stride, offset = max(1, self.num_ranks), self.rank
        for path in files:
            yield from self._file_rows(path, tops, offset, stride)

    def _file_rows(self, path, tops, offset, stride):
        """One file's rows; ONLY the h5py read is wrapped (a missing
        list file or programming error must not be re-branded as
        data corruption)."""
        h5py = _h5py()
        with _h5_boundary(path, "data"):
            with h5py.File(path, "r") as f:
                for t in tops:
                    if t not in f:
                        raise ValueError(
                            f"dataset {t!r} missing from {path} "
                            f"(has: {sorted(f.keys())})")
                counts = {t: f[t].shape[0] for t in tops}
                if len(set(counts.values())) > 1:
                    # hdf5_data_layer.cpp CHECKs equal num() across
                    # datasets — mismatched rows would otherwise leak
                    # an IndexError mid-epoch
                    raise ValueError(
                        f"{path}: datasets disagree on row count: "
                        f"{counts}")
                n = counts[tops[0]]
                arrays = {t: f[t] for t in tops}
                for i in range(offset, n, stride):
                    yield (f"{os.path.basename(path)}:{i}",
                           {t: np.asarray(arrays[t][i], np.float32)
                            for t in tops})

    def next_batch(self, records, draw=None) -> Dict[str, np.ndarray]:
        """Rows stacked per top; `draw` is always None here."""
        tops = list(self.layer.top)
        return {t: np.stack([r[1][t] for r in records]).astype(
            np.float32) for t in tops}


# ---------------------------------------------------------------------------
# HDF5Output sink (hdf5_output_layer.cpp analog)
# ---------------------------------------------------------------------------

def collect_hdf5_outputs(forward_state: Dict) -> Dict[str, List]:
    """Pull the 'hdf5_output:<layer>' side-channel entries out of a
    forward's `state_out`: {layer_name: [bottom tensors]}."""
    prefix = "hdf5_output:"
    return {k[len(prefix):]: v for k, v in forward_state.items()
            if k.startswith(prefix)}


def _host_f32(x) -> np.ndarray:
    """A tensor (any device) or array as a float32 host array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def write_hdf5_outputs(file_name: str, batches: Sequence[Sequence],
                       names: Sequence[str] = ("data", "label")) -> None:
    """Write accumulated HDF5Output batches to `file_name` with Caffe's
    dataset naming (hdf5_output_layer.cpp SaveBlobs: bottoms map to
    'data' and 'label'); batches are concatenated along axis 0."""
    h5py = _h5py()
    if not batches:
        raise ValueError("no HDF5Output batches to write")
    n_bottoms = len(batches[0])
    with h5py.File(file_name, "w") as f:
        for i in range(n_bottoms):
            name = names[i] if i < len(names) else f"blob{i}"
            arr = np.concatenate(
                [_host_f32(b[i]) for b in batches], axis=0)
            f.create_dataset(name, data=arr)
