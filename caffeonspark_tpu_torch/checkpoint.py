""".caffemodel / .solverstate I/O: the Caffe files both packages read
and write.

A `.caffemodel` is a NetParameter whose layers carry `blobs` (the
weights in Caffe blob order); a `.solverstate` is a SolverState holding
the iteration, the model's file name (`learned_net`) and the solver's
history blobs.  Files written by the JAX package load here and the
other way round: those bytes are the contract between the two packages.
Besides the binaryproto files:

  * HDF5 (`snapshot_format: HDF5`, h5py): `<prefix>_iter_<N>.caffemodel.h5`
    with Caffe's `data/<layer>/<i>` layout, `.solverstate.h5` with the
    `iter` and `learned_net` attributes and `history/<i>`.  h5py is
    imported only where HDF5 is asked for; without it the run is refused
    by name (`require_h5py`), never written in another format;
  * sharded sidecars: the JAX package's multi-host writers leave a
    shape-only marker blob in the main file and the data in
    `<path>.shard<k>` npz slabs (`b<blob>__<start-stop_...>`).  Every
    reader here assembles them dense.  This package writes them for a
    ZeRO-1 state split over a dp axis that spans processes
    (`snapshot(..., write_main=)`): each process its own sidecar, rank 0
    the model and the `.solverstate` with the markers;
  * the quant sidecar `<model>.quant`: a serving replica's int8 / bf16
    weights and their scales (`save_quant_sidecar`);
  * `AsyncSnapshotter`: write-behind snapshots (-async_snapshot).

Every file lands through a temporary file and `os.replace`, so a reader
never sees half of one.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import re
import threading
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .net import Net, Params
from .parallel.comm import Shards
from .proto.caffe import (BlobProto, BlobShape, LayerParameter,
                          NetParameter, SnapshotFormat, SolverState)
from .solver import OptState
from .utils.fsutils import write_atomic, write_atomic_with


def _to_blobproto(arr: np.ndarray) -> BlobProto:
    a = np.asarray(arr, np.float32)
    return BlobProto(shape=BlobShape(dim=[int(d) for d in a.shape]),
                     data=a.ravel())


def _from_blobproto(bp: BlobProto) -> np.ndarray:
    if bp.shape.dim:
        shape = tuple(int(d) for d in bp.shape.dim)
    else:  # legacy 4D fields
        shape = tuple(d for d in (bp.num, bp.channels, bp.height,
                                  bp.width) if d) or (len(bp.data),)
    data = bp.data if len(bp.data) else bp.double_data
    return np.asarray(data, np.float32).reshape(shape)


def _host_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _write_message(path: str, msg) -> None:
    """A protobuf message to `path`, atomically; its float arrays go to
    the file from their buffers, with the interpreter lock released
    (`Message.write_to`)."""
    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            msg.write_to(f)

    write_atomic_with(path, write)


def require_h5py():
    """The h5py module, or a refusal naming it: an HDF5 snapshot is
    never written in another format."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "snapshot_format: HDF5 (and .h5 models) need the h5py "
            "package, which this machine lacks; use BINARYPROTO") from e
    return h5py


# ---------------------------------------------------------------------------
# sharded sidecars (the JAX package's multi-host format)
# ---------------------------------------------------------------------------

_SIDECAR_META = "__meta_nprocs__"


def _is_marker(bp: BlobProto) -> bool:
    """Shape-only blob (sharded sidecar marker): shape recorded, data
    absent."""
    return bool(bp.shape.dim) and not len(bp.data) \
        and not len(bp.double_data)


def _open_sidecar_slabs(path: str) -> Dict[str, np.ndarray]:
    """Every slab of every `<path>.shard<k>` sidecar, checked to be of
    one generation (as many files as each declares processes)."""
    d = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path) + ".shard"
    pat = re.compile(re.escape(base) + r"\d+$")    # excludes .tmp.*
    names = sorted(n for n in os.listdir(d) if pat.fullmatch(n))
    if not names:
        raise FileNotFoundError(
            f"{path}: file has sharded-blob markers but no {base}* "
            "sidecars exist")
    slabs: Dict[str, np.ndarray] = {}
    nprocs = set()
    for n in names:
        with np.load(os.path.join(d, n)) as z:
            for k in z.files:
                if k == _SIDECAR_META:
                    nprocs.add(int(z[k]))
                else:
                    slabs[k] = z[k]
    if len(nprocs) != 1 or len(names) != next(iter(nprocs)):
        raise ValueError(
            f"{path}: mixed-generation shard sidecars ({len(names)} "
            f"files, declared process counts {sorted(nprocs)}): clean "
            "stale .shard* files and re-snapshot")
    return slabs


def _assemble(idx: int, shape, slabs: Dict[str, np.ndarray]) -> np.ndarray:
    """Dense blob `idx` from the slabs keyed `b<idx>__<bounds>`."""
    prefix = f"b{idx}__"
    out = np.zeros(shape, np.float32)
    covered = np.zeros(shape, bool)
    for key, arr in slabs.items():
        if not key.startswith(prefix):
            continue
        bounds = tuple(slice(int(a), int(b)) for a, b in
                       (part.split("-")
                        for part in key[len(prefix):].split("_")))
        out[bounds] = arr
        covered[bounds] = True
    if not covered.all():
        raise ValueError(
            f"sharded blob {idx} (shape {tuple(shape)}): the sidecar "
            f"slabs cover only {covered.mean():.0%} of it; a shard file "
            "is missing")
    return out


# ---------------------------------------------------------------------------
# .caffemodel
# ---------------------------------------------------------------------------

def _model_blob_seq(net: Net, params: Params) -> Iterator[torch.Tensor]:
    for lp in net.compute_layers:
        for bname, _, _ in net.param_layout.get(lp.name, ()):
            yield params[lp.name][bname]


def _net_param(net: Net, protos: List[BlobProto]) -> NetParameter:
    out = NetParameter(name=net.name)
    it = iter(protos)
    for lp in net.compute_layers:
        copy = LayerParameter(name=lp.name, type=lp.type)
        for _ in net.param_layout.get(lp.name, ()):
            copy.blobs.append(next(it))
        out.layer.append(copy)
    return out


def params_to_net_param(net: Net, params: Params) -> NetParameter:
    """Learned params -> NetParameter carrying blobs (caffemodel body)."""
    return _net_param(net, [_to_blobproto(_host_f32(t))
                            for t in _model_blob_seq(net, params)])


def save_caffemodel(path: str, net: Net, params: Params) -> None:
    _write_message(path, params_to_net_param(net, params))


def save_model(path: str, net: Net, params: Params) -> None:
    """The final model: HDF5 when `path` ends in .h5, else binaryproto."""
    if path.endswith(".h5"):
        _save_h5_blobs(path, net, params)
    else:
        save_caffemodel(path, net, params)


def load_caffemodel_blobs(path: str) -> Dict[str, List[np.ndarray]]:
    """caffemodel (binaryproto, or HDF5 when `path` ends in .h5) ->
    {layer_name: [np arrays]} (unmatched layers kept).  Reads the modern
    `layer` field and the deprecated V1 `layers` field, so published
    legacy models import directly; a sharded model's markers are
    assembled dense from its `<path>.shard<k>` sidecars."""
    if path.endswith(".h5"):
        return _load_h5_blobs(path)
    with open(path, "rb") as f:
        npm = NetParameter.from_binary(f.read())
    markers = any(_is_marker(bp) for lp in npm.layer for bp in lp.blobs)
    slabs = _open_sidecar_slabs(path) if markers else {}
    out: Dict[str, List[np.ndarray]] = {}
    i = 0
    for lp in npm.layer:
        vals = []
        for bp in lp.blobs:
            if _is_marker(bp):
                try:
                    vals.append(_assemble(
                        i, tuple(int(d) for d in bp.shape.dim), slabs))
                except ValueError as e:
                    raise ValueError(f"{path}: layer {lp.name!r}: {e}") \
                        from None
            else:
                vals.append(_from_blobproto(bp))
            i += 1
        if vals:
            out[lp.name] = vals
    for lp in npm.layers:            # V1 legacy
        if lp.blobs and lp.name not in out:
            out[lp.name] = [_from_blobproto(bp) for bp in lp.blobs]
    return out


def _matching_blobs(net: Net, loaded: Dict[str, List[np.ndarray]],
                    path: str, strict: bool
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer: {blob: array}} of the file's blobs that fit the net's
    layout by name and shape (a legacy 4D blob of the same size is
    reshaped); with `strict`, a missing layer or shape mismatch raises."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for lname, specs in net.param_layout.items():
        if lname not in loaded:
            if strict:
                raise ValueError(f"layer {lname!r} missing from {path}")
            continue
        blobs = loaded[lname]
        for i, (bname, shape, _) in enumerate(specs[:len(blobs)]):
            arr = blobs[i]
            if tuple(arr.shape) != tuple(shape):
                if arr.size == int(np.prod(shape)):
                    arr = arr.reshape(shape)
                elif strict:
                    raise ValueError(
                        f"{lname}/{bname}: shape {arr.shape} != {shape}")
                else:
                    continue
            out.setdefault(lname, {})[bname] = arr
    if not out:
        raise ValueError(f"no blobs matched from {path}")
    return out


def _file_blobs(net: Net, path: str, strict: bool
                ) -> Dict[str, Dict[str, np.ndarray]]:
    return _matching_blobs(net, load_caffemodel_blobs(path), path, strict)


def _overlay(net: Net, params: Params,
             found: Dict[str, Dict[str, np.ndarray]]) -> Params:
    out = {ln: dict(bl) for ln, bl in params.items()}
    for lname, blobs in found.items():
        for bname, arr in blobs.items():
            # np.array copies: the decoded blob is a read-only view of
            # the file's bytes
            out.setdefault(lname, {})[bname] = torch.from_numpy(
                np.array(arr)).to(dtype=net.dtype, device=net.device)
    return out


def copy_layers(net: Net, params: Params, weights_path: str, *,
                strict: bool = False) -> Params:
    """Finetune semantics: overwrite params with same-named, same-shaped
    blobs from a .caffemodel[.h5] (CaffeNet.cpp copyLayers)."""
    return _overlay(net, params, _file_blobs(net, weights_path, strict))


def _read_state(state_path: str) -> Tuple[int, str, List[np.ndarray]]:
    """(iter, learned_net, history blobs) of a .solverstate[.h5]; a
    sharded state's markers are assembled from its sidecars."""
    if state_path.endswith(".h5"):
        h5py = require_h5py()
        with h5py.File(state_path, "r") as f:
            hist = [np.asarray(f["history"][k], np.float32) for k in
                    sorted(f["history"], key=int)]
            return (int(f.attrs["iter"]),
                    str(f.attrs.get("learned_net", "")), hist)
    with open(state_path, "rb") as f:
        st = SolverState.from_binary(f.read())
    marked = any(_is_marker(bp) for bp in st.history)
    slabs = _open_sidecar_slabs(state_path) if marked else {}
    hist = [_assemble(i, tuple(int(d) for d in bp.shape.dim), slabs)
            if _is_marker(bp) else _from_blobproto(bp)
            for i, bp in enumerate(st.history)]
    return int(st.iter), st.learned_net, hist


def _resolve_learned_net(state_path: str) -> str:
    """A .solverstate names its model via learned_net; resolve it next
    to the state file so serving can be pointed at either file."""
    if state_path.endswith(".h5"):
        with require_h5py().File(state_path, "r") as f:
            learned = str(f.attrs.get("learned_net", ""))
    else:
        with open(state_path, "rb") as f:
            learned = SolverState.from_binary(f.read()).learned_net
    if learned:
        cand = os.path.join(os.path.dirname(state_path),
                            os.path.basename(learned))
        if os.path.exists(cand):
            return cand
    raise ValueError(
        f"{state_path}: cannot resolve the model file from "
        f"learned_net={learned!r} — point serving at the "
        ".caffemodel directly")


def load_serving_params(net: Net, model_path: str, *,
                        strict: bool = False) -> Params:
    """Snapshot -> inference params without a solver: the file's blobs,
    and filler init (seed 0) for the layers it does not fully supply,
    exactly like -weights over a freshly initialized net (only those
    layers are drawn).  A .solverstate[.h5] resolves its learned_net
    pointer first."""
    path = model_path
    if ".solverstate" in os.path.basename(path):
        path = _resolve_learned_net(path)
    found = _file_blobs(net, path, strict)
    missing = [ln for ln, specs in net.param_layout.items()
               if len(found.get(ln, {})) < len(specs)]
    return _overlay(net, net.init(0, layers=missing), found)


# ---------------------------------------------------------------------------
# HDF5 (snapshot_format: HDF5)
# ---------------------------------------------------------------------------

def _save_h5_blobs(path: str, net: Net, params: Params) -> None:
    """Caffe's HDF5 model layout: data/<layer>/<blob index>, f32."""
    h5py = require_h5py()

    def write(tmp: str) -> None:
        with h5py.File(tmp, "w") as f:
            data = f.create_group("data")
            for lname, specs in net.param_layout.items():
                g = data.create_group(lname)
                for i, (bname, _, _) in enumerate(specs):
                    g.create_dataset(str(i),
                                     data=_host_f32(params[lname][bname]))

    write_atomic_with(path, write)


def _load_h5_blobs(path: str) -> Dict[str, List[np.ndarray]]:
    h5py = require_h5py()
    out: Dict[str, List[np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        data = f["data"]
        for lname in data:
            g = data[lname]
            out[lname] = [np.asarray(g[k], np.float32)
                          for k in sorted(g, key=int)]
    return out


# ---------------------------------------------------------------------------
# snapshot / restore (model + solver state)
# ---------------------------------------------------------------------------

def snapshot_filename(prefix: str, it: int, *, is_state: bool,
                      h5: bool = False) -> str:
    ext = "solverstate" if is_state else "caffemodel"
    return f"{prefix}_iter_{it}.{ext}" + (".h5" if h5 else "")


def _state_blob_seq(net: Net, opt_state: OptState, solver_type: str
                    ) -> Iterator[torch.Tensor]:
    """State blobs in the .solverstate order: history, then (for the
    two-accumulator solvers only) history2, each in the net's blob
    order, as the JAX package and Caffe write them."""
    hists = ((opt_state.history, opt_state.history2)
             if solver_type.upper() in ("ADAM", "ADADELTA")
             else (opt_state.history,))
    for hist in hists:
        for lname, specs in net.param_layout.items():
            for bname, _, _ in specs:
                yield hist[lname][bname]


def whole_state(opt_state: OptState) -> OptState:
    """The state with each ZeRO-1 blob's dp slices joined (an
    all_gather), so that a snapshot from a mesh has dp 1's layout; a
    blob whose slices span processes stays as it is (its sidecars)."""

    def whole(tree):
        return {ln: {bn: t.whole() if isinstance(t, Shards)
                     and not t.spans else t
                     for bn, t in bl.items()} for ln, bl in tree.items()}
    return OptState(iter=opt_state.iter, history=whole(opt_state.history),
                    history2=whole(opt_state.history2))


def state_is_sharded(opt_state: OptState) -> bool:
    """True when a ZeRO-1 state blob's slices span processes: then every
    process calls `snapshot` (its sidecar), rank 0 with `write_main`."""
    return any(isinstance(t, Shards) and t.spans
               for tree in (opt_state.history, opt_state.history2)
               for bl in tree.values() for t in bl.values())


def _slabs(blob: Shards, shape) -> Dict[str, np.ndarray]:
    """This process's slices of a blob split over processes, keyed by
    their bounds in the whole blob (`<start>-<stop>` a dimension, joined
    by `_`: the JAX package's `_bounds_key`)."""
    out = {}
    for j, t in enumerate(blob):
        size = t.shape[blob.dim]
        start = (blob.first + j) * size
        key = "_".join(f"{start}-{start + size}" if d == blob.dim
                       else f"0-{n}" for d, n in enumerate(shape))
        out[key] = _host_f32(t)
    return out


def _shard_path(state_path: str, blob: Shards) -> Tuple[str, int]:
    """(`<state>.shard<process>`, processes) of a blob's slices."""
    k = len(blob)
    return f"{state_path}.shard{blob.first // k}", blob.parts // k


def _write_state_sidecar(net: Net, opt_state: OptState, state_path: str,
                         solver_type: str) -> None:
    """This process's sidecar: the slices of every state blob split over
    processes (`b<index>__<bounds>` in the `.solverstate`'s blob order,
    and the number of processes), as the JAX package writes it."""
    slabs: Dict[str, np.ndarray] = {}
    path, procs = None, 1
    for i, t in enumerate(_state_blob_seq(net, opt_state, solver_type)):
        if isinstance(t, Shards) and t.spans:
            shape = list(t[0].shape)
            shape[t.dim] *= t.parts
            for key, arr in _slabs(t, shape).items():
                slabs[f"b{i}__{key}"] = arr
            path, procs = _shard_path(state_path, t)
    if path is None:
        return

    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            np.savez(f, **slabs, **{_SIDECAR_META: np.asarray(procs,
                                                              np.int64)})

    write_atomic_with(path, write)


def _state_proto(t) -> BlobProto:
    """A state blob's entry in the `.solverstate`: its data, or a
    shape-only marker when its slices span processes."""
    if isinstance(t, Shards) and t.spans:
        shape = list(t[0].shape)
        shape[t.dim] *= t.parts
        return BlobProto(shape=BlobShape(dim=shape))
    return _to_blobproto(_host_f32(t))


def snapshot(net: Net, params: Params, opt_state: OptState, prefix: str,
             *, fmt: int = SnapshotFormat.BINARYPROTO,
             solver_type: str = "SGD",
             write_main: bool = True) -> Tuple[str, str]:
    """Write `<prefix>_iter_<it>.caffemodel[.h5]`, then its
    `.solverstate[.h5]` (the commit point: a state file always has its
    model); returns the two paths.  A ZeRO-1 state is gathered first
    (`whole_state`).  One split over processes is not: each process
    writes its slices to `<state>.shard<process>` (between the model and
    the state), the `.solverstate` carries shape-only markers for them,
    and `write_main=False` (every process but rank 0) writes the sidecar
    alone."""
    opt_state = whole_state(opt_state)
    it = int(opt_state.iter)
    h5 = fmt == SnapshotFormat.HDF5
    sharded = state_is_sharded(opt_state)
    if h5:
        if sharded:
            raise ValueError("a ZeRO-1 state split over processes needs "
                             "the BINARYPROTO snapshot_format (the .h5 "
                             "container has no shape-only marker)")
        require_h5py()
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    model_path = snapshot_filename(prefix, it, is_state=False, h5=h5)
    state_path = snapshot_filename(prefix, it, is_state=True, h5=h5)
    if not write_main:
        _write_state_sidecar(net, opt_state, state_path, solver_type)
        return model_path, state_path
    if sharded:
        save_caffemodel(model_path, net, params)
        _write_state_sidecar(net, opt_state, state_path, solver_type)
        st = SolverState(iter=it, learned_net=os.path.basename(model_path))
        st.history.extend(_state_proto(t) for t in
                          _state_blob_seq(net, opt_state, solver_type))
        _write_message(state_path, st)
        return model_path, state_path
    hist = [_host_f32(t)
            for t in _state_blob_seq(net, opt_state, solver_type)]
    if h5:
        _save_h5_blobs(model_path, net, params)

        def write_state(tmp: str) -> None:
            with require_h5py().File(tmp, "w") as f:
                f.attrs["iter"] = it
                f.attrs["learned_net"] = os.path.basename(model_path)
                g = f.create_group("history")
                for i, h in enumerate(hist):
                    g.create_dataset(str(i), data=h)

        write_atomic_with(state_path, write_state)
        return model_path, state_path
    save_caffemodel(model_path, net, params)
    st = SolverState(iter=it, learned_net=os.path.basename(model_path))
    st.history.extend(_to_blobproto(h) for h in hist)
    _write_message(state_path, st)
    return model_path, state_path


def restore(net: Net, params: Params, opt_state: OptState,
            state_path: str, *, weights_path: Optional[str] = None
            ) -> Tuple[Params, OptState]:
    """Resume from a .solverstate[.h5] and its model: the model is
    -weights when given, else `learned_net` next to the state file.
    History blobs keep the dtype of `opt_state`'s (the file stores f32);
    a state without second moments leaves history2 as given."""
    it, learned, hist = _read_state(state_path)
    if weights_path is None:
        cand = os.path.join(os.path.dirname(state_path),
                            os.path.basename(learned or ""))
        if not learned or not os.path.exists(cand):
            raise ValueError(f"{state_path}: resume needs its model file "
                             f"(learned_net={learned!r} is not next "
                             "to it; pass -weights)")
        weights_path = cand
    params = copy_layers(net, params, weights_path)
    n_blobs = sum(len(specs) for specs in net.param_layout.values())
    history = {ln: dict(bl) for ln, bl in opt_state.history.items()}
    history2 = {ln: dict(bl) for ln, bl in opt_state.history2.items()}
    i = 0
    for dest in (history, history2):
        for lname, specs in net.param_layout.items():
            for bname, shape, _ in specs:
                if i < len(hist) and hist[i].size == int(np.prod(shape)):
                    old = dest[lname][bname]
                    dest[lname][bname] = torch.from_numpy(
                        np.array(hist[i].reshape(shape))).to(
                            dtype=old.dtype, device=old.device)
                i += 1
        if len(hist) < 2 * n_blobs:
            break      # a state without second moments
    return params, OptState(iter=it, history=history, history2=history2)


# ---------------------------------------------------------------------------
# write-behind snapshots (-async_snapshot)
# ---------------------------------------------------------------------------

_LIVE_SNAPSHOTTERS: "weakref.WeakSet[AsyncSnapshotter]" = weakref.WeakSet()


@atexit.register
def _drain_live_snapshotters() -> None:
    for snap in list(_LIVE_SNAPSHOTTERS):
        snap._drain()


class AsyncSnapshotter:
    """Write-behind snapshots (JAX checkpoint.py:1009-1127).

    `submit` copies params and solver state to the host and returns;
    a worker thread serializes and writes them with `snapshot`, so the
    train loop goes on while the files are written.  The solver updates
    its tensors in place (and a CUDA graph replay rewrites the same
    buffers), so the copy is finished before `submit` returns: on a card
    each tensor is copied into a pinned host buffer of its own (kept for
    the next snapshot) on the current stream, then that stream is
    synchronized.  At most one write is in flight: a second `submit`
    first waits for the previous one.  A write's error surfaces as
    RuntimeError on the next `submit` or `wait`.  Interpreter exit waits
    for a write in flight (one `atexit` hook over a weak set); `close`
    joins the thread."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None
        self._last_done: Optional[threading.Event] = None
        self._err: Optional[BaseException] = None
        self._pinned: Dict[tuple, torch.Tensor] = {}
        _LIVE_SNAPSHOTTERS.add(self)

    def _drain(self) -> None:
        if self._last_done is not None:
            self._last_done.wait(timeout=120)

    def close(self) -> None:
        """Wait for the write in flight, stop the worker, leave the exit
        hook's set."""
        self._drain()
        if self._thread is not None and self._thread.is_alive():
            self._q.put((None, None))           # the worker exits
            self._thread.join(timeout=10)
        self._thread = None
        _LIVE_SNAPSHOTTERS.discard(self)

    def _run(self) -> None:
        while True:
            fn, done = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced later
                self._err = e
            finally:
                done.set()

    def check(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async snapshot failed") from err

    def _host(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        """A host copy of `t`: on a card into its pinned buffer,
        asynchronously (the caller synchronizes); a CPU tensor is
        cloned."""
        t = t.detach()
        if not t.is_cuda:
            return t.clone()
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._pinned[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def submit(self, net: Net, params: Params, opt_state: OptState,
               prefix: str, *, fmt: int = SnapshotFormat.BINARYPROTO,
               solver_type: str = "SGD") -> threading.Event:
        self.check()
        if self._last_done is not None:
            self._last_done.wait()   # one write in flight, one host copy
            self.check()
        opt_state = whole_state(opt_state)
        trees = {"p": params, "h": opt_state.history,
                 "h2": opt_state.history2}
        host = {k: {ln: {bn: self._host((k, ln, bn), t)
                         for bn, t in bl.items()}
                    for ln, bl in tree.items()}
                for k, tree in trees.items()}
        devices = {t.device for tree in trees.values()
                   for bl in tree.values() for t in bl.values() if t.is_cuda}
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        state = OptState(iter=int(opt_state.iter), history=host["h"],
                         history2=host["h2"])
        done = threading.Event()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="cos-snapshotter")
            self._thread.start()
        self._q.put((lambda: snapshot(net, host["p"], state, prefix,
                                      fmt=fmt, solver_type=solver_type),
                     done))
        self._last_done = done
        return done

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the last submitted snapshot has landed; raise
        its error, or TimeoutError after `timeout` seconds."""
        if self._last_done is not None:
            if not self._last_done.wait(timeout):
                raise TimeoutError("snapshot still in flight")
        self.check()


# ---------------------------------------------------------------------------
# quant sidecar (serving weight residency, serving/quant.py)
# ---------------------------------------------------------------------------
# `<model>.quant` holds a serving replica's compressed weights beside the
# f32 .caffemodel: int8 / bf16 blobs and the int8 blobs' max-abs scales,
# one flat npz under "layer::blob" keys, the scales under
# "__scale__::layer::blob" (a Scale layer's blob is named "scale", so a
# suffix would collide).  npz has no bf16, so bf16 blobs are stored as
# uint16 bit patterns and the meta record lists their keys.

FLAT_KEY_SEP = "::"
QUANT_SIDECAR_SUFFIX = ".quant"
_QUANT_META_KEY = "__quant_meta__"
_QUANT_SCHEMA = "cos-quant-sidecar-v1"
_SCALE_PREFIX = f"__scale__{FLAT_KEY_SEP}"


def _storage_numpy(arr) -> Tuple[np.ndarray, bool]:
    """(host array, is bf16): a bf16 tensor (or a numpy bfloat16 array)
    as its uint16 bit patterns."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), True
    return a, False


def save_quant_sidecar(path: str, blobs: Dict[str, Dict[str, object]],
                       scales: Dict[str, Dict[str, float]],
                       weight_dtype: str) -> str:
    """Write the compressed-weight sidecar (atomically).  `blobs` are
    tensors or arrays in storage dtype (int8, bf16 or f32), `scales` the
    int8 blobs' dequant scalars."""
    flat: Dict[str, np.ndarray] = {}
    bf16_keys = []
    for ln, bl in blobs.items():
        if FLAT_KEY_SEP in ln:
            raise ValueError(f"layer name {ln!r} contains "
                             f"{FLAT_KEY_SEP!r}")
        for bn, arr in bl.items():
            key = f"{ln}{FLAT_KEY_SEP}{bn}"
            flat[key], is_bf16 = _storage_numpy(arr)
            if is_bf16:
                bf16_keys.append(key)
    for ln, bl in scales.items():
        for bn, s in bl.items():
            flat[f"{_SCALE_PREFIX}{ln}{FLAT_KEY_SEP}{bn}"] = \
                np.asarray(float(s), np.float32)
    flat[_QUANT_META_KEY] = np.frombuffer(json.dumps({
        "schema": _QUANT_SCHEMA, "weight_dtype": weight_dtype,
        "bf16_keys": bf16_keys}).encode(), np.uint8)

    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **flat)

    write_atomic_with(path, write)
    return path


def load_quant_sidecar(path: str) -> Tuple[
        Dict[str, Dict[str, torch.Tensor]], Dict[str, Dict[str, float]],
        str]:
    """Read a quant sidecar -> (host tensors in storage dtype, scales,
    weight_dtype); bf16 blobs come back as torch.bfloat16 views of their
    bit patterns."""
    with np.load(path) as z:
        if _QUANT_META_KEY not in z:
            raise ValueError(f"{path}: not a {_QUANT_SCHEMA} sidecar")
        meta = json.loads(bytes(z[_QUANT_META_KEY].tobytes()).decode())
        if meta.get("schema") != _QUANT_SCHEMA:
            raise ValueError(f"{path}: schema {meta.get('schema')!r} != "
                             f"{_QUANT_SCHEMA}")
        bf16 = set(meta.get("bf16_keys", ()))
        blobs: Dict[str, Dict[str, torch.Tensor]] = {}
        scales: Dict[str, Dict[str, float]] = {}
        for key in z.files:
            if key == _QUANT_META_KEY:
                continue
            if key.startswith(_SCALE_PREFIX):
                ln, bn = key[len(_SCALE_PREFIX):].split(FLAT_KEY_SEP, 1)
                scales.setdefault(ln, {})[bn] = float(z[key])
                continue
            ln, bn = key.split(FLAT_KEY_SEP, 1)
            arr = z[key]
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if key in bf16 else torch.from_numpy(arr))
            blobs.setdefault(ln, {})[bn] = t
    return blobs, scales, meta["weight_dtype"]
