""".caffemodel / .solverstate I/O: the Caffe binaryproto files both
packages read and write.

A `.caffemodel` is a NetParameter whose layers carry `blobs` (the
weights in Caffe blob order); a `.solverstate` is a SolverState holding
the iteration, the model's file name (`learned_net`) and the solver's
history blobs.  Files written by the JAX package load here and the
other way round: those bytes are the contract between the two packages.
Every file lands through a temporary file and `os.replace`, so a reader
never sees half of one.  HDF5 snapshots, sharded sidecars and the
write-behind snapshotter come with later slices.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .net import Net, Params
from .proto.caffe import (BlobProto, BlobShape, LayerParameter,
                          NetParameter, SnapshotFormat, SolverState)
from .solver import OptState
from .utils.fsutils import write_atomic


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


def params_to_net_param(net: Net, params: Params) -> NetParameter:
    """Learned params -> NetParameter carrying blobs (caffemodel body)."""
    out = NetParameter(name=net.name)
    for lp in net.compute_layers:
        copy = LayerParameter(name=lp.name, type=lp.type)
        if lp.name in net.param_layout:
            blobs = params[lp.name]
            for bname, _, _ in net.param_layout[lp.name]:
                host = blobs[bname].detach().to("cpu", torch.float32)
                copy.blobs.append(_to_blobproto(host.numpy()))
        out.layer.append(copy)
    return out


def save_caffemodel(path: str, net: Net, params: Params) -> None:
    write_atomic(path, params_to_net_param(net, params).to_binary())


def load_caffemodel_blobs(path: str) -> Dict[str, List[np.ndarray]]:
    """caffemodel -> {layer_name: [np arrays]} (unmatched layers kept).
    Reads both the modern `layer` field and the deprecated V1 `layers`
    field, so published legacy models import directly."""
    with open(path, "rb") as f:
        npm = NetParameter.from_binary(f.read())
    out: Dict[str, List[np.ndarray]] = {}
    for lp in npm.layer:
        vals = []
        for bp in lp.blobs:
            if bp.shape.dim and not len(bp.data) and not len(bp.double_data):
                raise ValueError(
                    f"{path}: layer {lp.name!r} holds a sharded-model "
                    "marker; sharded caffemodels are not readable by the "
                    "PyTorch port yet")
            vals.append(_from_blobproto(bp))
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
    if path.endswith(".h5"):
        raise ValueError(f"{path}: HDF5 models are not readable by the "
                         "PyTorch port yet")
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
    blobs from a .caffemodel (CaffeNet.cpp copyLayers)."""
    return _overlay(net, params, _file_blobs(net, weights_path, strict))


def _resolve_learned_net(state_path: str) -> str:
    """A .solverstate names its model via learned_net; resolve it next
    to the state file so serving can be pointed at either file."""
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
    layers are drawn).  A .solverstate resolves its learned_net pointer
    first."""
    path = model_path
    if ".solverstate" in os.path.basename(path):
        path = _resolve_learned_net(path)
    found = _file_blobs(net, path, strict)
    missing = [ln for ln, specs in net.param_layout.items()
               if len(found.get(ln, {})) < len(specs)]
    return _overlay(net, net.init(0, layers=missing), found)


# ---------------------------------------------------------------------------
# snapshot / restore (model + solver state)
# ---------------------------------------------------------------------------

def snapshot_filename(prefix: str, it: int, *, is_state: bool) -> str:
    ext = "solverstate" if is_state else "caffemodel"
    return f"{prefix}_iter_{it}.{ext}"


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


HDF5_REFUSAL = ("HDF5 snapshots wait for a later slice of the PyTorch "
                "port (use BINARYPROTO)")


def snapshot(net: Net, params: Params, opt_state: OptState, prefix: str,
             *, fmt: int = SnapshotFormat.BINARYPROTO,
             solver_type: str = "SGD") -> Tuple[str, str]:
    """Write `<prefix>_iter_<it>.caffemodel`, then its `.solverstate`
    (the commit point: a state file always has its model); returns the
    two paths."""
    if fmt == SnapshotFormat.HDF5:
        raise NotImplementedError(HDF5_REFUSAL)
    it = int(opt_state.iter)
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    model_path = snapshot_filename(prefix, it, is_state=False)
    state_path = snapshot_filename(prefix, it, is_state=True)
    save_caffemodel(model_path, net, params)
    st = SolverState(iter=it, learned_net=os.path.basename(model_path))
    st.history.extend(
        _to_blobproto(b.detach().to("cpu", torch.float32).numpy())
        for b in _state_blob_seq(net, opt_state, solver_type))
    write_atomic(state_path, st.to_binary())
    return model_path, state_path


def restore(net: Net, params: Params, opt_state: OptState,
            state_path: str, *, weights_path: Optional[str] = None
            ) -> Tuple[Params, OptState]:
    """Resume from a .solverstate and its model: the model is -weights
    when given, else `learned_net` next to the state file.  History
    blobs keep the dtype of `opt_state`'s (the file stores f32); a state
    without second moments leaves history2 as given."""
    if state_path.endswith(".h5"):
        raise NotImplementedError("HDF5 solver states wait for a later "
                                  "slice of the PyTorch port")
    with open(state_path, "rb") as f:
        st = SolverState.from_binary(f.read())
    hist = [_from_blobproto(bp) for bp in st.history]
    if weights_path is None:
        cand = os.path.join(os.path.dirname(state_path),
                            os.path.basename(st.learned_net or ""))
        if not st.learned_net or not os.path.exists(cand):
            raise ValueError(f"{state_path}: resume needs its model file "
                             f"(learned_net={st.learned_net!r} is not next "
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
    return params, OptState(iter=int(st.iter), history=history,
                            history2=history2)
