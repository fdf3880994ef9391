"""Blob-forward builder: the predict(blobNames) closure factory.

The counterpart of `caffeonspark_tpu/serving/forward.py`: serving
flushes (and warm-up) share this one forward and one row extraction,
which is what makes a full bucket's serving rows byte-equal to a direct
forward of the same batch.  PyTorch runs eagerly, so a closure is the
net's forward under `torch.inference_mode()`; it is cached per blob set
and storage dtype only so that every flush reuses one object.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..net import Net
from ..ops.layers import flash_mesh
from ..parallel.dp import rank_params, shard_inputs


def pin_f32_precision() -> None:
    """f32 serving computes in f32: cuBLAS matmuls already do by default
    (`allow_tf32` False), but cuDNN convolutions default to TF32, which
    keeps about three decimal digits.  Both are pinned off here, and bf16
    GEMMs accumulate in f32 (reduced-precision reduction off), as the
    TPU's MXU does; this is process-wide PyTorch state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def make_forward_fn(net: Net, blob_names: Tuple[str, ...], layout=None):
    """predict(blobNames) semantics (CaffeNet.cpp:677-697): forward,
    then read ANY named blob, not just net outputs.  Under a `layout`
    (parallel.mesh.MeshLayout) of more than one rank the batch splits
    over its dp ranks, each runs the forward on its slice
    (`Net.forward_ranks`, tp-split params, attention per (B/dp, H/tp)
    block), and the named blobs are joined back in row order
    (`Net.join_ranks`)."""
    if layout is not None and layout.mesh.size > 1:
        def fwd_mesh(params, inputs):
            with torch.inference_mode(), flash_mesh(layout.mesh):
                blobs = net.forward_ranks(
                    rank_params(layout, params),
                    shard_inputs(layout, inputs, net), mesh=layout.mesh)
                return net.join_ranks(blobs, blob_names)
        return fwd_mesh

    def fwd(params, inputs):
        with torch.inference_mode():
            blobs = net(params, inputs)
            return {bn: blobs[bn] for bn in blob_names}
    return fwd


def _dequant_entry(params, scales, spec):
    """Storage params -> compute params: bf16 upcasts, int8 dequantizes
    by its per-blob scale, int8 InnerProduct weights pass through with
    their scale routed to the kernel via the qscales side channel."""
    from .quant import BF16, INT8, INT8_IP
    p2 = {}
    qscales: Dict[str, dict] = {}
    for ln, bl in params.items():
        sp = spec.get(ln) or {}
        out = {}
        for bn, arr in bl.items():
            kind = sp.get(bn)
            if kind == BF16:
                out[bn] = arr.to(torch.float32)
            elif kind == INT8:
                out[bn] = arr.to(torch.float32) * scales[ln][bn]
            elif kind == INT8_IP:
                out[bn] = arr              # the int8 kernel consumes it
                qscales.setdefault(ln, {})[bn] = scales[ln][bn]
            else:
                out[bn] = arr
        p2[ln] = out
    return p2, qscales


def make_quant_forward_fn(net: Net, blob_names: Tuple[str, ...],
                          spec: Dict[str, Dict[str, str]]):
    """Forward over COMPRESSED resident params (serving/quant.py storage
    spec); signature (params, scales, inputs)."""
    def fwd(params, scales, inputs):
        with torch.inference_mode():
            p2, qscales = _dequant_entry(params, scales, spec)
            blobs = net(p2, inputs, qscales=qscales)
            return {bn: blobs[bn] for bn in blob_names}
    return fwd


class BlobForward:
    """predict(blobNames) closures for one Net, cached per (blob set,
    storage dtype).  Closures are params-agnostic, so a model hot-swap
    reuses them.  On a CUDA net, constructing one pins f32 precision
    (see pin_f32_precision).  `layout` (a MeshLayout, shared with the
    ParallelSolver that trains the params) runs the f32 forward on the
    mesh (`make_forward_fn`); a compressed storage dtype on a mesh is
    serving's, a later slice."""

    def __init__(self, net: Net, layout=None):
        self.net = net
        self.layout = layout
        self._cache: Dict[Tuple, Any] = {}
        if net.device.type == "cuda":
            pin_f32_precision()

    def __call__(self, blob_names: Tuple[str, ...],
                 weight_dtype: str = "f32"):
        key = (tuple(blob_names), weight_dtype)
        if key not in self._cache:
            if weight_dtype == "f32":
                fwd = make_forward_fn(self.net, tuple(blob_names),
                                      self.layout)
            elif self.layout is not None and self.layout.mesh.size > 1:
                raise ValueError(f"weight dtype {weight_dtype!r} on a "
                                 "mesh: serving on a mesh is a later "
                                 "slice of the PyTorch port")
            else:
                from .quant import quant_spec
                fwd = make_quant_forward_fn(
                    self.net, tuple(blob_names),
                    quant_spec(self.net, weight_dtype))
            self._cache[key] = fwd
        return self._cache[key]


def fetch_rows(out: Dict[str, Any], blob_names: Sequence[str],
               ids: Sequence[str], real: int, bs: int
               ) -> List[Dict[str, Any]]:
    """Forward outputs -> `real` SampleID rows (one device-to-host copy
    per blob, not per row; aggregated scalar outputs like Accuracy
    repeat per row).  `bs` is the executed batch size; rows past `real`
    are padding and are dropped."""
    fetched = {bn: out[bn].detach().to("cpu").numpy()
               for bn in blob_names}
    rows: List[Dict[str, Any]] = []
    for i in range(real):
        row: Dict[str, Any] = {"SampleID": ids[i]}
        for bn, arr in fetched.items():
            if arr.ndim == 0:
                row[bn] = [float(arr)]
            else:
                per = arr.reshape(bs, -1) if arr.shape[0] == bs \
                    else np.repeat(arr.reshape(1, -1), bs, 0)
                row[bn] = [float(x) for x in per[i]]
        rows.append(row)
    return rows
