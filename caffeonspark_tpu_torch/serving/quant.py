"""Publish-time weight compression for serving.

A model's float weights are quantized ONCE when a version is published
(int8 with a per-blob max-abs scale, or bf16 storage), so the resident
InnerProduct weights ARE the int8 operands the int8 kernel (K5,
`ops.kernels.int8_matmul`) consumes: no per-call weight quantization.
Every other compressed blob dequantizes to f32 at forward entry
(storage-only compression; compute stays f32).

What gets compressed is decided by `quant_spec` from the net alone
(layer types and blob shapes, never values), so every version of one
net shares one storage layout.

Knobs: COS_SERVE_WEIGHT_DTYPE (f32 default | bf16 | int8),
COS_SERVE_QUANT_TOL / COS_SERVE_QUANT_CHECK (the publish-time drift
gate, see registry.py).  HBM paging waits for a later slice.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict

import torch

from ..ops.kernels import quantize_int8
from ..ops.layers import get_op
from ..proto import Phase

_LOG = logging.getLogger(__name__)

# storage kinds (per blob, from quant_spec)
F32 = "f32"            # uncompressed
BF16 = "bf16"          # bf16 storage, cast to f32 at forward entry
INT8 = "int8"          # int8 + scale, dequantized at forward entry
INT8_IP = "int8_ip"    # int8 + scale, consumed as-is by the int8 kernel

WEIGHT_DTYPES = ("f32", "bf16", "int8")

# blobs smaller than this stay f32 in every mode: biases and scales are
# a rounding error of the resident set
MIN_QUANT_ELEMS = 1024


def serve_weight_dtype(default: str = "f32") -> str:
    """COS_SERVE_WEIGHT_DTYPE: resident storage for serving weights."""
    v = os.environ.get("COS_SERVE_WEIGHT_DTYPE", default) or default
    v = {"float32": "f32", "bfloat16": "bf16"}.get(v.lower(), v.lower())
    if v not in WEIGHT_DTYPES:
        _LOG.warning("COS_SERVE_WEIGHT_DTYPE=%r not in %s — serving "
                     "f32", v, WEIGHT_DTYPES)
        return "f32"
    return v


def serve_quant_tol(default: float = 0.05) -> float:
    """COS_SERVE_QUANT_TOL: max relative output drift a quantized model
    may show vs its f32 forward before publish falls back to f32."""
    raw = os.environ.get("COS_SERVE_QUANT_TOL")
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        v = float("nan")
    if not math.isfinite(v):
        _LOG.warning("ignoring COS_SERVE_QUANT_TOL=%r", raw)
        return default
    return v


def quant_spec(net, weight_dtype: str) -> Dict[str, Dict[str, str]]:
    """{layer: {blob: kind}} for the blobs that leave f32 under
    `weight_dtype`.  Rules (JAX serving/quant.py:98-125):

      * the blobs of a stat layer (BatchNorm's running statistics,
        `f32_stats`), blobs under MIN_QUANT_ELEMS and 1-D blobs
        (biases) stay f32;
      * int8 mode: a TEST-phase InnerProduct 2-D "weight" is INT8_IP
        (consumed as-is by the int8 kernel); every other eligible blob
        is INT8 (dequantized at forward entry);
      * bf16 mode: eligible blobs store bf16, upcast at entry.
    """
    if weight_dtype == "f32":
        return {}
    serving = net.state.phase != Phase.TRAIN
    out: Dict[str, Dict[str, str]] = {}
    types = {lp.name: lp.type for lp in net.compute_layers}
    for lname, specs in net.param_layout.items():
        t = types.get(lname)
        if t is None or get_op(t).f32_stats:
            continue
        for bname, shape, _ in specs:
            if len(shape) < 2 or math.prod(shape) < MIN_QUANT_ELEMS:
                continue
            if weight_dtype == "bf16":
                kind = BF16
            elif (t == "InnerProduct" and bname == "weight"
                  and serving and len(shape) == 2):
                kind = INT8_IP
            else:
                kind = INT8
            out.setdefault(lname, {})[bname] = kind
    return out


def spec_nbytes(net, spec: Dict[str, Dict[str, str]]) -> int:
    """Resident bytes of one model version under `spec`."""
    total = 0
    for lname, specs in net.param_layout.items():
        for bname, shape, _ in specs:
            kind = spec.get(lname, {}).get(bname, F32)
            itemsize = 1 if kind in (INT8, INT8_IP) else \
                2 if kind == BF16 else 4
            total += math.prod(shape) * itemsize
    return total


def compress_params(params, spec: Dict[str, Dict[str, str]]):
    """Device params -> (params in STORAGE dtype, {layer: {blob: f32
    0-dim scale}} for the int8 blobs).  Blobs outside `spec` pass
    through (shared, not copied)."""
    out: dict = {}
    scales: Dict[str, dict] = {}
    for lname, blobs in params.items():
        sp = spec.get(lname, {})
        pb = {}
        for bname, arr in blobs.items():
            kind = sp.get(bname, F32)
            if kind in (INT8, INT8_IP):
                pb[bname], s = quantize_int8(arr)
                scales.setdefault(lname, {})[bname] = s
            elif kind == BF16:
                pb[bname] = arr.to(torch.bfloat16)
            else:
                pb[bname] = arr
        out[lname] = pb
    return out, scales
