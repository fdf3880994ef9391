"""Model registry: one served net, versioned, optionally quantized.

The default-model surface of `caffeonspark_tpu/serving/registry.py`:
`load` / `publish` install a new immutable `ModelVersion`, and the
batcher snapshots `current()` ONCE per flush, so every request of a
flush is answered by exactly one version, old or new, never mixed.

Quantized residency (COS_SERVE_WEIGHT_DTYPE=bf16|int8, serving/quant.py):
weights compress once at publish.  Each publish is gated by the
measured output drift against the model's own f32 forward
(COS_SERVE_QUANT_TOL, default 0.05; COS_SERVE_QUANT_CHECK=0 skips the
gate); a model that drifts past it is stored f32, with a log line.
`export_quant_sidecar` writes the compressed version beside its model as
`<model>.quant`; a later `load` of that model under the same weight
dtype takes the sidecar directly, skipping the f32 load, the
quantization and the drift gate (they ran when it was written).  A
sidecar of another weight dtype is ignored with a warning.  Named
models, HBM paging and mesh layouts wait for later slices.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import checkpoint
from ..net import Net, Params
from ..proto import NetParameter, NetState, Phase, SolverParameter
from . import quant
from .forward import BlobForward

_LOG = logging.getLogger(__name__)


def build_serving_net(net_param: NetParameter,
                      solver_param: Optional[SolverParameter] = None,
                      device="cuda") -> Net:
    """TEST-phase net for inference: honors the solver's test_state
    stage/level rules when given, falls back to the TRAIN-phase graph
    when the prototxt has no TEST-phase compute layers."""
    test_state = NetState(phase=Phase.TEST)
    if solver_param is not None and solver_param.test_state:
        test_state = solver_param.test_state[0].clone()
        test_state.phase = Phase.TEST
    try:
        net = Net(net_param, test_state, device=device)
        if net.compute_layers:
            return net
    except (ValueError, NotImplementedError) as e:
        _LOG.debug("TEST-phase net construction failed (%s); "
                   "serving the TRAIN-phase graph", e)
    return Net(net_param, NetState(phase=Phase.TRAIN), device=device)


class ModelVersion(NamedTuple):
    """One immutable servable model.  `params` are in STORAGE dtype
    (f32, or bf16/int8 under quantized residency; `scales` then holds
    the int8 blobs' f32 dequant scales)."""
    version: int
    path: str
    params: Params
    scales: Optional[Dict] = None
    weight_dtype: str = "f32"
    nbytes: int = 0


class ModelRegistry:
    """Versioned model store + the net's forward closures."""

    def __init__(self, net: Net):
        self._lock = threading.Lock()
        self.net = net
        self.forward = BlobForward(net)
        self._current: Optional[ModelVersion] = None
        self._version = 0
        self.quant_fallback: Optional[str] = None
        # knobs resolved once here, never per flush
        self.weight_dtype = quant.serve_weight_dtype()
        self.quant_tol = quant.serve_quant_tol()
        self._quant_check = os.environ.get(
            "COS_SERVE_QUANT_CHECK", "1") != "0"

    @classmethod
    def from_conf(cls, conf) -> "ModelRegistry":
        if conf.netParam is None:
            raise ValueError("serving needs -conf (solver prototxt "
                             "resolving a net)")
        return cls(build_serving_net(conf.netParam, conf.solverParameter,
                                     device=conf.device))

    # -- publish / load -------------------------------------------------
    def load(self, model_path: str) -> ModelVersion:
        """Load a snapshot (.caffemodel[.h5], or a .solverstate whose
        learned_net resolves) and publish it as the current version;
        under a compressed weight dtype a `<model_path>.quant` sidecar
        is taken instead when there is one (JAX registry.py:419-440).
        In-flight flushes keep serving the version they snapshotted."""
        if self.weight_dtype != "f32":
            sidecar = model_path + checkpoint.QUANT_SIDECAR_SUFFIX
            if os.path.exists(sidecar):
                return self._publish_sidecar(sidecar, model_path)
        params = checkpoint.load_serving_params(self.net, model_path)
        return self.publish(params, model_path)

    def _publish_sidecar(self, sidecar: str, path: str) -> ModelVersion:
        """Install a quant sidecar's blobs as they are stored."""
        blobs, host_scales, wd = checkpoint.load_quant_sidecar(sidecar)
        if wd != self.weight_dtype:
            _LOG.warning("%s: sidecar weight_dtype %s != requested %s "
                         "— ignoring sidecar", sidecar, wd,
                         self.weight_dtype)
            return self.publish(
                checkpoint.load_serving_params(self.net, path), path)
        spec = quant.quant_spec(self.net, wd)
        want = {quant.INT8: torch.int8, quant.INT8_IP: torch.int8,
                quant.BF16: torch.bfloat16}
        params: Params = {}
        scales: Dict[str, Dict[str, torch.Tensor]] = {}
        dev = self.net.device
        for lname, specs in self.net.param_layout.items():
            params[lname] = {}
            for bname, shape, _ in specs:
                t = blobs.get(lname, {}).get(bname)
                kind = spec.get(lname, {}).get(bname, quant.F32)
                dt = want.get(kind, torch.float32)
                if t is None or tuple(t.shape) != tuple(shape) \
                        or t.dtype != dt:
                    raise ValueError(
                        f"{sidecar}: {lname}/{bname} is "
                        f"{None if t is None else (tuple(t.shape), t.dtype)}"
                        f", the net wants {(tuple(shape), dt)}")
                params[lname][bname] = t.to(dev)
                if kind in (quant.INT8, quant.INT8_IP):
                    scales.setdefault(lname, {})[bname] = torch.tensor(
                        host_scales[lname][bname], dtype=torch.float32,
                        device=dev)
        self.quant_fallback = None
        return self._install(params, path, scales or None, wd,
                             quant.spec_nbytes(self.net, spec))

    def export_quant_sidecar(self, model_path: str) -> str:
        """Write `<model_path>.quant`: the current version's compressed
        blobs and scales (`checkpoint.save_quant_sidecar`), so that the
        next `load` of `model_path` under the same weight dtype skips
        the f32 load, the quantization and the drift gate.  A version
        resident in f32 has nothing to export and is refused (JAX
        registry.py:970-1002)."""
        mv = self.current()
        if mv.weight_dtype == "f32":
            raise ValueError(
                "the current model is resident in f32 — nothing to "
                "export (set COS_SERVE_WEIGHT_DTYPE and republish)")
        scales = {ln: {bn: float(t) for bn, t in bl.items()}
                  for ln, bl in (mv.scales or {}).items()}
        return checkpoint.save_quant_sidecar(
            model_path + checkpoint.QUANT_SIDECAR_SUFFIX, mv.params,
            scales, mv.weight_dtype)

    def publish(self, params: Params, path: str = "<in-memory>"
                ) -> ModelVersion:
        """Install already-materialized f32 params: quantize (drift
        gated) under a compressed weight dtype, then swap in."""
        wd = self.weight_dtype
        scales: Optional[Dict] = None
        spec = quant.quant_spec(self.net, wd)
        if spec:
            qparams, scales = quant.compress_params(params, spec)
            drift = (self._drift(params, qparams, scales, wd)
                     if self._quant_check else None)
            if drift is not None and drift > self.quant_tol:
                _LOG.warning(
                    "%s residency drifts %.4f > tol %.4f vs f32 — "
                    "falling back to f32 storage", wd, drift,
                    self.quant_tol)
                self.quant_fallback = (
                    f"drift {drift:.4f} > tol {self.quant_tol}")
                spec, scales = {}, None
            else:
                self.quant_fallback = None
                params = qparams
                if drift is not None:
                    _LOG.info("%s residency drift %.4f (tol %.4f)", wd,
                              drift, self.quant_tol)
        if not spec:
            wd = "f32"
        return self._install(params, path, scales, wd,
                             quant.spec_nbytes(self.net, spec))

    def _install(self, params: Params, path: str, scales: Optional[Dict],
                 wd: str, nbytes: int) -> ModelVersion:
        with self._lock:
            self._version += 1
            mv = ModelVersion(self._version, path, params, scales, wd,
                              nbytes)
            self._current = mv
        _LOG.info("model registry: version %d <- %s (%s, %.1f MB)",
                  mv.version, path, wd, nbytes / 2**20)
        return mv

    def _drift(self, params_f32: Params, qparams: Params, scales,
               wd: str) -> float:
        """Publish-time accuracy gate: max relative drift of the
        quantized forward vs the f32 forward on seeded random inputs,
        over the net's float output blobs."""
        net = self.net
        outs = tuple(bn for bn in net.output_blobs
                     if bn in net.blob_shapes)
        if not outs:
            return 0.0
        rng = np.random.RandomState(0)
        inputs = {}
        for name, shape, kind in net.input_specs:
            host = (np.zeros(shape, np.float32) if kind == "label"
                    else rng.rand(*shape).astype(np.float32))
            inputs[name] = torch.from_numpy(host).to(net.device)
        ref = self.forward(outs)(params_f32, inputs)
        got = self.forward(outs, weight_dtype=wd)(qparams, scales or {},
                                                  inputs)
        worst = 0.0
        for bn in outs:
            r = ref[bn].float()
            denom = float(r.abs().max()) + 1e-9
            worst = max(worst,
                        float((got[bn].float() - r).abs().max()) / denom)
        return worst

    # -- read side ------------------------------------------------------
    def current(self) -> ModelVersion:
        """The current version; raises RuntimeError when nothing was
        ever published."""
        with self._lock:
            mv = self._current
        if mv is None:
            raise RuntimeError("model registry is empty — load a "
                               "snapshot (-model/-weights) before serving")
        return mv

    @property
    def version(self) -> int:
        with self._lock:
            return self._version
