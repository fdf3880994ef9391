"""InferenceService: registry + micro-batcher + record packing.

The single-model counterpart of `caffeonspark_tpu/serving/service.py`.
One service owns a ModelRegistry (the TEST-phase net and its current
weights), the data layer's record packer (a DataSource used only to
pack request payloads through the TEST-phase transformer), and one
MicroBatcher whose hook packs each flush, moves it to the net's device,
runs one forward and cuts per-request rows.  Warm-up and every flush go
through the same pack / forward / fetch_rows code, so a full bucket's
serving rows are byte-equal to a direct forward of the same batch.

`Client` is the in-process front end; `http_server.ServingHTTPServer`
speaks JSON for everything else.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.source import DataSource, ImageRecord, get_source
from ..metrics import PipelineMetrics
from ..ops import kernels
from .batcher import MicroBatcher, PendingResult
from .forward import fetch_rows
from .registry import ModelRegistry

_LOG = logging.getLogger(__name__)


def coerce_record(rec, dims: Tuple[int, int, int]) -> ImageRecord:
    """Accept the native 7-tuple, or an {id, label, data} dict (the HTTP
    front end's JSON shape) -> ImageRecord.  `data` is a nested or flat
    float list/array reshaped to the layer's (C, H, W)."""
    if isinstance(rec, tuple):
        return rec
    if not isinstance(rec, dict):
        raise ValueError(f"unsupported record type {type(rec).__name__}")
    c, h, w = dims
    rid = str(rec.get("id", ""))
    label = float(rec.get("label", 0.0))
    if "image" in rec:
        raise ValueError("encoded images ('image') are not decoded by the "
                         "PyTorch port yet; send raw pixels ('data')")
    if "data" not in rec:
        raise ValueError("record needs 'data' (pixels)")
    arr = np.asarray(rec["data"], np.float32).reshape(c, h, w)
    return (rid, label, c, h, w, False, arr)


class InferenceService:
    """Online serving over a Config (the same -conf the trainer uses):
    builds the TEST-phase net on `conf.device`, loads the snapshot named
    by -weights/-model, and answers coalesced requests."""

    http_wait_s = 120.0       # front-end result wait (HTTP layer tunes)

    def __init__(self, conf, *, blob_names: Optional[Sequence[str]] = None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None):
        self.conf = conf
        self.metrics = PipelineMetrics()
        self.registry = ModelRegistry.from_conf(conf)
        self.device = self.registry.net.device
        model = (getattr(conf, "snapshotModelFile", "")
                 or getattr(conf, "modelPath", ""))
        if model:
            self.registry.load(model)
        layer = conf.test_data_layer() or conf.train_data_layer()
        if layer is None:
            raise ValueError("serving needs a data layer in the net "
                             "prototxt (record geometry + transform)")
        self.source: DataSource = get_source(layer)
        if blob_names is None:
            feats = getattr(conf, "features", "")
            blob_names = ([b.strip() for b in feats.split(",") if b.strip()]
                          if feats else list(self.registry.net.output_blobs))
            label = getattr(conf, "label", "")
            if label and label not in blob_names:
                blob_names.append(label)
        self.blob_names: Tuple[str, ...] = tuple(blob_names)
        self.batcher = MicroBatcher(
            self._run_batch, max_batch=max_batch, max_wait_ms=max_wait_ms,
            metrics=self.metrics)
        self.metrics.set_info("device", str(self.device))
        self.metrics.set_info("weight_dtype", self.registry.weight_dtype)
        self._started = False
        self._warmup_wall_s: Optional[float] = None

    # -- lifecycle ----------------------------------------------------
    def start(self, warmup: bool = True) -> "InferenceService":
        """Run every bucket once before traffic (first-call costs such as
        cuDNN algorithm selection and the kernels' build land here, not
        in a request's latency), then start the batcher."""
        if self._started:
            raise RuntimeError("service already started")
        if warmup:
            t0 = time.monotonic()
            self.warmup()
            self._warmup_wall_s = time.monotonic() - t0
        self.batcher.start()
        self._started = True
        return self

    def warmup(self) -> None:
        c, h, w = self.source.image_dims()
        dummy: ImageRecord = ("_warmup", 0.0, c, h, w, False,
                              np.zeros((c, h, w), np.float32))
        for bucket in self.batcher.buckets:
            t0 = time.monotonic()
            self._run_batch([dummy], bucket)
            self.metrics.add("warmup", time.monotonic() - t0)
        _LOG.info("serving warmup: %d buckets %s", len(self.batcher.buckets),
                  list(self.batcher.buckets))

    def stop(self, drain: bool = True):
        if self._started:
            self.batcher.stop(drain=drain)
            self._started = False

    # -- model hook ---------------------------------------------------
    def _device_scope(self):
        """Flushes run on the batcher's executor thread: make the net's
        card that thread's current device, so the kernels launch on its
        current stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run_batch(self, records: List[ImageRecord], bucket: int
                   ) -> Tuple[List[Dict[str, Any]], int]:
        """One flush (the batcher's model hook, also run by warm-up): pad
        to the bucket (repeat-last), pack through the TEST-phase
        transformer, one forward on the model version snapshotted here,
        per-request rows."""
        mv = self.registry.current()
        ids = [str(r[0]) if r[0] != "" else str(i)
               for i, r in enumerate(records)]
        real = len(records)
        buf = list(records) + [records[-1]] * (bucket - real)
        m = self.metrics
        t0 = time.monotonic()
        host = self.source.next_batch(buf)
        m.add("pack", time.monotonic() - t0)
        t0 = time.monotonic()
        with self._device_scope():
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in host.items()}
            fwd = self.registry.forward(self.blob_names,
                                        weight_dtype=mv.weight_dtype)
            if mv.weight_dtype == "f32":
                out = fwd(mv.params, batch)
            else:
                out = fwd(mv.params, mv.scales or {}, batch)
            rows = fetch_rows(out, self.blob_names, ids, real=real,
                              bs=bucket)
        m.add("fwd", time.monotonic() - t0)
        return rows, mv.version

    # -- request API --------------------------------------------------
    def submit(self, record, timeout_ms: Optional[float] = None
               ) -> PendingResult:
        """Coercion happens HERE, per request: a malformed record is the
        submitter's error (HTTP 400), never a flush failure that poisons
        every co-batched request."""
        if not isinstance(record, tuple):
            record = coerce_record(record, self.source.image_dims())
        self.metrics.incr("requests")
        return self.batcher.submit(record, timeout_ms=timeout_ms)

    def submit_many(self, records: Sequence[Any],
                    timeout_ms: Optional[float] = None
                    ) -> List[PendingResult]:
        """Coerce EVERY record first, then enqueue all-or-nothing."""
        dims = self.source.image_dims()
        coerced = [r if isinstance(r, tuple) else coerce_record(r, dims)
                   for r in records]
        self.metrics.incr("requests", len(coerced))
        return self.batcher.submit_many(coerced, timeout_ms=timeout_ms)

    def reload(self, model_path: str) -> int:
        """Hot-swap to a newer snapshot; in-flight flushes finish on the
        version they started with."""
        return self.registry.load(model_path).version

    # -- reporting ----------------------------------------------------
    def metrics_summary(self) -> dict:
        out = self.metrics.summary()
        out["model_version"] = self.registry.version
        out["buckets"] = list(self.batcher.buckets)
        out["queue_depth_now"] = self.batcher.depth()
        out["kernel_launches"] = dict(kernels.launch_counts)
        if self._warmup_wall_s is not None:
            out["warmup_s"] = round(self._warmup_wall_s, 4)
        return out


class Client:
    """In-process client: submit-and-wait over an InferenceService."""

    def __init__(self, service: InferenceService):
        self.service = service

    def predict(self, records: Sequence[Any],
                timeout_ms: Optional[float] = None,
                wait_s: float = 120.0) -> List[Dict[str, Any]]:
        """Submit every record BEFORE waiting, so the batcher can
        coalesce the whole set into as few flushes as the buckets
        allow."""
        pending = [self.service.submit(r, timeout_ms) for r in records]
        return [p.wait(wait_s) for p in pending]
