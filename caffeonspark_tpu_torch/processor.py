"""CaffeProcessor: the per-process training engine.

The counterpart of `caffeonspark_tpu/processor.py` (and of
`CaffeProcessor.scala`), cut to what one process training on one device
needs: a singleton (`instance()`) that owns the Solver (and, with
`-mesh`, the mesh whose attention route its steps run under), two
bounded feed queues with the STOP_MARK protocol (0 train, 1
validation), and a solver thread (`_run_train`) that packs records from
queue 0 into batches, copies each to the device, takes the solver step,
snapshots at the `snapshot` cadence and after training, and finally
writes the model to `-model`.  Bad records drop their batch (the
reference's per-iteration failure tolerance) until DROP_LIMIT_DEFAULT
consecutive batches fail.
An error on the solver thread surfaces on `join()` / `stop()`.
The training log keeps each step's loss as a device scalar only until
the next `display` or `snapshot` boundary (at most LOSS_FOLD_MAX
steps): there it is folded to host floats with one sync.  An HDF5
solver is refused before the first step.

Interleaved validation, the threaded transformer pool, the device-side
transform, the fused multi-step loop, the chaos injectors and the
observability server wait for later slices.
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from . import checkpoint
from .config import Config
from .data.queue_runner import (DROP_LIMIT_DEFAULT, FeedQueue,
                                combine_batches, to_device)
from .data.source import STOP_MARK, DataSource, get_source
from .metrics import PipelineMetrics
from .ops.layers import flash_mesh
from .parallel.mesh import Mesh, build_mesh, parse_mesh_spec
from .proto.caffe import SnapshotFormat
from .solver import Solver

_LOG = logging.getLogger(__name__)

# the most steps whose losses stay device scalars when neither display
# nor snapshot sets a boundary sooner
LOSS_FOLD_MAX = 1000


class CaffeProcessor:
    _instance: Optional["CaffeProcessor"] = None

    # -- singleton protocol (CaffeProcessor.scala:20-30) -----------------
    @classmethod
    def instance(cls, conf: Optional[Config] = None, rank: int = 0
                 ) -> "CaffeProcessor":
        if conf is not None:
            if cls._instance is not None and cls._instance.conf is conf:
                return cls._instance
            if cls._instance is not None:
                cls._instance.stop()
            cls._instance = cls(conf, rank)
        if cls._instance is None:
            raise RuntimeError("processor not started")
        return cls._instance

    def __init__(self, conf: Config, rank: int = 0):
        if conf.solverParameter.snapshot_format == SnapshotFormat.HDF5:
            # refused here, before any step, not at the first snapshot
            raise NotImplementedError(checkpoint.HDF5_REFUSAL)
        self.conf = conf
        self.rank = rank
        self.solver = Solver(conf.solverParameter, conf.netParam, rank=rank,
                             device=conf.device)
        # -mesh: the mesh's ranks all sit on -device's card, several to a
        # card (the counterpart of the JAX package's virtual devices)
        self.mesh: Optional[Mesh] = None
        if conf.mesh:
            dims = parse_mesh_spec(conf.mesh)
            n = math.prod(dims.values())
            self.mesh = build_mesh(devices=[self.solver.device] * n, **dims)
            n_sp = self.mesh.shape["sp"]
            for name, shape, kind in self.solver.train_net.input_specs:
                if kind.endswith(":T") and shape[0] % n_sp:
                    raise ValueError(
                        f"-mesh {conf.mesh}: the time-major input {name!r} "
                        f"has {shape[0]} steps, which the sp axis ({n_sp} "
                        "ranks) does not divide")
        self.queues = [FeedQueue(), FeedQueue()]   # 0 train, 1 validation
        self.metrics = PipelineMetrics()
        self.params = None
        self.opt_state = None
        self._consecutive_drops = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._metrics_dumped = False
        # per step: (iter after the step, loss, lr, host time when the
        # step was dispatched); the loss is a device scalar in the entries
        # from _folded on, a host float before
        self.train_log: List[tuple] = []
        self._folded = 0
        seed = int(conf.solverParameter.random_seed) \
            if conf.solverParameter.random_seed >= 0 else 0
        tl = conf.train_data_layer()
        self.train_source: Optional[DataSource] = (
            get_source(tl, phase_train=True, rank=rank,
                       num_ranks=max(1, conf.clusterSize), seed=seed,
                       resize=conf.resize)
            if tl is not None and conf.isTraining else None)

    # -- queue API (feedQueue backpressure, :192-198) --------------------
    def feed_queue(self, idx: int, sample) -> bool:
        return self.queues[idx].offer(sample)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self._init_params()
        for q in self.queues:
            q.reset()
        self._stopped = False
        self._metrics_dumped = False
        self._thread = threading.Thread(target=self._run_train,
                                        daemon=True)
        self._thread.start()

    def _init_params(self):
        if self.params is not None:
            return
        params, st = self.solver.init()
        conf = self.conf
        net = self.solver.train_net
        if conf.snapshotStateFile:
            params, st = checkpoint.restore(
                net, params, st, conf.snapshotStateFile,
                weights_path=conf.snapshotModelFile or None)
        elif conf.snapshotModelFile:
            params = checkpoint.copy_layers(net, params,
                                            conf.snapshotModelFile)
        self.params, self.opt_state = params, st

    def stop(self):
        self._stopped = True
        for q in self.queues:
            q.stop()
        if self._thread is not None:
            self._thread.join(timeout=600)
            self._thread = None
        self._dump_metrics()
        if CaffeProcessor._instance is self:
            CaffeProcessor._instance = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._dump_metrics()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _dump_metrics(self):
        """COS_PIPELINE_METRICS=path: the step timeline and the training
        log (info.train) as one JSON document, once per run (a later
        stop() of a joined processor must not overwrite another run's
        file)."""
        path = os.environ.get("COS_PIPELINE_METRICS")
        if path and not self._metrics_dumped and self.metrics.has_samples():
            self.metrics.dump(path)
            self._metrics_dumped = True

    # -- batches ---------------------------------------------------------
    def _train_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        src = self.train_source
        buf: List = []
        while not self._stopped:
            try:
                item = self.queues[0].take(timeout=1.0)
            except queue.Empty:
                continue
            if item is STOP_MARK:
                buf = []       # epoch boundary: drop the ragged tail
                continue
            if item is None:
                return         # terminal sentinel
            buf.append(item)
            if len(buf) == src.batch_size:
                batch = self._pack_or_drop(src, buf)
                if batch is not None:
                    yield batch
                buf = []

    def _pack_or_drop(self, src: DataSource, buf):
        t0 = time.perf_counter()
        try:
            batch = src.pack_batch(buf)
        except Exception as e:            # noqa: BLE001 — a bad record
            self._consecutive_drops += 1
            self.metrics.incr("dropped_batches")
            _LOG.warning("dropping batch after record error: %s", e)
            if self._consecutive_drops >= DROP_LIMIT_DEFAULT:
                raise RuntimeError(
                    f"{self._consecutive_drops} consecutive batch failures "
                    f"— systematic data/config error; last: {e}") from e
            return None
        self._consecutive_drops = 0
        self.metrics.add("pack", time.perf_counter() - t0)
        return batch

    # -- training loop (doTrain, :413-471) -------------------------------
    def _run_train(self):
        try:
            solver = self.solver
            sp = solver.param
            snap = sp.snapshot or 0
            display = sp.display or 0
            params, st = self.params, self.opt_state
            m = self.metrics
            if self.mesh is not None:
                m.set_info("mesh", self.mesh.describe())
            tmajor = frozenset(
                n for n, _, kind in solver.train_net.input_specs
                if kind.endswith(":T"))
            batches = combine_batches(self._train_batches(),
                                      max(1, sp.iter_size), tmajor)
            while st.iter < sp.max_iter:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                m.add("queue_wait", time.perf_counter() - t_wait)
                m.gauge("feed_depth", len(self.queues[0]))
                t_step = time.perf_counter()
                inputs = to_device(batch, solver.device)
                if self.mesh is None:
                    loss, out = solver.train_step(params, st, inputs)
                else:
                    with flash_mesh(self.mesh):
                        loss, out = solver.train_step(params, st, inputs)
                now = time.perf_counter()
                m.add("step", now - t_step)
                m.mark_step()
                self.train_log.append((st.iter, loss, float(out["lr"]),
                                       now))
                shown = display and st.iter % display == 0
                snapped = snap and st.iter % snap == 0
                if shown or snapped or \
                        len(self.train_log) - self._folded >= LOSS_FOLD_MAX:
                    self._fold_losses()
                if shown:
                    _LOG.info("Iteration %d, loss = %.6g, lr = %.6g",
                              st.iter, self.train_log[-1][1],
                              float(out["lr"]))
                if snapped:
                    self._snapshot(params, st)
            if sp.snapshot_after_train:
                self._snapshot(params, st)
            if self.conf.modelPath:
                checkpoint.save_caffemodel(self.conf.modelPath,
                                           solver.train_net, params)
            self.metrics.set_info("train", self._train_info())
        except BaseException as e:     # surfaced on stop()/join()
            self._error = e
        finally:
            for q in self.queues:      # unblock feeders in offer()
                q.stop()

    def _fold_losses(self) -> None:
        """The log's device-scalar losses to host floats (one sync)."""
        log, start = self.train_log, self._folded
        if start == len(log):
            return
        losses = torch.stack([x[1] for x in log[start:]]).cpu().tolist()
        for i, loss in enumerate(losses, start):
            it, _, lr, t = log[i]
            log[i] = (it, loss, lr, t)
        self._folded = len(log)

    def _train_info(self) -> dict:
        """The training log as plain numbers."""
        self._fold_losses()
        log = self.train_log
        return {"iter": [x[0] for x in log], "loss": [x[1] for x in log],
                "lr": [x[2] for x in log], "t": [x[3] for x in log],
                "batch": (self.train_source.batch_size
                          * max(1, self.solver.param.iter_size)
                          if self.train_source is not None else 0),
                "device": str(self.solver.device)}

    def _snapshot(self, params, st):
        conf = self.conf
        prefix = os.path.join(conf.outputPath or ".",
                              conf.solverParameter.snapshot_prefix
                              or "model")
        checkpoint.snapshot(self.solver.train_net, params, st, prefix,
                            fmt=conf.solverParameter.snapshot_format,
                            solver_type=self.solver.solver_type)
