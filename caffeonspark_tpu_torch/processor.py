"""CaffeProcessor: the per-process training and inference engine.

The counterpart of `caffeonspark_tpu/processor.py` (and of
`CaffeProcessor.scala`), cut to one process on one device: a singleton
(`instance()`) that owns the Solver (and, with `-mesh`, the
`ParallelSolver` whose dp, tp and sp ranks share that device, the
layout of the evaluation forward too), two bounded feed queues with the
STOP_MARK protocol (0 train, 1 validation), and a solver thread
(`_run_train`).  The thread takes packed batches from queue 0 through
the ordered transformer pool (COS_TRANSFORM_THREADS workers, default
2; 0 packs inline on the solver thread), stages them on the device
(`device_prefetch`: on a card a stager thread on a side stream, with
the device-side transform's float stage when COS_DEVICE_TRANSFORM=1),
takes the solver step, runs a validation round every test_interval
steps when `interleave_validation` is set (queue 1, its own one-worker
pool; a round that waits VALIDATION_STALL_TIMEOUT seconds for a batch
fails loudly), snapshots at the `snapshot` cadence and after training,
and finally writes the model to `-model`.  Bad records drop their batch
(the reference's per-iteration failure tolerance) until
DROP_LIMIT_DEFAULT consecutive batches of one phase fail; train and
validation keep separate counters.  `extract_features` / `extract_rows`
run the TEST net over a record stream for -test and -features, through
serving/forward.py's forward and row extraction.
An error on the solver thread surfaces on `join()` / `stop()`.
The training log keeps each step's loss as a device scalar only until
the next `display` or `snapshot` boundary (at most LOSS_FOLD_MAX
steps): there it is folded to host floats with one sync.  Snapshots
are binaryproto or HDF5 (`snapshot_format`; without h5py an HDF5
solver is refused by name before the first step); with
-async_snapshot a snapshot is a host copy on the solver thread and its
files are written behind it (`checkpoint.AsyncSnapshotter`): the final
snapshot is waited for, and `stop()` / `join()` wait for the last one.

With COS_METRICS_FLUSH_S > 0 the metrics summary is also flushed to
`<output>/metrics.json` every that many seconds while the processor
runs.  With COS_STEPS_PER_LOOP=K > 1 the solver thread takes K steps a
chunk (`chunked_feed`, `Solver.train_step_many`: one CUDA graph replay
on a card), with single steps up to each validation and snapshot
boundary, so both keep their iterations.  The chaos injectors and the
observability server wait for later slices.
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import checkpoint
from .config import Config
from .data.queue_runner import (DROP_LIMIT_DEFAULT, DROPPED, FeedQueue,
                                TransformerPool, chunked_feed,
                                combine_batches, device_prefetch,
                                stage_background, stage_depth,
                                steps_per_loop, transform_threads,
                                tune_decode_threads)
from .data.source import STOP_MARK, DataSource, get_source
from .metrics import PipelineMetrics, maybe_start_flusher
from .parallel.dp import ParallelSolver
from .parallel.mesh import Mesh, build_mesh, mesh_dims, process_group
from .proto.caffe import SnapshotFormat
from .solver import Solver

_LOG = logging.getLogger(__name__)

# the most steps whose losses stay device scalars when neither display
# nor snapshot sets a boundary sooner
LOSS_FOLD_MAX = 1000


class ValidationReport:
    """Per-output means over the test_iter batches of each round
    (updateValidationReport).  A batch's means stay device scalars until
    its round ends: one sync a round."""

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self.rounds: List[Dict[str, float]] = []
        self._acc: List[torch.Tensor] = []

    def add_batch(self, outputs: Dict[str, torch.Tensor]):
        self._acc.append(torch.stack([
            outputs[n].detach().float().mean() for n in self.names]))

    def finish_round(self):
        if self._acc:
            per = torch.stack(self._acc).double().cpu().numpy()
            self.rounds.append({n: float(v) for n, v
                                in zip(self.names, per.mean(axis=0))})
        self._acc = []


def run_mesh(spec: str, solver: Solver) -> Mesh:
    """The mesh of `-mesh spec` (a bare count N is dp N a process, a
    comma spec the global mesh: `mesh_dims`), this process's ranks all
    on the solver's device (the counterpart of the JAX package's virtual
    devices); an sp axis that does not divide a time-major input's steps
    is refused here."""
    procs, _ = process_group()
    dims = mesh_dims(spec, procs)
    n = math.prod(dims.values())
    if n % procs:
        raise ValueError(f"-mesh {spec}: {n} ranks over {procs} processes "
                         "(the processes must divide the ranks)")
    mesh = build_mesh(devices=[solver.device] * (n // procs), **dims)
    n_sp = mesh.totals["sp"]
    for name, shape, kind in solver.train_net.input_specs:
        if kind.endswith(":T") and shape[0] % n_sp:
            raise ValueError(
                f"-mesh {spec}: the time-major input {name!r} has "
                f"{shape[0]} steps, which the sp axis ({n_sp} ranks) does "
                "not divide")
    return mesh


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
            checkpoint.require_h5py()
        self.conf = conf
        self.rank = rank
        self.solver = Solver(conf.solverParameter, conf.netParam, rank=rank,
                             device=conf.device)
        # -mesh: the mesh's ranks all sit on -device's card, several to a
        # card (the counterpart of the JAX package's virtual devices); a
        # batch that its dp does not divide is refused here, by layer
        self.mesh: Optional[Mesh] = (run_mesh(conf.mesh, self.solver)
                                     if conf.mesh else None)
        self.psolver: Optional[ParallelSolver] = (
            ParallelSolver(self.solver, self.mesh)
            if self.mesh is not None else None)
        if self.mesh_eval and (conf.validates() or conf.isTest
                               or conf.features):
            net = self.solver.test_net or self.solver.train_net
            self.psolver.layout.check_batch(net)
        self.queues = [FeedQueue(), FeedQueue()]   # 0 train, 1 validation
        self.metrics = PipelineMetrics()
        self.params = None
        self.opt_state = None
        self.validation: Optional[ValidationReport] = None
        # set by trainWithValidation: only then does anyone feed queue 1
        self.interleave_validation = False
        self.dropped_batches = 0      # the feeder tops up for these
        self.dropped_val_batches = 0  # a round counts them, no top-up
        self._consecutive_drops = 0
        self._consecutive_val_drops = 0
        # pool workers and the solver thread share the drop accounting
        self._drop_lock = threading.Lock()
        self._train_pool: Optional[TransformerPool] = None
        self._val_pool: Optional[TransformerPool] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stopped = False
        # -async_snapshot's write-behind worker (made at the first
        # snapshot)
        self._snapshotter: Optional[checkpoint.AsyncSnapshotter] = None
        self._metrics_dumped = False
        self._flusher = None          # COS_METRICS_FLUSH_S (start())
        # per step: (iter after the step, loss, lr, host time when the
        # step was dispatched); the loss is a device scalar in the entries
        # from _folded on, a host float before
        self.train_log: List[tuple] = []
        self._folded = 0
        seed = int(conf.solverParameter.random_seed) \
            if conf.solverParameter.random_seed >= 0 else 0
        self._source_kw = dict(rank=rank, num_ranks=max(1, conf.clusterSize),
                               seed=seed, resize=conf.resize)
        tl = conf.train_data_layer()
        self.train_source: Optional[DataSource] = (
            get_source(tl, phase_train=True, **self._source_kw)
            if tl is not None and conf.isTraining else None)
        vl = conf.test_data_layer()
        self.val_source: Optional[DataSource] = (
            get_source(vl, phase_train=False, **self._source_kw)
            if vl is not None else None)
        self._feature_src: Optional[DataSource] = None
        self._blob_forward = None

    @property
    def mesh_eval(self) -> bool:
        """Does evaluation (validation, -test, -features) run on the
        mesh?  Only under an explicit -mesh of more than one rank, as in
        the JAX package (processor.py:660-680)."""
        return self.mesh is not None and self.mesh.size > 1

    # -- queue API (feedQueue backpressure, :192-198) --------------------
    def feed_queue(self, idx: int, sample) -> bool:
        return self.queues[idx].offer(sample)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self._init_params()
        for q in self.queues:
            q.reset()
        self._train_pool = self._val_pool = None
        self._stopped = False
        self._metrics_dumped = False
        # the periodic summary flush to <output>/metrics.json
        # (COS_METRICS_FLUSH_S: a killed run keeps its telemetry)
        if self._flusher is None and self.rank == 0:
            self._flusher = maybe_start_flusher(self.metrics,
                                                self.conf.outputPath)
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
        if self.psolver is not None:
            # a snapshot resumes onto the mesh by splitting again
            params = self.psolver.shard_params(params)
            st = self.psolver.shard_opt_state(st)
        self.params, self.opt_state = params, st

    def stop(self):
        self._stopped = True
        for q in self.queues:
            q.stop()
        if self._thread is not None:
            self._thread.join(timeout=600)
            self._thread = None
        snap_err = self._finish_snapshots()
        self._dump_metrics()
        if CaffeProcessor._instance is self:
            CaffeProcessor._instance = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if snap_err is not None:
            raise snap_err

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        snap_err = self._finish_snapshots()
        self._dump_metrics()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if snap_err is not None:
            raise snap_err

    def _finish_snapshots(self) -> Optional[BaseException]:
        """Wait for the write-behind snapshot in flight and stop its
        worker; returns its error, which must not mask the training
        thread's."""
        snap, self._snapshotter = self._snapshotter, None
        if snap is None:
            return None
        try:
            snap.wait(timeout=600)
        except (RuntimeError, TimeoutError) as e:
            return e
        finally:
            snap.close()
        return None

    def _dump_metrics(self):
        """COS_PIPELINE_METRICS=path: the step timeline and the training
        log (info.train) as one JSON document, once per run (a later
        stop() of a joined processor must not overwrite another run's
        file).  The flusher, when one runs, lands its final flush here."""
        if self._flusher is not None:
            self._flusher.stop()
            self._flusher = None
        path = os.environ.get("COS_PIPELINE_METRICS")
        if path and not self._metrics_dumped and self.metrics.has_samples():
            self.metrics.dump(path)
            self._metrics_dumped = True

    # -- batches ---------------------------------------------------------
    def _train_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """The inline path (COS_TRANSFORM_THREADS=0): pack on the solver
        thread."""
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

    def _note_pack_ok(self, *, val: bool = False):
        with self._drop_lock:
            if val:
                self._consecutive_val_drops = 0
            else:
                self._consecutive_drops = 0

    def _note_pack_drop(self, e: Exception, *, val: bool = False):
        """A batch dropped after a record error.  Train and validation
        keep separate consecutive counters (a healthy feed of one must
        not reset the other's streak) and separate totals (only train
        drops make the feeder top up, since a dropped validation batch
        still counts in its round); DROP_LIMIT_DEFAULT consecutive drops
        of one phase raise."""
        with self._drop_lock:
            if val:
                self._consecutive_val_drops += 1
                consecutive = self._consecutive_val_drops
                self.dropped_val_batches += 1
            else:
                self._consecutive_drops += 1
                consecutive = self._consecutive_drops
                self.dropped_batches += 1
        self.metrics.incr("dropped_val_batches" if val
                          else "dropped_batches")
        _LOG.warning("dropping batch after record error: %s", e)
        if consecutive >= DROP_LIMIT_DEFAULT:
            raise RuntimeError(
                f"{consecutive} consecutive batch failures — systematic "
                f"data/config error; last: {e}") from e

    def _pack_or_drop(self, src: DataSource, buf, *, val: bool = False):
        """Inline pack with the drop policy."""
        t0 = time.perf_counter()
        try:
            batch = src.next_batch(buf)
        except Exception as e:            # noqa: BLE001 — a bad record
            self._note_pack_drop(e, val=val)   # raises at the limit
            return None
        self.metrics.add("pack", time.perf_counter() - t0)
        self._note_pack_ok(val=val)
        return batch

    def _pool(self, idx: int, src: DataSource, threads: int,
              val: bool) -> TransformerPool:
        return TransformerPool(
            self.queues[idx], src.batch_size, pack=src.pack_batch,
            draw_fn=src.make_draw_fn(), num_threads=threads,
            on_pack_ok=lambda: self._note_pack_ok(val=val),
            on_pack_error=lambda e: self._note_pack_drop(e, val=val),
            metrics=self.metrics,
            should_stop=lambda: self._stopped).start()

    # -- training loop (doTrain, :413-471) -------------------------------
    def _run_train(self):
        gen = None
        try:
            solver = self.solver
            stepper = self.psolver or solver
            sp = solver.param
            snap = sp.snapshot or 0
            display = sp.display or 0
            test_interval = sp.test_interval
            test_iter = sp.test_iter[0] if sp.test_iter else 0
            params, st = self.params, self.opt_state
            m = self.metrics
            if self.psolver is not None:
                m.set_info("mesh", self.psolver.layout.describe())
            # the gradient exchange's plan (COS_GRAD_SYNC): wire bytes,
            # buckets and wire dtype a step (JAX processor.py:336-342)
            m.set_info("comm", solver.grad_sync.plan.comm_info())
            validate = bool(self.interleave_validation and test_interval
                            and test_iter and solver.test_net is not None
                            and self.val_source is not None)
            eval_fwd = None
            if validate:
                eval_fwd = (self.psolver.eval_step() if self.mesh_eval
                            else solver.eval_step_fn())
            if validate:
                self.validation = ValidationReport(
                    solver.test_net.output_blobs)
                self.val_source.enable_device_transform(
                    solver.test_net.dtype)
            src = self.train_source
            dxf = src.enable_device_transform(solver.train_net.dtype)
            nthreads = transform_threads()
            if nthreads > 0:
                tune_decode_threads(src, nthreads)
                self._train_pool = self._pool(0, src, nthreads, val=False)
                batches = iter(self._train_pool)
                if validate:
                    # one worker: a round packs ahead between rounds,
                    # off the step's path
                    self._val_pool = self._pool(1, self.val_source, 1,
                                                val=True)
            else:
                batches = self._train_batches()
            tmajor = frozenset(
                n for n, _, kind in solver.train_net.input_specs
                if kind.endswith(":T"))
            # COS_STEPS_PER_LOOP=K > 1: chunks of K steps, one CUDA graph
            # replay each on a card (Solver.train_step_many), cut into
            # single steps before each boundary this loop acts on: the
            # validation interval and the snapshot cadence (JAX
            # processor.py:426-447).  Display lines need no boundary:
            # each step's loss is in the chunk's output
            k_loop = steps_per_loop()
            many = stepper.train_step_many(k_loop) if k_loop > 1 else None
            feed = chunked_feed(
                combine_batches(batches, max(1, sp.iter_size), tmajor),
                start_iter=st.iter, max_iter=sp.max_iter, k=k_loop,
                boundaries=(test_interval if validate else 0, snap),
                metrics=m)
            gen = device_prefetch(
                feed, solver.device, depth=stage_depth(),
                device_transforms=dxf, chunked=True,
                background=nthreads > 0 and stage_background(solver.device),
                metrics=m)
            while st.iter < sp.max_iter:
                t_wait = time.perf_counter()
                item = next(gen, None)
                if item is None:
                    break
                n, inputs = item
                m.add("queue_wait", time.perf_counter() - t_wait)
                m.gauge("feed_depth", len(self.queues[0]))
                t_step = time.perf_counter()
                if n == 1:
                    loss, out = stepper.train_step(params, st, inputs)
                    losses, lrs = [loss], [float(out["lr"])]
                else:
                    loss_k, out = many(params, st, inputs)
                    losses, lrs = list(loss_k.unbind()), out["lr"].tolist()
                now = time.perf_counter()
                if n == 1:
                    m.add("step", now - t_step)
                    m.mark_step()
                else:
                    m.add_chunk(n, now - t_step)
                first = st.iter - n + 1
                for i in range(n):
                    self.train_log.append((first + i, losses[i], lrs[i],
                                           now))
                shown = [it for it in range(first, st.iter + 1)
                         if display and it % display == 0]
                snapped = snap and st.iter % snap == 0
                if shown or snapped or \
                        len(self.train_log) - self._folded >= LOSS_FOLD_MAX:
                    self._fold_losses()
                for it in shown:
                    _, loss_f, lr_f, _ = self.train_log[it - st.iter - 1]
                    _LOG.info("Iteration %d, loss = %.6g, lr = %.6g", it,
                              loss_f, lr_f)
                if validate and st.iter % test_interval == 0:
                    self._run_validation(eval_fwd, params, test_iter)
                if snapped and self.rank == 0:
                    self._snapshot(params, st)
            # -clusterSize N: rank 0 alone writes the files (JAX
            # processor.py:486-503, 624)
            if sp.snapshot_after_train and self.rank == 0:
                self._snapshot(params, st, final=True)
            if self.conf.modelPath and self.rank == 0:
                checkpoint.save_caffemodel(self.conf.modelPath,
                                           solver.train_net, params)
            self.metrics.set_info("train", self._train_info())
        except BaseException as e:     # surfaced on stop()/join()
            self._error = e
        finally:
            # in dependency order: the stager first, then the pools,
            # then the feeders blocked in offer()
            if gen is not None:
                gen.close()
            for pool in (self._train_pool, self._val_pool):
                if pool is not None:
                    pool.stop(join_timeout=2.0)
            for q in self.queues:
                q.stop()

    # -- validation rounds (updateValidationReport, :388-411) -----------
    VALIDATION_STALL_TIMEOUT = 30.0

    def _stalled(self, done: int, test_iter: int) -> RuntimeError:
        # a stalled feeder must not silently shrink the round
        return RuntimeError(
            f"validation feed stalled: {done}/{test_iter} batches after "
            f"{self.VALIDATION_STALL_TIMEOUT:.0f}s — feeder dead or test "
            "source exhausted (check test_iter x batch_size vs dataset "
            "size)")

    def _take_val_inline(self, timeout: float):
        """One validation batch packed on the solver thread (no pool):
        DROPPED when its pack failed, None once the processor stops."""
        src = self.val_source
        buf: List = []
        while len(buf) < src.batch_size:
            item = self.queues[1].take(timeout=timeout)  # may raise Empty
            if item is STOP_MARK or item is None:
                if self._stopped:
                    return None
                continue
            buf.append(item)
        batch = self._pack_or_drop(src, buf, val=True)
        return DROPPED if batch is None else batch

    def _run_validation(self, eval_fwd, params, test_iter: int):
        """One round of test_iter batches, from queue 1's pool or packed
        inline, in feed order; a DROPPED batch still counts (its records
        are spent)."""
        src = self.val_source
        done = 0
        while done < test_iter and not self._stopped:
            try:
                if self._val_pool is not None:
                    batch = self._val_pool.take(
                        timeout=self.VALIDATION_STALL_TIMEOUT,
                        skip_dropped=False)
                else:
                    batch = self._take_val_inline(
                        self.VALIDATION_STALL_TIMEOUT)
            except queue.Empty:
                if self._stopped or self.queues[1].stopped:
                    break          # an ordinary shutdown mid-round
                raise self._stalled(done, test_iter)
            if batch is None:
                break              # the pool's end (stop / exhausted)
            if batch is not DROPPED:
                self.validation.add_batch(eval_fwd(
                    params, src.apply_device_stage(batch,
                                                   self.solver.device)))
            done += 1
        self.validation.finish_round()

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

    def _snapshot(self, params, st, final: bool = False):
        conf = self.conf
        prefix = os.path.join(conf.outputPath or ".",
                              conf.solverParameter.snapshot_prefix
                              or "model")
        kw = dict(fmt=conf.solverParameter.snapshot_format,
                  solver_type=self.solver.solver_type)
        if not conf.asyncSnapshot:
            checkpoint.snapshot(self.solver.train_net, params, st, prefix,
                                **kw)
            return
        # JAX processor.py:600-617: hand the write to the worker; the
        # final snapshot is waited for
        if self._snapshotter is None:
            self._snapshotter = checkpoint.AsyncSnapshotter()
        self._snapshotter.submit(self.solver.train_net, params, st, prefix,
                                 **kw)
        if final:
            self._snapshotter.wait()

    # -- feature extraction (doFeatures, :473-523) ------------------------
    def extract_features(self, source: DataSource,
                         blob_names: Sequence[str]
                         ) -> List[Dict[str, Any]]:
        return self.extract_rows(source.records(), blob_names,
                                 source=source)

    def default_feature_blobs(self) -> List[str]:
        net = self.solver.test_net or self.solver.train_net
        names = list(net.output_blobs)
        if self.conf.label and self.conf.label not in names:
            names.append(self.conf.label)   # the -label column
        return names

    def feature_source(self) -> Optional[DataSource]:
        """The record packer of feature extraction, always TEST-phase
        (center crop, no mirror): the validation source when the net has
        a TEST data layer, else one built at TEST from the data layer
        there is; never the train source, whose random crop and mirror
        would make the rows vary."""
        src = self.val_source or self._feature_src
        if src is None:
            lp = self.conf.test_data_layer() or self.conf.train_data_layer()
            if lp is not None:
                src = self._feature_src = get_source(
                    lp, phase_train=False, **self._source_kw)
        return src

    def _feature_fwd(self, blob_names: Tuple[str, ...]):
        """predict(blobNames) of the TEST net, cached per blob set: the
        serving path's forward (serving/forward.py), under
        inference_mode on the solver's device; with an explicit -mesh of
        more than one rank, under the training step's layout."""
        from .serving.forward import BlobForward
        net = self.solver.test_net or self.solver.train_net
        layout = self.psolver.layout if self.mesh_eval else None
        fwd = self._blob_forward
        if fwd is None or fwd.net is not net or fwd.layout is not layout:
            fwd = self._blob_forward = BlobForward(net, layout=layout)
        return fwd(blob_names)

    def extract_rows(self, records, blob_names: Sequence[str],
                     source: Optional[DataSource] = None
                     ) -> List[Dict[str, Any]]:
        """features() / test() over a record stream: one SampleID row a
        record.  A ragged tail is padded to a whole batch with its last
        record and the padding's rows are dropped."""
        from .serving.forward import fetch_rows
        self._init_params()
        source = source or self.feature_source()
        if source is None:
            raise ValueError("no data layer to pack records with")
        fwd = self._feature_fwd(tuple(blob_names))
        device = self.solver.device
        rows: List[Dict[str, Any]] = []
        buf: List = []
        ids: List[str] = []

        def flush(real: int):
            nonlocal buf, ids
            out = fwd(self.params, source.apply_device_stage(
                source.next_batch(buf), device))
            rows.extend(fetch_rows(out, blob_names, ids, real, len(buf)))
            buf, ids = [], []

        for rec in records:
            buf.append(rec)
            ids.append(str(rec[0]) if isinstance(rec, tuple)
                       else str(rec.get("id", len(ids))))
            if len(buf) == source.batch_size:
                flush(real=len(buf))
        if buf:
            real = len(buf)
            pad = source.batch_size - real
            buf += [buf[-1]] * pad
            ids += [ids[-1]] * pad
            flush(real=real)
        return rows
