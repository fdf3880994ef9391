"""Standalone trainer, no Spark: the counterpart of the JAX package's
`mini_cluster.py` (the reference's `caffe_mini_cluster` bring-up
harness), in one process or several, each on one device:

    python -m caffeonspark_tpu_torch.mini_cluster \\
        -solver lenet_memory_solver.prototxt \\
        [-train /path/override_source] [-test /path] [-net net.prototxt] \\
        [-weights model.caffemodel] [-snapshot state.solverstate] \\
        [-iterations N] [-display_every N] [-model out.caffemodel] \\
        [-output DIR] [-metrics steps.jsonl] [-pipeline_metrics m.json] \\
        [-profile DIR] [-dtype float32|bfloat16|mixed] \\
        [-mesh dp[,tp[,sp]] | -devices k] [-device cuda|cpu] \\
        [-server host:port -cluster N -rank I]

It parses every flag of the JAX command line.  `-dtype bfloat16` keeps
params and compute in bf16, `mixed` f32 master weights with bf16
compute (`Net.compute_dtype`); COS_STATE_DTYPE stores the momentum in
another dtype (solver.py).  `-mesh dp[,tp[,sp]]` (a bare count N is dp
N, as in the JAX package) trains with `parallel.dp.ParallelSolver`, its
ranks all on the one device: the batch split over dp, large matmuls
over tp, every MultiHeadAttention's time over sp (the ring), ZeRO-1
under COS_ZERO=1; validation runs on the same layout.  `-devices k` (a
bare count) is `-mesh k`: k dp ranks sharing the device (the JAX
package's GPUs per node).  Refused by name: a mesh with ep or pp above
1, and the knobs of `config.LATER_KNOBS` that change a run's result.

`-server host:port -cluster N -rank I` trains on N processes in lockstep
(`parallel.mesh.distributed_init`, gloo; start one command per rank,
rank 0 listening at host:port), as the JAX package reads its flags: a
`-mesh dp,tp,sp` with a comma names the global mesh, of which each
process holds dp*tp*sp / N ranks on its device in the JAX package's
dp-fastest order (`parallel.mesh.process_box`: `-mesh 1,2` puts tp rank
I in process I, `-mesh 1,1,2` sp rank I, `-mesh 2,2` over 2 processes
two dp ranks and tp rank I in each); a bare count k (or `-devices k`)
is k local dp ranks a process, dp N x k.  The prototxt batch is the
global batch: processes at the same dp coordinates feed the same block
of each of the one record stream's batches (`DataSource.take_block`;
`dp_data_rank`), so a tp- or sp-only mesh feeds every process identical
records; every process seeds Dropout's generator alike and takes its
dp ranks' slices of the one global draw, so tp and sp peers draw alike
and N processes train, bit for bit up to the order of the sums, what
one process with the same global mesh trains.  (The JAX package feeds
each dp block its key range at the prototxt batch and seeds each by its
dp coordinate; the port keeps the one-process run's batches instead.)
A process holds only its tp ranks' column blocks of a blob split over
tp, and of its optimizer state.  Every process starts from the same
parameters, checked once by checksums over the processes.  Rank 0 alone
writes the snapshots' model (gathered over the tp lines by every
process at the snapshot's step), the state, the final model,
`-metrics`, `-pipeline_metrics`, `validation.json` and the timing
summary; every rank prints its `iter i/N` lines.  A state split over
processes (ZeRO-1 over a dp axis across them, or tp blocks) is written
by each rank to `<state>.shard<rank>` at each snapshot, which a
one-process resume reassembles.
COS_STEPS_PER_LOOP=K > 1 takes K steps a chunk (one CUDA graph replay on
a card, `Solver.train_step_many`), with single steps before each
display, validation, snapshot and max_iter boundary.

Snapshots follow the solver's `snapshot_format` (HDF5 writes
`.caffemodel.h5` / `.solverstate.h5`, and `-snapshot` resumes from
either kind); `-model x.caffemodel.h5` writes the final model as HDF5.

Signals (`caffe_mini_cluster.cpp:55-60`): SIGINT and SIGTERM stop after
the current step with a snapshot and print the resume line; SIGHUP
snapshots and goes on.  The previous handlers come back when `train`
returns.  Over several processes, signal every one: a signal-driven
snapshot of a state split over processes warns that its sidecar set is
whole only if every rank snapshots in the same iteration, and one of
params split over a tp axis across processes is skipped with a warning
(gathering them is a collective, and the signal may have reached one
rank only), as in the JAX package.

One departure from the JAX package, on purpose: under `-dtype bfloat16`
the batch's cast to bf16 skips the net inputs read as indices (token ids
and labels, `Net.index_inputs`), which bf16 would round above 256.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time
from typing import Optional

import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mini_cluster",
        description="standalone (non-Spark) trainer of the PyTorch port")
    p.add_argument("-solver", "-conf", dest="solver", required=True,
                   help="solver prototxt")
    p.add_argument("-net", dest="net", default=None,
                   help="net prototxt (overrides solver's `net:` path)")
    p.add_argument("-train", dest="train", default=None,
                   help="override train data source path")
    p.add_argument("-test", dest="test", default=None,
                   help="override test data source path")
    p.add_argument("-weights", dest="weights", default=None,
                   help=".caffemodel to finetune from")
    p.add_argument("-snapshot", dest="snapshot", default=None,
                   help=".solverstate to resume from")
    p.add_argument("-iterations", dest="iterations", type=int,
                   default=None, help="override max_iter")
    p.add_argument("-devices", dest="devices", default=None,
                   help="local dp ranks k sharing -device (the reference's "
                   "GPUs per node) or mesh spec dp[,tp[,sp[,ep]]]")
    p.add_argument("-mesh", dest="mesh", default=None,
                   help="mesh spec dp[,tp[,sp[,ep]]], a bare N being dp N "
                   "(wins over -devices); its ranks share -device")
    p.add_argument("-model", dest="model", default=None,
                   help="final model output path")
    p.add_argument("-output", dest="output", default=".",
                   help="snapshot output dir")
    p.add_argument("-server", dest="server", default=None,
                   help="rendezvous host:port that rank 0 listens on")
    p.add_argument("-cluster", dest="cluster", type=int, default=None,
                   help="number of processes")
    p.add_argument("-rank", dest="rank", type=int, default=None,
                   help="this process's rank")
    p.add_argument("-display_every", type=int, default=None,
                   help="override solver display interval")
    p.add_argument("-profile", dest="profile", default=None,
                   help="write a torch.profiler Chrome trace into this "
                   "directory")
    p.add_argument("-metrics", dest="metrics", default=None,
                   help="append per-display-step JSONL records "
                   "(iter, loss, lr, steps/s, records/s) to this file")
    p.add_argument("-pipeline_metrics", dest="pipeline_metrics",
                   default=None,
                   help="write the per-stage ingest timeline as JSON to "
                   "this file at exit")
    p.add_argument("-dtype", dest="dtype", default="float32",
                   choices=["float32", "bfloat16", "mixed"],
                   help="float32 | bfloat16 (params+compute bf16) | "
                   "mixed (f32 master weights, bf16 compute)")
    p.add_argument("-device", dest="device", default="cuda",
                   help="where the net runs: cuda (default) or cpu")
    return p


def mesh_spec(args) -> Optional[str]:
    """The mesh spec (`-mesh`, else `-devices`; a bare k is k dp ranks a
    process, a comma spec the global mesh: `parallel.mesh.mesh_dims`),
    or None for one rank; over several processes always a spec, since
    the mesh spans them."""
    spec = args.mesh or args.devices
    if spec is not None:
        spec = str(spec)
        if "," in spec or "=" in spec or int(spec) > 1:
            return spec
    return "1" if int(args.cluster or 1) > 1 else None


class MiniCluster:
    def __init__(self, args):
        from . import checkpoint
        from .config import check_env_knobs, resolve_net_path
        from .parallel.dp import ParallelSolver
        from .parallel.mesh import distributed_init, mesh_dims, process_box
        from .processor import run_mesh
        from .proto import read_net, read_solver
        from .proto.caffe import SnapshotFormat
        from .solver import Solver

        check_env_knobs()
        spec = mesh_spec(args)
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"-device {args.device}: no CUDA device is "
                               "visible (pass -device cpu to train on the "
                               "CPU)")
        if spec:
            # before the rendezvous: no peer waits on a refusal
            n = int(args.cluster or 1)
            process_box(mesh_dims(spec, n), n, int(args.rank or 0) % n)
        self.procs, self.rank = distributed_init(args.server, args.cluster,
                                                 args.rank)
        self.sp = read_solver(args.solver)
        if (self.sp.snapshot_format == SnapshotFormat.HDF5
                or (args.model or "").endswith(".h5")):
            checkpoint.require_h5py()   # refused by name, before step 1
        self.net_param = read_net(
            resolve_net_path(args.solver, args.net or self.sp.net))
        if args.train or args.test:
            for lyr in self.net_param.layer:
                if lyr.type not in ("MemoryData", "CoSData"):
                    continue
                is_test = any(r.phase == 1 for r in lyr.include)
                override = args.test if is_test else args.train
                if override:
                    if lyr.has("memory_data_param"):
                        lyr.memory_data_param.source = override
                    else:
                        lyr.cos_data_param.source = override
        if args.iterations is not None:
            self.sp.max_iter = args.iterations
        if args.display_every is not None:
            self.sp.display = args.display_every

        dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                 else torch.float32)
        compute = torch.bfloat16 if args.dtype == "mixed" else None
        # rank 0's seed on every process: each draws the global batch's
        # Dropout numbers and its ranks take their slices
        self.solver = Solver(self.sp, self.net_param, rank=0, dtype=dtype,
                             compute_dtype=compute, device=device)
        self.mesh = run_mesh(spec, self.solver) if spec else None
        # the step's ranks (and the validation forward's layout)
        self.psolver = (ParallelSolver(self.solver, self.mesh)
                        if self.mesh is not None else None)
        if self.psolver is not None and self.mesh.size > 1 \
                and self._interleaves():
            self.psolver.layout.check_batch(self.solver.test_net)
        self.is_rank0 = self.rank == 0
        self.args = args
        self.prefix = os.path.join(args.output,
                                   self.sp.snapshot_prefix or "model")
        self._stop = False
        self._want_snapshot = False

    # ------------------------------------------------------------------
    def _interleaves(self) -> bool:
        sp, test_net = self.sp, self.solver.test_net
        return bool(sp.test_interval and sp.test_iter and sp.test_iter[0]
                    and test_net is not None
                    and _data_layers(test_net))

    def _install_signals(self) -> dict:
        """The stop / snapshot handlers; returns the previous ones."""
        def on_stop(sig, frame):
            print(f"\n{signal.Signals(sig).name} → stop (snapshot + exit)",
                  file=sys.stderr)
            self._stop = True

        def on_hup(sig, frame):
            print("SIGHUP → snapshot", file=sys.stderr)
            self._want_snapshot = True

        wanted = {signal.SIGINT: on_stop, signal.SIGTERM: on_stop}
        if hasattr(signal, "SIGHUP"):
            wanted[signal.SIGHUP] = on_hup
        saved = {}
        for sig, fn in wanted.items():
            saved[sig] = signal.signal(sig, fn)
        return saved

    def _snapshot(self, net, params, st, signalled: bool,
                  announce: bool = True, lockstep: bool = True
                  ) -> Optional[str]:
        """Rank 0 writes the model and the state; under a state split
        over processes every rank writes its sidecar (JAX
        mini_cluster.py:574-628).  Params split over a tp axis across
        processes are first gathered by every process (a collective, so
        only at a `lockstep` boundary: otherwise skipped with a warning).
        Returns the state's path."""
        from . import checkpoint
        ps = self.psolver
        if ps is not None and ps.split:
            if not lockstep:
                print("WARNING: signal-triggered snapshot skipped: params "
                      "are split over processes and an unsynchronized "
                      "gather would hang; wait for the next snapshot "
                      "interval", file=sys.stderr)
                return None
            params = ps.gather_params(params)
            st = ps.export_state(st)
        sharded = checkpoint.state_is_sharded(st)
        if signalled and sharded:
            print("WARNING: signal-triggered snapshot with sharded state: "
                  "deliver the signal to every rank promptly or the "
                  "sidecar set will be incomplete", file=sys.stderr)
        if not (self.is_rank0 or sharded):
            return None
        m, s = checkpoint.snapshot(net, params, st, self.prefix,
                                   fmt=self.sp.snapshot_format,
                                   solver_type=self.solver.solver_type,
                                   write_main=self.is_rank0)
        if self.is_rank0 and announce:
            print(f"snapshot → {m}", flush=True)
        return s

    # ------------------------------------------------------------------
    def train(self) -> str:
        from . import checkpoint
        from .data.queue_runner import (PipelinedFeed, chunked_feed,
                                        combine_batches, device_prefetch,
                                        stage_background, stage_depth,
                                        steps_per_loop, transform_threads)
        from .data.source import get_source
        from .metrics import PipelineMetrics, maybe_start_flusher
        from .processor import ValidationReport
        from .proto.caffe import SnapshotFormat
        from .utils import StepTimer, profile_trace

        solver, args, sp = self.solver, self.args, self.sp
        stepper = self.psolver or solver
        net = solver.train_net
        params, st = solver.init()
        if args.snapshot:
            params, st = checkpoint.restore(net, params, st, args.snapshot,
                                            weights_path=args.weights)
            print(f"resumed from iter {st.iter}")
        elif args.weights:
            params = checkpoint.copy_layers(net, params, args.weights)
            print(f"finetuning from {args.weights}")
        if self.psolver is not None:
            params = self.psolver.shard_params(params)
            st = self.psolver.shard_opt_state(st)
            self.psolver.check_start(params, st)

        layers = _data_layers(net)
        if not layers:
            raise ValueError("train net has no data layer")
        seed = int(sp.random_seed) if sp.random_seed >= 0 else 0
        src = get_source(layers[0], phase_train=True, rank=0, num_ranks=1,
                         seed=seed)
        if self.mesh is not None and self.mesh.dp_blocks > 1:
            from .parallel.mesh import dp_data_rank
            src.take_block(*dp_data_rank(self.mesh))
        device = solver.device
        max_iter = sp.max_iter
        display = sp.display or 0
        snap_every = sp.snapshot or 0
        test_interval = int(sp.test_interval or 0)
        test_iter = int(sp.test_iter[0]) if sp.test_iter else 0
        interleave = self._interleaves()
        if interleave:
            test_net = solver.test_net
            eval_fwd = (self.psolver.eval_step()
                        if self.psolver is not None and self.mesh.size > 1
                        else solver.eval_step_fn())
            val_report = ValidationReport(test_net.output_blobs)
            val_src = get_source(_data_layers(test_net)[0],
                                 phase_train=False, rank=0, num_ranks=1,
                                 seed=seed)
            val_src.enable_device_transform(test_net.dtype)
            val_gen = val_src.batches(loop=True, shuffle=False)
        it = st.iter
        tmajor = frozenset(n for n, _, kind in net.input_specs
                           if kind.endswith(":T"))
        dxf = src.enable_device_transform(net.dtype)
        pmetrics = PipelineMetrics()
        flusher = (maybe_start_flusher(pmetrics, args.output)
                   if self.is_rank0 else None)
        nthreads = transform_threads()
        feed = None
        if nthreads > 0:
            feed = PipelinedFeed(src, loop=True, num_threads=nthreads,
                                 metrics=pmetrics,
                                 should_stop=lambda: self._stop)
            raw_batches = iter(feed)
        else:
            def _timed_batches():
                # inline: read, decode and transform on this thread
                it_ = src.batches(loop=True)
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(it_)
                    except StopIteration:
                        return
                    pmetrics.add("pack", time.perf_counter() - t0)
                    yield b

            raw_batches = _timed_batches()
        # COS_STEPS_PER_LOOP=K > 1: K-step chunks (one CUDA graph replay
        # each on a card), single steps before every boundary this loop
        # acts on: display, validation, snapshot and max_iter (JAX
        # mini_cluster.py:397-425)
        k_loop = steps_per_loop()
        many = stepper.train_step_many(k_loop) if k_loop > 1 else None
        gen = device_prefetch(
            chunked_feed(
                combine_batches(raw_batches, max(1, sp.iter_size), tmajor),
                start_iter=it, max_iter=max_iter, k=k_loop,
                boundaries=(display, test_interval if interleave else 0,
                            snap_every), metrics=pmetrics),
            device, depth=stage_depth(), device_transforms=dxf,
            background=nthreads > 0 and stage_background(device),
            metrics=pmetrics, chunked=True)
        if self.psolver is not None:
            pmetrics.set_info("mesh", self.psolver.layout.describe())
        pmetrics.set_info("comm", solver.grad_sync.plan.comm_info(
            self.mesh.dp_blocks if self.mesh is not None else 1))
        timer = StepTimer(batch_size=src.batch_size)
        timer.start()
        smoothed = None
        saved_handlers = self._install_signals()
        try:
            with profile_trace(args.profile):
                while it < max_iter and not self._stop:
                    t_wait = time.perf_counter()
                    item = next(gen, None)
                    if item is None:
                        break
                    n, batch = item
                    pmetrics.add("queue_wait", time.perf_counter() - t_wait)
                    t_step = time.perf_counter()
                    if n == 1:
                        loss, out = stepper.train_step(
                            params, st, cast_inputs(net, batch))
                    else:
                        # chunks end on display boundaries: the last
                        # step's values are this iteration's
                        loss, out = many(params, st,
                                         cast_inputs(net, batch))
                        loss, out["lr"] = loss[-1], out["lr"][-1]
                    it = st.iter
                    if n == 1:
                        pmetrics.add("step", time.perf_counter() - t_step)
                        pmetrics.mark_step()
                    else:
                        pmetrics.add_chunk(n, time.perf_counter() - t_step)
                    timer.tick(n)
                    if display and it % display == 0:
                        loss_f = float(loss)
                        lr_now = float(out["lr"])
                        smoothed = loss_f if smoothed is None else (
                            0.9 * smoothed + 0.1 * loss_f)
                        print(f"iter {it}/{max_iter} loss={loss_f:.4f} "
                              f"(smoothed {smoothed:.4f}) lr={lr_now:.6f} "
                              f"[{timer.steps_per_sec:.1f} it/s, "
                              f"{timer.records_per_sec:.0f} img/s]",
                              flush=True)
                        if args.metrics and self.is_rank0:
                            with open(args.metrics, "a") as mf:
                                mf.write(json.dumps(
                                    {"iter": it, "loss": round(loss_f, 6),
                                     "smoothed": round(smoothed, 6),
                                     "lr": lr_now,
                                     "steps_per_sec": round(
                                         timer.steps_per_sec, 2),
                                     "records_per_sec": round(
                                         timer.records_per_sec, 1),
                                     "ts": time.time()}) + "\n")
                    if interleave and it % test_interval == 0:
                        for _ in range(test_iter):
                            vb = val_src.apply_device_stage(next(val_gen),
                                                            device)
                            val_report.add_batch(eval_fwd(
                                params, cast_inputs(test_net, vb)))
                        val_report.finish_round()
                        row = val_report.rounds[-1]
                        if self.is_rank0:
                            print("validation iter %d: %s" % (
                                it, " ".join(f"{n}={v:.4f}"
                                             for n, v in row.items())),
                                flush=True)
                    lockstep = bool(snap_every and it % snap_every == 0)
                    if lockstep or self._want_snapshot:
                        signalled = self._want_snapshot
                        self._want_snapshot = False
                        self._snapshot(net, params, st, signalled,
                                       lockstep=lockstep)
        finally:
            for sig, fn in saved_handlers.items():
                signal.signal(sig, fn)
            # the ingest threads stop whatever happens, then the
            # timeline lands (partial runs are when it matters)
            gen.close()
            if feed is not None:
                feed.close()
            if flusher is not None:
                flusher.stop()
            if args.pipeline_metrics and pmetrics.has_samples() \
                    and self.is_rank0:
                try:
                    pmetrics.dump(args.pipeline_metrics)
                    print(f"pipeline metrics → {args.pipeline_metrics}")
                except OSError as e:
                    print(f"WARNING: could not write pipeline metrics: {e}",
                          file=sys.stderr)
        if self.is_rank0:
            print(timer.summary())
        if interleave and val_report.rounds and self.is_rank0:
            vpath = os.path.join(args.output, "validation.json")
            os.makedirs(args.output, exist_ok=True)
            with open(vpath, "w") as vf:
                for row in val_report.rounds:
                    vf.write(json.dumps(
                        {k: round(v, 6) for k, v in row.items()}) + "\n")
            print(f"validation rounds → {vpath}")

        model_path = args.model or checkpoint.snapshot_filename(
            self.prefix, it, is_state=False,
            h5=sp.snapshot_format == SnapshotFormat.HDF5)
        split = self.psolver is not None and bool(self.psolver.split)
        if self._stop:
            # interrupted: model + state, so that -snapshot resumes (the
            # other ranks their sidecars of a state split over them)
            s = self._snapshot(net, params, st, False, announce=False,
                               lockstep=not split)
            if self.is_rank0 and s is not None:
                print(f"stopped at iter {it}; resume with -snapshot {s}")
        if split and not self._stop:
            # every process joins the gather; rank 0 writes
            whole = self.psolver.gather_params(params)
        else:
            whole = params
        if self.is_rank0 and not (split and self._stop):
            checkpoint.save_model(model_path, net, whole)   # .h5: HDF5
            print(f"final model → {model_path}")
        self.final_params = params
        self.final_state = st
        return model_path


def cast_inputs(net, batch):
    """Under -dtype bfloat16, the batch's floating inputs to the net's
    dtype (the JAX package casts on the host, mini_cluster.py:385-397),
    except those the net reads as indices (`Net.index_inputs`)."""
    if net.dtype == torch.float32:
        return batch
    return {k: v.to(net.dtype)
            if v.is_floating_point() and v.dtype != net.dtype
            and k not in net.index_inputs else v
            for k, v in batch.items()}


def _data_layers(net):
    from .ops import layers as L
    return [lp for lp in net.layers if L.get_op(lp.type).is_data]


def main(argv=None) -> int:
    from .parallel.mesh import distributed_close
    args = build_argparser().parse_args(argv)
    MiniCluster(args).train()
    distributed_close()
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
