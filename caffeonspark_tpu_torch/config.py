"""Config: the CLI flag surface of CaffeOnSpark (Config.scala), plus
`-device`.

A copy of `caffeonspark_tpu/config.py` (Config.scala's option table,
solver/net prototxt parsing, data-layer location by `include.phase`),
cut to the flags this package acts on so far: training (`-train`, with
interleaved validation when the solver asks for it; single process;
`-mesh dp[,tp[,sp]]`; `-async_snapshot`), `-test`, `-features` /
`-label` (on the mesh too), `-outputFormat` and serving.  `-device`
picks where the net runs: `cuda` (the default) or `cpu`; a mesh's ranks
all sit on that device.

The JAX command line's other flags are parsed too, and `validate`
refuses each one by name when it is set (`LATER_FLAGS`): a run never
drops a mode or an option without a word.  Flags no JAX version knows
still pass through `parse_known_args`, as Spark passes its own.  The
same holds for the environment: `check_env_knobs` (called by `validate`
and by `mini_cluster`) refuses by name each JAX knob of `LATER_KNOBS`
that would change a run's result, and names the others in a log line.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

from .proto import NetParameter, Phase, SolverParameter, read_net, read_solver

DATA_LAYER_TYPES = ("MemoryData", "CoSData", "Data", "HDF5Data", "ImageData")

# The JAX command line's flags that this package does not act on yet
# (caffeonspark_tpu/config.py's table): flag -> (dest, type or
# "switch", the largest value a one-process run takes, or None for
# "refused whenever given").  `validate` refuses each beyond that.
LATER_FLAGS = {
    "-devices": ("devices", int, 1),
    "-connection": ("connection", str, None),
    "-lmdb_partitions": ("lmdb_partitions", int, None),
    "-imageRoot": ("imageRoot", str, None),
    "-labelFile": ("labelFile", str, None),
    "-captionFile": ("captionFile", str, None),
    "-captionLength": ("captionLength", int, None),
    "-vocabSize": ("vocabSize", int, None),
    "-imageCaptionDFDir": ("imageCaptionDFDir", str, None),
    "-vocabDir": ("vocabDir", str, None),
    "-embeddingDFDir": ("embeddingDFDir", str, None),
    "-serveMesh": ("serveMesh", str, None),
    "-serveReplicas": ("serveReplicas", int, 1),
    "-deploy": ("deploy", "switch", None),
    "-deployRounds": ("deployRounds", int, None),
    "-server": ("server", str, None),
    "-rank": ("rank", int, 0),
}

# The JAX package's environment knobs that this package does not act on
# yet (every `COS_*` name it reads, less the ones ported), each with its
# class, read from its use there:
#   "result" - changes what a one-process run computes or writes: refused
#              by name when set to a value other than its default
#              (KNOB_DEFAULTS, else "" and "0");
#   "speed"  - changes only speed or memory (or a guard's checks);
#   "ranks"  - acts only above one rank or one device;
#   "entry"  - acts only under a flag, a knob or an entry point that the
#              port refuses or lacks (-deploy, -serveReplicas, the
#              autoscaler, the router, prodday, the Spark daemon).
# The last three are named in one logged line when set.  The chaos
# injectors (COS_FAULT_*, tools/chaos.py) are classed by where the JAX
# package acts on them: only COS_FAULT_DIE_ONCE ends a one-process run;
# the others delay it, or act in the sync modes, the NodeAgent, the
# deploy loop or the fleet.
LATER_KNOBS = {
    "COS_AUTOTUNE": "result",        # per-layer dtype/layout variants
    "COS_SYNC_MODE": "result",       # local_sgd / async on one rank too
    "COS_RECORDER_DUMP": "result",   # the flight recorder's artifact
    "COS_METRICS_PORT": "result",    # the live metrics server
    "COS_TRACE_SAMPLE": "result",    # request spans and their spools
    "COS_LANES": "result",           # admission control: 429 sheds
    "COS_FAULT_DIE_ONCE": "result",  # kills the trainer at an iteration
    "COS_FAULT_STEP_DELAY_MS": "speed",
    "COS_FAULT_SLOW_RANK": "speed",
    "COS_FAULT_REPLICA_SLOW": "speed",
    "COS_FAULT_COMM_NS_PER_BYTE": "ranks",
    "COS_FAULT_COMM_LAT_US": "ranks",
    "COS_FAULT_COMM_HIDE_BYTES": "ranks",
    "COS_FAULT_COMM_LOCAL": "ranks",
    "COS_FAULT_COMM_INTRA_NS_PER_BYTE": "ranks",
    "COS_FAULT_FLAKY_EXCHANGE": "ranks",
    "COS_FAULT_FLAKY_STORAGE": "entry",
    "COS_FAULT_HOST_KILL": "entry",
    "COS_FAULT_CANARY_KILL": "entry",
    "COS_FAULT_SNAPSHOT_TRUNCATE": "entry",
    "COS_FAULT_RELOAD_FAIL_RANK": "entry",
    "COS_FAULT_SEED": "entry",
    "COS_AUTOTUNE_CACHE": "entry",
    "COS_AUTOTUNE_FLOOR_GBS": "entry",
    "COS_TRACE_DIR": "entry",
    "COS_PROFILE_DIR": "entry",
    "COS_RECORDER_EVENTS": "entry",
    "COS_LANE_BATCH_DEPTH": "entry",
    "COS_LANE_BATCH_WATERMARK": "entry",
    "COS_LANE_INTERACTIVE_DEPTH": "entry",
    "COS_LANE_RETRY_AFTER_CAP_S": "entry",
    "COS_LANE_TENANT_QUOTA": "entry",
    "COS_AS_ENABLE": "entry",
    "COS_AS_DOWN_COOLDOWN_S": "entry",
    "COS_AS_DOWN_INTERVALS": "entry",
    "COS_AS_DOWN_MARGIN": "entry",
    "COS_AS_INTERVAL_S": "entry",
    "COS_AS_MAX": "entry",
    "COS_AS_MIN": "entry",
    "COS_AS_UP_BREACHES": "entry",
    "COS_AS_UP_COOLDOWN_S": "entry",
    "COS_AS_WINDOW_S": "entry",
    "COS_SLO_P99_MS": "entry",
    "COS_SLO_QDEPTH": "entry",
    "COS_HEDGE_MAX_PCT": "entry",
    "COS_HEDGE_MIN_MS": "entry",
    "COS_HEDGE_PCT": "entry",
    "COS_ROUTER_WEIGHT": "entry",
    "COS_REPLICA_INDEX": "entry",
    "COS_SERVE_REPLICAS": "entry",
    "COS_SERVE_RETRY_BASE_MS": "entry",
    "COS_SERVE_RETRY_CAP_MS": "entry",
    "COS_SERVE_RETRY_MAX": "entry",
    "COS_SERVE_PP_MB": "entry",
    "COS_DEPLOY_ACC_TOL": "entry",
    "COS_DEPLOY_CANARY_TIMEOUT_S": "entry",
    "COS_DEPLOY_EVAL_N": "entry",
    "COS_DEPLOY_MIN_NEW": "entry",
    "COS_DEPLOY_P99_RATIO": "entry",
    "COS_DEPLOY_P99_SLACK_MS": "entry",
    "COS_DEPLOY_POLL_S": "entry",
    "COS_DEPLOY_ROUNDS": "entry",
    "COS_DEPLOY_STEPS": "entry",
    "COS_PRODDAY_EXEMPLARS": "entry",
    "COS_PRODDAY_INFLIGHT": "entry",
    "COS_PRODDAY_RECOVERY_S": "entry",
    "COS_PRODDAY_SCRAPE_S": "entry",
    "COS_FEED_DIR": "entry",
    "COS_FEED_STRICT_RANK": "entry",
    "COS_AGENTS": "ranks",
    "COS_SYNC_ALPHA": "ranks",
    "COS_SYNC_HEARTBEAT_TIMEOUT_S": "ranks",
    "COS_SYNC_K": "ranks",
    "COS_SYNC_ROUND_TIMEOUT_S": "ranks",
    "COS_SYNC_STALENESS": "ranks",
    "COS_SYNC_STORE": "ranks",
    "COS_SYNC_WIRE_DTYPE": "ranks",
    "COS_SERVE_MESH": "ranks",
    "COS_SERVE_TP": "ranks",
    "COS_REMAT": "speed",
    "COS_CONV_LAYOUT": "speed",
    "COS_CONV_S2D": "speed",
    "COS_STAGE_COPY": "speed",
    "COS_DISABLE_FLASH": "speed",
    "COS_DISABLE_PALLAS": "speed",
    "COS_FLASH_INTERPRET": "speed",
    "COS_RECOMPILE_GUARD": "speed",
    "COS_DONATION_POISON": "speed",
    "COS_AOT_CACHE_DIR": "speed",
    "COS_SERVE_HBM_BUDGET_MB": "speed",
    "COS_CACHE_CAP": "speed",
    "COS_CACHE_TTL_S": "speed",
}
# the default values of the "result" knobs, where not "" and "0"
KNOB_DEFAULTS = {"COS_SYNC_MODE": ("", "lockstep"),
                 "COS_METRICS_PORT": ("",),
                 "COS_RECORDER_DUMP": ("",),
                 "COS_TRACE_SAMPLE": ("", "0", "0.0")}

_LOG = logging.getLogger(__name__)


def check_env_knobs(environ=None) -> List[str]:
    """Read the environment now (never at import): raise on a knob of
    the "result" class set to another value than its default, naming
    it, and on a gradient-exchange knob (COS_GRAD_*) set to a value the
    exchange does not take; log one line naming the other knobs of
    LATER_KNOBS that are set, and return their names."""
    from .parallel import gradsync
    env = os.environ if environ is None else environ
    gradsync.env_mode(env)
    gradsync.env_wire_dtype(env)
    gradsync.env_bucket_mb(env)
    for name in sorted(env):
        value = env[name].strip()
        if LATER_KNOBS.get(name) == "result" and \
                value.lower() not in KNOB_DEFAULTS.get(name, ("", "0")):
            raise ValueError(
                f"{name}={value}: the PyTorch port does not act on this "
                "knob yet, and it changes what a run computes or writes "
                "(unset it)")
    ignored = sorted(n for n, cls in LATER_KNOBS.items()
                     if cls != "result" and env.get(n, "") != "")
    if ignored:
        _LOG.warning("knobs the PyTorch port does not act on yet (speed, "
                     "memory, more ranks or an entry point it lacks), "
                     "ignored: %s", ", ".join(
                         f"{n}={env[n]} ({LATER_KNOBS[n]})"
                         for n in ignored))
    return ignored


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="CaffeOnSparkTorch", add_help=True)
    a = p.add_argument
    a("-conf", dest="protoFile", default="",
      help="solver configuration (prototxt)")
    a("-train", dest="isTraining", action="store_true",
      help="training mode")
    a("-test", dest="isTest", action="store_true",
      help="test mode: per-output means over the TEST data layer")
    a("-output", dest="outputPath", default="",
      help="output directory (snapshots, the default -model)")
    a("-snapshot", dest="snapshotStateFile", default="",
      help="solverstate to resume from (its model: -weights, else the "
           "learned_net file next to it)")
    a("-async_snapshot", dest="asyncSnapshot", action="store_true",
      help="write snapshots on a background thread (write-behind): the "
           "train loop stalls only for the host copy, not the file I/O")
    a("-persistent", dest="isPersistent", action="store_true",
      help="cache decoded source records in memory after epoch 0 "
           "(sourceRDD.persist analog)")
    a("-clusterSize", dest="clusterSize", type=int, default=1,
      help="number of executor processes (1: the port trains on one "
           "device so far)")
    a("-resize", dest="resize", action="store_true",
      help="resize images to layer dims (encoded images only)")
    a("-features", dest="features", default="",
      help="comma-separated blob names for feature extraction/serving")
    a("-label", dest="label", default="",
      help="label blob name (feature extraction)")
    a("-outputFormat", dest="outputFormat", default="json",
      help="json | parquet (validation and features output)")
    a("-model", dest="modelPath", default="",
      help="model file path (in/out)")
    a("-weights", dest="snapshotModelFile", default="",
      help="caffemodel to finetune from")
    a("-serve", dest="serve", action="store_true",
      help="online inference serving: dynamic micro-batching over a "
           "JSON HTTP front end (weights from -model/-weights; knobs "
           "COS_SERVE_MAX_BATCH / COS_SERVE_MAX_WAIT_MS / "
           "COS_SERVE_QUEUE_DEPTH)")
    a("-servePort", dest="servePort", type=int, default=0,
      help="serving HTTP port (0 = ephemeral, printed at startup)")
    a("-serveHost", dest="serveHost", default="127.0.0.1",
      help="serving bind address (loopback by default; the unauth'd "
           "/v1/reload endpoint makes wider binds an explicit opt-in)")
    a("-device", dest="device", default="cuda",
      help="where the net runs: cuda (default) or cpu")
    # mesh extensions (not in the reference)
    a("-mesh", dest="mesh", default="",
      help="mesh spec dp[,tp[,sp[,ep]]] per process")
    for flag, (dest, kind, _) in LATER_FLAGS.items():
        if kind == "switch":
            a(flag, dest=dest, action="store_true",
              help="a later slice of the PyTorch port (refused)")
        else:
            a(flag, dest=dest, type=kind, default=None,
              help="a later slice of the PyTorch port (refused when set)")
    return p


def resolve_net_path(solver_path: str, net_path: str) -> str:
    """Resolve the solver's `net:` reference: absolute/cwd-relative, else
    look next to the solver file."""
    if not os.path.isabs(net_path) and not os.path.exists(net_path):
        cand = os.path.join(os.path.dirname(os.path.abspath(solver_path)),
                            os.path.basename(net_path))
        if os.path.exists(cand):
            return cand
    return net_path


class Config:
    """Parsed CLI + solver/net prototxt."""

    def __init__(self, args: Optional[List[str]] = None, **overrides):
        ns, _ = build_argparser().parse_known_args(args or [])
        for k, v in overrides.items():
            setattr(ns, k, v)
        self.args = ns
        for k in vars(ns):
            setattr(self, k, getattr(ns, k))

        self.solverParameter: Optional[SolverParameter] = None
        self.netParam: Optional[NetParameter] = None
        if self.protoFile:
            self.solverParameter = read_solver(self.protoFile)
            self.netParam = read_net(
                resolve_net_path(self.protoFile, self.solverParameter.net))

    # -- data-layer location by phase (Config.scala:73-86) ---------------
    def _data_layer_ids(self, phase: int) -> List[int]:
        out = []
        if self.netParam is None:
            return out
        from .net import layer_included
        from .proto import NetState
        state = NetState(phase=phase)
        for i, lyr in enumerate(self.netParam.layer):
            if lyr.type in DATA_LAYER_TYPES and layer_included(lyr, state):
                out.append(i)
        return out

    @property
    def train_data_layer_id(self) -> int:
        ids = self._data_layer_ids(Phase.TRAIN)
        return ids[0] if ids else -1

    @property
    def test_data_layer_id(self) -> int:
        ids = self._data_layer_ids(Phase.TEST)
        return ids[0] if ids else -1

    def train_data_layer(self):
        i = self.train_data_layer_id
        return self.netParam.layer[i] if i >= 0 else None

    def test_data_layer(self):
        i = self.test_data_layer_id
        return self.netParam.layer[i] if i >= 0 else None

    def validates(self) -> bool:
        """Does -train interleave validation?  (A TEST data layer, and
        test_interval and test_iter in the solver.)"""
        sp = self.solverParameter
        return bool(self.isTraining and sp is not None
                    and self.test_data_layer() is not None
                    and sp.test_interval and sp.test_iter
                    and sp.test_iter[0])

    def validate(self) -> None:
        check_env_knobs()
        for flag, (dest, kind, most) in LATER_FLAGS.items():
            value = getattr(self, dest)
            if value in (None, False) or (most is not None
                                          and value <= most):
                continue
            shown = flag if kind == "switch" else f"{flag} {value}"
            raise ValueError(f"{shown}: a later slice of the PyTorch port "
                             "(this package runs -train, -test, -features "
                             "and -serve in one process so far)")
        if self.outputFormat not in ("json", "parquet"):
            raise ValueError(f"-outputFormat {self.outputFormat!r}: "
                             "expected json or parquet")
        if self.device not in ("cuda", "cpu") \
                and not str(self.device).startswith("cuda:"):
            raise ValueError(f"-device {self.device!r}: expected cuda, "
                             "cuda:<index> or cpu")
        if self.clusterSize != 1:
            raise ValueError(f"-clusterSize {self.clusterSize}: the PyTorch "
                             "port trains in one process so far (its dp "
                             "ranks share -device under -mesh; more "
                             "processes are ROADMAP Queue 1 item 6c)")
        if self.isTraining:
            if self.netParam is None:
                raise ValueError("-train needs -conf (solver prototxt "
                                 "resolving a net)")
            if self.train_data_layer_id < 0:
                raise ValueError("no TRAIN-phase data layer in net "
                                 "prototxt")
            if self.serve:
                raise ValueError("-train and -serve are separate runs")
        if (self.isTest or self.features) and not self.serve \
                and self.netParam is None:
            raise ValueError("-test / -features need -conf (solver "
                             "prototxt resolving a net)")
        if self.mesh:
            from .parallel.mesh import parse_mesh_spec
            parse_mesh_spec(self.mesh)   # the grammar; build_mesh refuses axes
            if self.serve:
                raise ValueError("-mesh applies to -train, -test and "
                                 "-features (serving on a mesh is ROADMAP "
                                 "Queue 1 item 7)")
        if self.serve:
            if self.netParam is None:
                raise ValueError("-serve needs -conf (solver prototxt "
                                 "resolving a net)")
            if not (self.modelPath or self.snapshotModelFile):
                raise ValueError("-serve needs trained weights: "
                                 "-model or -weights")
