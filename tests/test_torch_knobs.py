"""The JAX package's environment knobs in the PyTorch port, and
`validation_source` against the JAX function.

  * `config.LATER_KNOBS` names every `COS_*` knob the JAX package reads
    and the port does not act on (scanned from the JAX sources), each
    with its class;
  * a knob of the "result" class set to another value than its default
    is refused by name by `Config.validate`, by `caffe_on_spark.main`
    and by `mini_cluster`; its default values pass;
  * the other knobs pass, named in one logged line;
  * `mini_cluster` takes `-devices k` as k dp ranks, one process for
    `-server` alone, and refuses by name what its process flags cannot
    do (a tp or sp axis across processes, `-cluster` without `-server`,
    `-rank` without `-cluster`, the NodeAgent's `agent://`);
  * `validation_source` returns the TEST layer's source exactly when
    the JAX function does, with and without -train.
"""

import logging
import math
import os
import re

import pytest

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu.config import Config as JaxConfig
from caffeonspark_tpu_torch import caffe_on_spark, config, mini_cluster
from caffeonspark_tpu_torch.config import Config
from torch_common import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT = sorted(n for n, c in config.LATER_KNOBS.items() if c == "result")
LOGGED = sorted(n for n, c in config.LATER_KNOBS.items() if c != "result")
NON_DEFAULT = {"COS_SYNC_MODE": "async", "COS_METRICS_PORT": "0",
               "COS_RECORDER_DUMP": "/tmp/rec", "COS_TRACE_SAMPLE": "1.0",
               "COS_FAULT_DIE_ONCE": "0:3:/tmp/marker"}

NET = """
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  include { phase: TRAIN } source_class: "com.yahoo.ml.caffe.LMDB"
  memory_data_param { source: "train" batch_size: 2 channels: 1
    height: 2 width: 2 } }
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  include { phase: TEST } source_class: "com.yahoo.ml.caffe.LMDB"
  memory_data_param { source: "test" batch_size: 2 channels: 1
    height: 2 width: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
"""


def _solver(tmp_path, extra=""):
    (tmp_path / "net.prototxt").write_text(NET)
    path = tmp_path / "solver.prototxt"
    path.write_text(f'net: "{tmp_path / "net.prototxt"}"\nbase_lr: 0.1\n'
                    f'max_iter: 2\n{extra}')
    return str(path)


def _jax_knobs():
    names = set()
    for root, _, files in os.walk(os.path.join(REPO, "caffeonspark_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r"COS_[A-Z0-9_]+", fh.read()))
    return names


def _port_knobs():
    """Names the port reads: the quoted ones outside config.py."""
    names = set()
    for root, _, files in os.walk(os.path.join(REPO,
                                               "caffeonspark_tpu_torch")):
        for f in files:
            if f.endswith(".py") and f != "config.py":
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r"[\"'](COS_[A-Z0-9_]+)",
                                            fh.read()))
    return names


def test_table_covers_every_jax_knob():
    """Each JAX knob is acted on by the port or listed in LATER_KNOBS
    (COS_SERVE_ / COS_SYNC_ / COS_DEPLOY_ / COS_FAULT_ are prefixes the
    JAX code scans for; their members are listed one by one)."""
    ported = _port_knobs()
    assert {"COS_STATE_DTYPE", "COS_METRICS_FLUSH_S", "COS_STEPS_PER_LOOP",
            "COS_NATIVE", "COS_ZERO"} <= ported
    for name in sorted(_jax_knobs()):
        if name.endswith("_"):
            continue
        assert (name in config.LATER_KNOBS) != (name in ported), name
    assert set(config.LATER_KNOBS.values()) == {"result", "speed", "ranks",
                                                "entry"}
    assert {"COS_AUTOTUNE", "COS_SYNC_MODE", "COS_RECORDER_DUMP",
            "COS_METRICS_PORT", "COS_FAULT_DIE_ONCE"} <= set(RESULT)
    for name in ("COS_CONV_S2D", "COS_REMAT", "COS_CONV_LAYOUT",
                 "COS_STAGE_COPY", "COS_SYNC_K",
                 "COS_FAULT_STEP_DELAY_MS", "COS_FAULT_HOST_KILL"):
        assert name in LOGGED


@pytest.mark.parametrize("knob", RESULT)
def test_result_knob_refused_by_name(knob, tmp_path, monkeypatch):
    solver = _solver(tmp_path)
    monkeypatch.setenv(knob, NON_DEFAULT.get(knob, "1"))
    conf = Config(["-conf", solver, "-train", "-device", "cpu"])
    with pytest.raises(ValueError, match=knob):
        conf.validate()
    with pytest.raises(ValueError, match=knob):
        caffe_on_spark.main(["-conf", solver, "-train", "-device", "cpu",
                             "-output", str(tmp_path / "o")])
    with pytest.raises(ValueError, match=knob):
        mini_cluster.main(["-solver", solver, "-device", "cpu",
                           "-output", str(tmp_path / "m")])
    assert not os.path.exists(tmp_path / "o")
    assert not os.path.exists(tmp_path / "m")


@pytest.mark.parametrize("knob,value", [("COS_SYNC_MODE", "lockstep"),
                                        ("COS_GRAD_SYNC", "default"),
                                        ("COS_AUTOTUNE", "0"),
                                        ("COS_LANES", "0"),
                                        ("COS_TRACE_SAMPLE", "0.0"),
                                        ("COS_FAULT_DIE_ONCE", "")])
def test_result_knob_default_passes(knob, value, monkeypatch):
    env = {"PATH": "/bin", knob: value}
    assert config.check_env_knobs(env) == []


def test_other_knobs_named_in_one_logged_line(caplog):
    env = {"COS_CONV_S2D": "8", "COS_SYNC_K": "4",
           "COS_AS_MAX": "4", "COS_REMAT": "1", "COS_SYNC_MODE": "lockstep",
           "PATH": "/bin"}
    with caplog.at_level(logging.WARNING,
                         logger="caffeonspark_tpu_torch.config"):
        names = config.check_env_knobs(env)
    assert names == ["COS_AS_MAX", "COS_CONV_S2D", "COS_REMAT",
                     "COS_SYNC_K"]
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1
    for n in names:
        assert n in lines[0]
    assert "COS_CONV_S2D=8 (speed)" in lines[0]
    assert "COS_SYNC_K=4 (ranks)" in lines[0]


@pytest.mark.parametrize("argv,name", [
    (["-devices", "2"], "dp"), (["-cluster", "2"], "needs -server"),
    (["-server", "h:1"], "one process"), (["-rank", "1"], "-rank 1"),
    (["-mesh", "2,1,1"], "dp"), (["-mesh", "1,2,1"], "tp"),
    (["-mesh", "1,1,1,2"], "ep"), (["-mesh", "pp=2"], "pp"),
    (["-devices", "1", "-cluster", "1", "-rank", "0"], None),
    (["-cluster", "2", "-server", "h:1", "-rank", "1", "-mesh", "1,2"],
     "across tp"),
    (["-cluster", "2", "-server", "h:1", "-rank", "1", "-mesh", "1,1,2"],
     "across sp"),
    (["-cluster", "2", "-server", "agent://h:1", "-rank", "1"], "item 9")])
def test_mini_cluster_refuses_more_ranks_by_name(argv, name, tmp_path):
    """-devices 2 is 2 dp ranks sharing -device and -server alone one
    process; -cluster without -server, -rank without -cluster and the
    NodeAgent's rendezvous are refused by name before any rendezvous,
    and so are ep and pp; a mesh with dp or tp of 2 builds (its ranks
    share -device); -cluster 2 -mesh 1,2 (1,1,2) is the global mesh, of
    which rank 1 holds tp (sp) rank 1 (checked without a rendezvous)."""
    args = mini_cluster.build_argparser().parse_args(
        ["-solver", _solver(tmp_path), "-device", "cpu"] + argv)
    if name is None:
        assert mini_cluster.mesh_spec(args) is None
        return
    if name.startswith("across "):
        from caffeonspark_tpu_torch.parallel.mesh import (mesh_dims,
                                                          process_box)
        axis = name.split()[1]
        dims = mesh_dims(mini_cluster.mesh_spec(args), 2)
        assert dims[axis] == 2 and math.prod(dims.values()) == 2
        local, offsets = process_box(dims, 2, args.rank)
        assert local[axis] == 1 and offsets[axis] == 1
        assert all(n == 1 for n in local.values())
        return
    if name in ("dp", "tp"):
        assert mini_cluster.MiniCluster(args).mesh.shape[name] == 2
        return
    if name == "one process":
        mc = mini_cluster.MiniCluster(args)
        assert (mc.procs, mc.rank, mc.mesh) == (1, 0, None)
        return
    with pytest.raises(ValueError, match=re.escape(name)):
        mini_cluster.MiniCluster(args)


@pytest.mark.parametrize("train", [True, False], ids=["train", "no-train"])
@pytest.mark.parametrize("extra", [
    "test_iter: 2\ntest_interval: 1\n", "test_interval: 1\n",
    "test_iter: 2\n", "test_iter: 0\ntest_interval: 1\n", ""])
def test_validation_source_matches_jax(extra, train, tmp_path):
    """The reference's condition: a TEST data layer, test_interval and a
    nonzero test_iter, with or without -train (the port needed -train
    before)."""
    solver = _solver(tmp_path, extra)
    argv = ["-conf", solver] + (["-train"] if train else [])
    want = jax_cos.validation_source(JaxConfig(argv))
    got = caffe_on_spark.validation_source(Config(argv + ["-device",
                                                          "cpu"]))
    assert (got is None) == (want is None)
    if want is not None:
        assert got.source_uri() == "test" and not got.phase_train
        assert (got.batch_size, got.rank, got.num_ranks) == (2, 0, 1)
