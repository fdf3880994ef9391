"""Data-parallel training across processes (`parallel.mesh.
distributed_init`, gloo) in the PyTorch port, against the JAX package
and against the port's own one-process dp.

Each test that trains starts two processes on 127.0.0.1 at a free port
(`tests/torch_multiproc_child.py`, torch on one thread each), waits for
each with a timeout and asserts values only, no timing:
  * dp 2 (two processes) and dp 4 (two processes of two ranks) of
    tests/test_torch_dp.py's tiny net against the JAX package's dp 2
    and dp 4 on its 8 virtual CPU devices, jitted, from the same seeded
    numpy params and batches (loss rel 2e-4, weights rtol 2e-3 / atol
    2e-5), and against the port's one-process -mesh 2 (byte-equal) and
    -mesh 4 (losses rtol 1e-5, weights rtol 1e-5 / atol 1e-7);
  * the exchange modes across processes (hier, bucket with its backward
    hooks, quant, auto), each byte-equal to the same mode in one
    process; auto picks hier;
  * `mini_cluster -server -cluster 2 -rank I` on an LMDB (shuffle,
    random crop, mirror, Dropout) byte-equal to one process's -mesh 2
    under default and hier, and `-cluster 2 -devices 2` within the
    tolerances of one process's -mesh 4;
  * ZeRO-1 across processes: each rank's `.shard<k>` sidecar, read by
    the JAX package's `_load_state_shards` into the arrays the port
    reads, equal to one process's state at the same step; a resume on
    two processes and one in one process end byte-equal;
  * a rank that starts from other weights is refused by the checksum;
  * the CLI's `-clusterSize 2 -rank 1` feeds shard 1 and trains the
    model the JAX CLI trains.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.parallel import ParallelSolver as JaxParallelSolver
from caffeonspark_tpu.parallel import build_mesh as jax_build_mesh
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import caffe_on_spark, checkpoint, convert
from caffeonspark_tpu_torch.data import LmdbWriter, get_source
from caffeonspark_tpu_torch.parallel.comm import Shards
from caffeonspark_tpu_torch.parallel.gradsync import GradSync
from caffeonspark_tpu_torch.parallel.mesh import Mesh, dp_data_rank
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.proto.caffe import Datum
from caffeonspark_tpu_torch.solver import OptState, Solver
from torch_common import cap_torch_threads

cap_torch_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "torch_multiproc_child.py")
CPU = torch.device("cpu")
WAIT_S = 300
LOSS_REL = 2e-4
W_RTOL, W_ATOL = 2e-3, 2e-5

# tests/test_torch_dp.py's tiny net (test_parallel.py's) at a global
# batch of 32
NET = """
name: "tiny"
layer {
  name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 32 channels: 1 height: 28 width: 28 }
}
layer {
  name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "xavier" } }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer {
  name: "fc_big" type: "InnerProduct" bottom: "conv1" top: "fc_big"
  inner_product_param { num_output: 2048 weight_filler { type: "xavier" } }
}
layer { name: "relu2" type: "ReLU" bottom: "fc_big" top: "fc_big" }
layer {
  name: "ip2" type: "InnerProduct" bottom: "fc_big" top: "ip2"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } }
}
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss" }
"""
SOLVER = ('base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n'
          'max_iter: 20\nrandom_seed: 11\n')

# an LMDB-fed net with what couples the ranks of a step: random crop and
# mirror, Dropout's mask, the loss's normalizer, Accuracy; fc1's weight
# (1024 x 16) is big enough for ZeRO-1 to split
LMDB_NET = """name: "TinyLmdb"
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  source_class: "com.yahoo.ml.caffe.LMDB"
  transform_param {{ scale: 0.00390625 crop_size: 4 mirror: true }}
  memory_data_param {{ batch_size: 8 channels: 1 height: 6 width: 6
                      source: "{src}" }} }}
layer {{ name: "fc1" type: "InnerProduct" bottom: "data" top: "fc1"
  inner_product_param {{ num_output: 1024
                        weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "relu" type: "ReLU" bottom: "fc1" top: "fc1" }}
{drop}layer {{ name: "ip" type: "InnerProduct" bottom: "fc1" top: "ip"
  inner_product_param {{ num_output: 10
                        weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }}
layer {{ name: "acc" type: "Accuracy" bottom: "ip" bottom: "label"
  top: "acc" }}
"""


DROPOUT = ('layer { name: "drop" type: "Dropout" bottom: "fc1" top: "fc1"\n'
           '  dropout_param { dropout_ratio: 0.5 } }\n')


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(env=None):
    """The test process's environment without its COS_ knobs (a JAX test
    of the same worker may leave some), with `env` and the repo."""
    out = {k: v for k, v in os.environ.items() if not k.startswith("COS_")}
    out["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    out["OMP_NUM_THREADS"] = "1"
    out.update(env or {})
    return out


def _spawn(argvs, cwd, env=None):
    """Start one child per argv, wait for each (WAIT_S), return their
    (returncode, output); a child that outlives the wait is killed with
    the others."""
    procs = [subprocess.Popen([sys.executable, CHILD, *argv], cwd=str(cwd),
                              env=_child_env(env), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT_S)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _ok(outs):
    for rc, out in outs:
        assert rc == 0, out[-3000:]


# ---------------------------------------------------------------------------
# ParallelSolver steps: two processes against JAX and one process
# ---------------------------------------------------------------------------

def _image_batch(n=32, seed=3):
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(n, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, n).astype(np.float32)}


def _arrays(seed=5):
    s = Solver(SolverParameter.from_text(SOLVER),
               NetParameter.from_text(NET), device="cpu")
    return convert.params_to_numpy(s.train_net.init(seed))




def _jax_run(arrays, batches, dp):
    """The JAX ParallelSolver's steps (jitted) from the same params."""
    js = JaxSolver(JaxSolverParameter.from_text(SOLVER),
                   JaxNetParameter.from_text(NET))
    ps = JaxParallelSolver(js, jax_build_mesh(devices=jax.devices()[:dp],
                                              dp=dp))
    jp = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
          for ln, bl in arrays.items()}
    st = ps.shard_opt_state(js.init_state(jp))
    p = ps.shard_params(jp)
    step = ps.train_step()
    losses = []
    for i, b in enumerate(batches):
        p, st, out = step(p, st, ps.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}), js.step_rng(i))
        losses.append(float(out["loss"]))
    return np.asarray(losses), {ln: {bn: np.asarray(jax.device_get(a))
                                     for bn, a in bl.items()}
                                for ln, bl in p.items()}


def _processes(tmp_path, arrays, batches, procs, k, env=None, tag="out"):
    """`procs` child processes of k dp ranks each (one process: no
    rendezvous): (rank 0's losses, its params, its exchange mode,
    comm_info); every rank ends with the same bits."""
    np.savez(tmp_path / "params.npz", **{f"{ln}/{bn}": a for ln, bl in
                                        arrays.items()
                                        for bn, a in bl.items()})
    np.savez(tmp_path / "batches.npz", **{f"{i}/{name}": v for i, b in
                                         enumerate(batches)
                                         for name, v in b.items()})
    port = _free_port()
    argvs = []
    for r in range(procs):
        spec = tmp_path / f"{tag}{r}.json"
        spec.write_text(json.dumps(dict(
            server=f"127.0.0.1:{port}" if procs > 1 else None,
            procs=procs, rank=r, k=k, net=NET, solver=SOLVER,
            params=str(tmp_path / "params.npz"),
            batches=str(tmp_path / "batches.npz"),
            out=str(tmp_path / tag))))
        argvs.append(["steps", str(spec)])
    _ok(_spawn(argvs, tmp_path, env))
    got = [np.load(tmp_path / f"{tag}.rank{r}.npz") for r in range(procs)]
    for key in got[0].files:
        for other in got[1:]:
            np.testing.assert_array_equal(got[0][key], other[key],
                                          err_msg=key)
    params = {}
    for key in got[0].files:
        if key.startswith("param/"):
            _, ln, bn = key.split("/")
            params.setdefault(ln, {})[bn] = got[0][key]
    return (got[0]["losses"], params, str(got[0]["mode"]),
            json.loads(str(got[0]["comm"])))


def _equal(a, b):
    for ln, bl in b.items():
        for bn, w in bl.items():
            np.testing.assert_array_equal(a[ln][bn], w, err_msg=f"{ln}/{bn}")


def _close(a, b, rtol, atol):
    for ln, bl in b.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(a[ln][bn], w, rtol=rtol, atol=atol,
                                       err_msg=f"{ln}/{bn}")


@pytest.mark.parametrize("k", [1, 2], ids=["dp2", "dp4"])
def test_processes_match_jax_and_one_process(tmp_path, k):
    """Two processes of k dp ranks against the JAX package's dp 2k and
    the port's one-process dp 2k over 3 steps: dp 2 byte-equal (two
    partial sums add in either order to the same bits), dp 4 within
    rtol 1e-5 (its four are associated otherwise)."""
    dp = 2 * k
    arrays = _arrays()
    batches = [_image_batch(seed=3 + i) for i in range(3)]
    got, gp, mode, comm = _processes(tmp_path, arrays, batches, 2, k)
    want, wp = _jax_run(arrays, batches, dp)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _close(gp, wp, W_RTOL, W_ATOL)
    one, p1, _, _ = _processes(tmp_path, arrays, batches, 1, dp, tag="one")
    if dp == 2:
        np.testing.assert_array_equal(got, one)
        _equal(gp, p1)
    else:
        np.testing.assert_allclose(got, one, rtol=1e-5)
        _close(gp, p1, 1e-5, 1e-7)
    assert mode == "default"
    assert comm["processes"] == 2
    assert comm["cross_process_bytes_per_step"] == \
        comm["exchanged_params"] * 4


@pytest.mark.parametrize("mode", ["hier", "bucket", "quant", "auto"])
def test_exchange_modes_across_processes(tmp_path, mode):
    """Each exchange mode (its backward hooks on: gloo collectives issued
    without waiting) at two processes, byte-equal to the same mode at
    dp 2 in one process; auto is hier across processes, as in the JAX
    package, and bucket in one."""
    env = {"COS_GRAD_SYNC": mode, "COS_GRAD_BUCKET_MB": "1"}
    arrays = _arrays()
    batches = [_image_batch(seed=7 + i) for i in range(2)]
    got, gp, resolved, comm = _processes(tmp_path, arrays, batches, 2, 1,
                                         env)
    one, p1, one_mode, _ = _processes(tmp_path, arrays, batches, 1, 2, env,
                                      tag="one")
    np.testing.assert_array_equal(got, one)
    _equal(gp, p1)
    assert resolved == ("hier" if mode == "auto" else mode)
    assert one_mode == ("bucket" if mode == "auto" else mode)
    assert comm["buckets"] > 1


def test_auto_picks_hier_when_dp_spans_processes():
    """JAX gradsync.py:365: auto is default at dp 1, hier when the dp
    ranks span processes, bucket in one process (checked without a
    rendezvous: the mesh says what it spans)."""
    net = Solver(SolverParameter.from_text(SOLVER),
                 NetParameter.from_text(NET), device="cpu").train_net
    dev = np.empty((1, 1, 1, 1, 1), dtype=object)
    dev[:] = CPU
    for procs, want in ((1, "default"), (2, "hier")):
        gs = GradSync(net, mode="auto").bind_mesh(Mesh(dev, procs, 0))
        assert gs.mode == want
    two = np.empty((1, 1, 1, 1, 2), dtype=object)
    two[:] = CPU
    assert GradSync(net, mode="auto").bind_mesh(Mesh(two)).mode == "bucket"


def test_dp_data_rank_and_block_feed(tmp_path):
    """dp_data_rank is (process, processes) over processes and (0, 1) in
    one, as the JAX package's; `take_block(p, 2)` packs block p of the
    very batches one process packs (records, order, crops, mirrors)."""
    dev = np.empty((1, 1, 1, 1, 2), dtype=object)
    dev[:] = CPU
    assert dp_data_rank(Mesh(dev, 2, 1)) == (1, 2)
    assert dp_data_rank(Mesh(dev)) == (0, 1)
    solver = _lmdb_config(tmp_path)
    layer = NetParameter.from_text(
        (tmp_path / "net.prototxt").read_text()).layer[0]
    assert solver

    def stream(block):
        src = get_source(layer, phase_train=True, seed=5)
        if block is not None:
            src.take_block(block, 2)
        gen = src.batches()
        return [next(gen) for _ in range(12)]    # past an epoch of 8

    whole = stream(None)
    halves = [stream(0), stream(1)]
    for i, b in enumerate(whole):
        for key, v in b.items():
            np.testing.assert_array_equal(
                np.concatenate([h[i][key] for h in halves]), v)
    with pytest.raises(ValueError, match="no block 0 of 3"):
        get_source(layer, phase_train=True).take_block(0, 3)


def test_start_checksum_refuses_a_rank_with_other_weights(tmp_path):
    """A planted fault: rank 1 starts from another -weights file.  The
    start checksum over the processes refuses it on both ranks, naming
    rank 1, before a step."""
    solver = _lmdb_config(tmp_path)
    s = Solver(SolverParameter.from_text("base_lr: 0.1"),
               NetParameter.from_text((tmp_path / "net.prototxt")
                                      .read_text()), device="cpu")
    other = str(tmp_path / "other.caffemodel")
    checkpoint.save_caffemodel(other, s.train_net, s.train_net.init(99))
    port = _free_port()
    outs = _spawn([["mini_cluster", "-solver", solver, "-device", "cpu",
                    "-server", f"127.0.0.1:{port}", "-cluster", "2",
                    "-rank", str(r), "-output", str(tmp_path / "o")]
                   + (["-weights", other] if r == 1 else [])
                   for r in range(2)], tmp_path)
    for rc, out in outs:
        assert rc != 0
        assert "rank 1: parameters (or iteration) differ from rank 0's" \
            in out, out[-2000:]
        assert "iter 1/" not in out


# ---------------------------------------------------------------------------
# mini_cluster through its command line
# ---------------------------------------------------------------------------

def _lmdb_config(tmp_path, max_iter=6, extra="", dropout=True):
    src = tmp_path / "lmdb"
    if not src.exists():
        rng = np.random.RandomState(3)
        LmdbWriter(str(src)).write([(b"%08d" % i, Datum(
            channels=1, height=6, width=6,
            data=rng.randint(0, 256, 36).astype(np.uint8).tobytes(),
            label=int(rng.randint(10))).to_binary()) for i in range(64)])
    (tmp_path / "net.prototxt").write_text(LMDB_NET.format(
        src=src, drop=DROPOUT if dropout else ""))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{tmp_path / "net.prototxt"}"\nbase_lr: 0.1\n'
                      f'momentum: 0.9\nlr_policy: "fixed"\n'
                      f'max_iter: {max_iter}\nrandom_seed: 5\ndisplay: 1\n'
                      f'snapshot_prefix: "t"\n{extra}')
    return str(solver)


def _mc_pair(tmp_path, solver, out, *extra, env=None):
    """mini_cluster -cluster 2 as two processes; returns their outputs."""
    port = _free_port()
    d = tmp_path / out
    d.mkdir()
    outs = _spawn([["mini_cluster", "-solver", solver, "-device", "cpu",
                    "-server", f"127.0.0.1:{port}", "-cluster", "2",
                    "-rank", str(r), "-output", str(d), "-model",
                    str(d / "final.caffemodel"), "-metrics",
                    str(d / "steps.jsonl"), *extra] for r in range(2)],
                  tmp_path, env)
    _ok(outs)
    return [out for _, out in outs]


def _mc_one(tmp_path, solver, out, *extra, env=None):
    """mini_cluster in one process (a child too: the same environment)."""
    d = tmp_path / out
    d.mkdir()
    _ok(_spawn([["mini_cluster", "-solver", solver, "-device", "cpu",
                 "-output", str(d), "-model", str(d / "final.caffemodel"),
                 "-metrics", str(d / "steps.jsonl"), *extra]], tmp_path,
               env))


def _losses(path):
    with open(path) as f:
        return [json.loads(x)["loss"] for x in f if x.strip()]


def _model(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["default", "hier", "k2"])
def test_mini_cluster_two_processes_equal_one(tmp_path, mode):
    """`mini_cluster -cluster 2` trains, bit for bit, what one process's
    `-mesh 2` trains on the same LMDB (shuffled, cropped, mirrored; a
    Dropout mask), under default and hier, and in chunks of
    COS_STEPS_PER_LOOP=2 (eager across processes) against one process's
    single steps: rank 0 alone writes the final model and -metrics,
    both ranks print their iter lines and only rank 0 the final model."""
    solver = _lmdb_config(tmp_path)
    env = ({"COS_STEPS_PER_LOOP": "2"} if mode == "k2"
           else {"COS_GRAD_SYNC": mode})
    # chunks end on display boundaries: every other step's display
    extra = ["-display_every", "2"] if mode == "k2" else []
    outs = _mc_pair(tmp_path, solver, "two", *extra, env=env)
    _mc_one(tmp_path, solver, "one", "-mesh", "2", *extra,
            env=None if mode == "k2" else env)
    assert _model(tmp_path / "two" / "final.caffemodel") == \
        _model(tmp_path / "one" / "final.caffemodel")
    assert _losses(tmp_path / "two" / "steps.jsonl") == \
        _losses(tmp_path / "one" / "steps.jsonl")
    for r, out in enumerate(outs):
        assert "iter 6/6" in out
        assert ("final model →" in out) == (r == 0)


def test_mini_cluster_devices_two_per_process(tmp_path):
    """`-cluster 2 -devices 2` (dp 4: two ranks in each process) against
    one process's `-mesh 4`: the four gradients are associated
    otherwise, so losses within rtol 1e-5 and weights rtol 1e-5 / atol
    1e-7."""
    solver = _lmdb_config(tmp_path)
    _mc_pair(tmp_path, solver, "two", "-devices", "2")
    _mc_one(tmp_path, solver, "one", "-mesh", "4")
    np.testing.assert_allclose(_losses(tmp_path / "two" / "steps.jsonl"),
                               _losses(tmp_path / "one" / "steps.jsonl"),
                               rtol=1e-5)
    got = checkpoint.load_caffemodel_blobs(
        str(tmp_path / "two" / "final.caffemodel"))
    want = checkpoint.load_caffemodel_blobs(
        str(tmp_path / "one" / "final.caffemodel"))
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=ln)


def test_zero_sidecars_across_processes(tmp_path):
    """ZeRO-1 at -cluster 2, a snapshot at step 3 of 6: each rank writes
    `<state>.shard<rank>` (fc1's state slices) and rank 0 the model and
    the `.solverstate` with a shape-only marker; the JAX package's reader
    assembles the sidecars into the arrays the port's reader gives, equal
    to one process's (-mesh 2, dense) state at step 3; a resume on two
    processes and one in one process end byte-equal, and the unbroken
    run equals the plain one-process run."""
    solver = _lmdb_config(tmp_path, extra="snapshot: 3\n")
    zero = {"COS_ZERO": "1"}
    _mc_pair(tmp_path, solver, "z", env=zero)
    _mc_one(tmp_path, solver, "one", "-mesh", "2")
    assert _model(tmp_path / "z" / "final.caffemodel") == \
        _model(tmp_path / "one" / "final.caffemodel")
    state = tmp_path / "z" / "t_iter_3.solverstate"
    assert sorted(p.name for p in (tmp_path / "z").iterdir()
                  if ".shard" in p.name) == [
        "t_iter_3.solverstate.shard0", "t_iter_3.solverstate.shard1",
        "t_iter_6.solverstate.shard0", "t_iter_6.solverstate.shard1"]
    it, _, hist = checkpoint._read_state(str(state))
    it1, _, dense = checkpoint._read_state(
        str(tmp_path / "one" / "t_iter_3.solverstate"))
    assert it == it1 == 3
    for h, d in zip(hist, dense):
        np.testing.assert_array_equal(h, d)
    slabs = jax_ckpt._load_state_shards(str(state))
    assert sorted(slabs) == ["b0__0-512_0-16", "b0__512-1024_0-16"]
    np.testing.assert_array_equal(
        jax_ckpt._assemble_blob(0, hist[0].shape, slabs), hist[0])
    _mc_pair(tmp_path, solver, "r2", "-snapshot", str(state), env=zero)
    _mc_one(tmp_path, solver, "r1", "-mesh", "2", "-snapshot", str(state),
            env=zero)
    assert _model(tmp_path / "r2" / "final.caffemodel") == \
        _model(tmp_path / "r1" / "final.caffemodel")


def test_sidecars_of_a_split_state_read_by_jax(tmp_path):
    """The sidecar writer on its own: two processes' halves of an Adam
    state (history and history2, ZeRO-1 Shards over dp 4, two ranks a
    process), written by `snapshot(..., write_main=)` as rank 0 and rank
    1 would, read back whole by the port and the JAX package."""
    s = Solver(SolverParameter.from_text("base_lr: 0.1 type: 'ADAM'"),
               NetParameter.from_text(NET), device="cpu")
    params = s.train_net.init(3)
    rng = np.random.RandomState(0)
    whole = {key: {ln: {bn: rng.rand(*t.shape).astype(np.float32)
                        for bn, t in bl.items()}
                   for ln, bl in params.items()}
             for key in ("history", "history2")}

    def state(proc):
        trees = {}
        for key, tree in whole.items():
            trees[key] = {}
            for ln, bl in tree.items():
                trees[key][ln] = {}
                for bn, a in bl.items():
                    t = torch.from_numpy(a)
                    if ln == "fc_big" and bn == "weight":
                        blocks = list(torch.chunk(t, 4, dim=1))
                        t = Shards(blocks[2 * proc:2 * proc + 2], 1,
                                   first=2 * proc, parts=4)
                    trees[key][ln][bn] = t
        return OptState(iter=7, history=trees["history"],
                        history2=trees["history2"])

    prefix = str(tmp_path / "snap")
    checkpoint.snapshot(s.train_net, params, state(1), prefix,
                        solver_type="ADAM", write_main=False)
    m, path = checkpoint.snapshot(s.train_net, params, state(0), prefix,
                                  solver_type="ADAM")
    assert sorted(os.listdir(tmp_path)) == [
        "snap_iter_7.caffemodel", "snap_iter_7.solverstate",
        "snap_iter_7.solverstate.shard0", "snap_iter_7.solverstate.shard1"]
    it, _, hist = checkpoint._read_state(path)
    order = [(ln, bn) for ln, specs in s.train_net.param_layout.items()
             for bn, _, _ in specs]
    want = [whole[key][ln][bn] for key in ("history", "history2")
            for ln, bn in order]
    assert it == 7 and len(hist) == len(want)
    for h, w in zip(hist, want):
        np.testing.assert_array_equal(h, w)
    slabs = jax_ckpt._load_state_shards(path)
    i = next(j for j, (ln, bn) in enumerate(order)
             if (ln, bn) == ("fc_big", "weight"))
    for base, key in ((0, "history"), (len(order), "history2")):
        np.testing.assert_array_equal(jax_ckpt._assemble_blob(
            base + i, whole[key]["fc_big"]["weight"].shape, slabs),
            whole[key]["fc_big"]["weight"])
    assert len(slabs) == 8     # 2 blobs x 2 processes x 2 ranks


# ---------------------------------------------------------------------------
# the CLI's -clusterSize N -rank r (the JAX package's local engine)
# ---------------------------------------------------------------------------

def _trained(monkeypatch, main, processor, argv):
    """Train through a CLI's main; the processor's final params as
    numpy, taken when main stops it, or after (rank 1 writes no
    file).  A processor an earlier test of the worker left behind,
    which main stops first, is not this run's."""
    seen = {}
    real = processor.CaffeProcessor.stop
    earlier = processor.CaffeProcessor._instance

    def stop(self):
        if self is not earlier:
            seen["params"] = self.params
        return real(self)

    monkeypatch.setattr(processor.CaffeProcessor, "stop", stop)
    assert main(argv) == 0
    monkeypatch.setattr(processor.CaffeProcessor, "stop", real)
    if "params" not in seen:        # a main that leaves it running
        seen["params"] = processor.CaffeProcessor._instance.params
    return {ln: {bn: np.asarray(jax.device_get(t)) if not
                 isinstance(t, torch.Tensor) else t.numpy()
                 for bn, t in bl.items()}
            for ln, bl in seen["params"].items()}


def test_cli_cluster_size_rank_matches_jax_cli(tmp_path, monkeypatch):
    """`-clusterSize 2 -rank 1` through both CLIs from one -weights file
    (neither machine has pyspark: the local engine): shard 1 of the
    LMDB, its crops and mirrors seeded by rank 1, no exchange (the net
    has no Dropout: the two packages draw its masks from other
    generators), and, as rank 1 of the JAX package's, no file written.
    The final params agree, and they are not rank 0's."""
    from caffeonspark_tpu import processor as jax_processor
    from caffeonspark_tpu_torch import processor
    solver = _lmdb_config(tmp_path, max_iter=4, dropout=False)
    s = Solver(SolverParameter.from_text("base_lr: 0.1"),
               NetParameter.from_text((tmp_path / "net.prototxt")
                                      .read_text()), device="cpu")
    init = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(init, s.train_net, s.train_net.init(21))
    argv = ["-conf", solver, "-train", "-weights", init, "-clusterSize",
            "2", "-rank"]
    got = _trained(monkeypatch, caffe_on_spark.main, processor, argv + [
        "1", "-output", str(tmp_path / "t1"), "-device", "cpu"])
    rank0 = _trained(monkeypatch, caffe_on_spark.main, processor, argv + [
        "0", "-output", str(tmp_path / "t0"), "-device", "cpu"])
    want = _trained(monkeypatch, jax_cos.main, jax_processor, argv + [
        "1", "-output", str(tmp_path / "j"), "-devices", "1"])
    assert not (tmp_path / "t1").exists() and not (tmp_path / "j").exists()
    assert (tmp_path / "t0" / "model.caffemodel").exists()
    for ln in want:
        for bn in want[ln]:
            np.testing.assert_allclose(got[ln][bn], want[ln][bn], rtol=1e-4,
                                       atol=1e-7, err_msg=f"{ln}/{bn}")
    assert not np.allclose(got["ip"]["weight"], rank0["ip"]["weight"])
