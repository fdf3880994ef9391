"""tp and sp axes across processes in the PyTorch port: one global mesh
of which each process holds its box (`parallel.mesh.process_box`),
against the JAX package and against the port's own one process.

Each test starts its processes on 127.0.0.1 at a free port
(`tests/torch_multiproc_child.py`, torch on one thread each, the
one-process reference in a child too: CPU sums depend on threads),
waits with a timeout and asserts values only, no timing:
  * the sp ring across 2 processes (`comm.shift_line` for the hop)
    against single-device attention: forward within 1e-4, the grads of
    q, k and v within 1e-3 (the JAX package's test_multihost limits),
    for the einsum ring and the fused ring's plain versions;
  * tp 2 across 2 processes on test_multihost's tiny net (an
    InnerProduct of 1024 outputs): against the JAX package's tp 2 on its
    virtual CPU devices, jitted (loss rel 2e-4, weights rtol 2e-3 /
    atol 2e-5), and byte-equal to the port's one-process -mesh 1,2;
    each process holds half of the split blob;
  * sp 2 across 2 processes on a tiny transformer_lm against the JAX
    package's sp 2 (the same limits) and byte-equal to one process's
    -mesh 1,1,2;
  * 4 processes at -mesh 2,2 (dp lines {0, 1}, {2, 3}; tp lines {0, 2},
    {1, 3}) byte-equal to one process's -mesh 2,2;
  * `mini_cluster -cluster 2 -mesh 1,2` on an LMDB: both processes feed
    the same records, each writes its `.shard<rank>` sidecar of the tp
    blocks' momentum, which the JAX package's `_load_state_shards`
    reads into the arrays the port reads, rank 0's model equals one
    process's -mesh 1,2, and a one-process resume from the sharded
    snapshot runs;
  * validation at -cluster 2 -mesh 1,2: rank 0 alone writes the rows,
    equal to one process's.
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

from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.parallel import ParallelSolver as JaxParallelSolver
from caffeonspark_tpu.parallel import build_mesh as jax_build_mesh
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import checkpoint, convert
from caffeonspark_tpu_torch.data import LmdbWriter
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.parallel.mesh import (Mesh, dp_data_rank,
                                                  mesh_dims, process_box)
from caffeonspark_tpu_torch.parallel.sp import attention
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.proto.caffe import Datum
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "torch_multiproc_child.py")
WAIT_S = 300
LOSS_REL = 2e-4
W_RTOL, W_ATOL = 2e-3, 2e-5

# test_multihost.py's tensor-parallel net (an InnerProduct of 1024
# outputs, which tp splits by column), at a global batch of 8
TP_LAYERS = """
layer { name: "fc_big" type: "InnerProduct" bottom: "data" top: "fc_big"
  inner_product_param { num_output: 1024
    weight_filler { type: "xavier" } } }
layer { name: "r" type: "ReLU" bottom: "fc_big" top: "fc_big" }
layer { name: "ip" type: "InnerProduct" bottom: "fc_big" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
"""
TP_NET = """name: "tp"
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 1 height: 28 width: 28 } }
""" + TP_LAYERS
SGD = ('base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\nmax_iter: 20\n'
       'random_seed: 7\n')
ADAM = ("base_lr: 0.01 momentum: 0.9 lr_policy: 'fixed' type: 'ADAM' "
        "random_seed: 5")
LM = dict(vocab=12, d_model=64, heads=4, layers=1, seq=64, batch=4)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env():
    out = {k: v for k, v in os.environ.items() if not k.startswith("COS_")}
    out["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    out["OMP_NUM_THREADS"] = "1"
    return out


def _spawn(argvs, cwd):
    """One child per argv, each waited for (WAIT_S); a child that fails
    fails the test with its output."""
    procs = [subprocess.Popen([sys.executable, CHILD, *argv], cwd=str(cwd),
                              env=_child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT_S)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _specs(tmp_path, mode, procs, tag, **spec):
    """Write one spec a process and run `mode` in each."""
    port = _free_port()
    argvs = []
    for r in range(procs):
        path = tmp_path / f"{tag}{r}.json"
        path.write_text(json.dumps(dict(
            spec, server=f"127.0.0.1:{port}" if procs > 1 else None,
            procs=procs, rank=r, out=str(tmp_path / tag))))
        argvs.append([mode, str(path)])
    _spawn(argvs, tmp_path)
    return [np.load(tmp_path / f"{tag}.rank{r}.npz") for r in range(procs)]


# ---------------------------------------------------------------------------
# the ring across processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "fused"])
def test_ring_across_two_processes(tmp_path, flash):
    """sp 2 spanning two processes, causal, against single-device
    attention on the whole sequence (b, h, t, d = 2, 2, 32, 16)."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 2, 32, 16).astype(np.float32) for _ in range(3))
    g = rng.randn(2, 2, 32, 16).astype(np.float32)
    np.savez(tmp_path / "qkv.npz", q=q, k=k, v=v, g=g)
    got = _specs(tmp_path, "ring", 2, "ring", sp=2, causal=True,
                 flash=flash, qkv=str(tmp_path / "qkv.npz"))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = attention(tq, tk, tv, causal=True)
    torch.sum(ref * torch.from_numpy(g)).backward()
    for r in got:
        assert np.abs(r["out"] - ref.detach().numpy()).max() < 1e-4
        for name, t in (("dq", tq), ("dk", tk), ("dv", tv)):
            assert np.abs(r[name] - t.grad.numpy()).max() < 1e-3, name
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_array_equal(got[0][name], got[1][name])


# ---------------------------------------------------------------------------
# ParallelSolver steps on a global mesh
# ---------------------------------------------------------------------------

def _tp_batches(n=3):
    rng = np.random.RandomState(9)
    return [{"data": rng.rand(8, 1, 28, 28).astype(np.float32),
             "label": rng.randint(0, 10, 8).astype(np.float32)}
            for _ in range(n)]


def _lm_batches(n=3):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        seqs = rng.randint(0, 10, (LM["seq"], LM["batch"])).astype(
            np.float32)
        out.append({"input_sentence": seqs,
                    "target_sentence": (seqs + 1) % 10})
    return out


def _mesh_run(tmp_path, net, solver, batches, dims, procs, tag,
              seed=5):
    """The `mesh` child in `procs` processes from the seeded params:
    every process's result (losses, the params gathered whole, its
    bytes of the split blobs), which must agree bit for bit."""
    s = Solver(SolverParameter.from_text(solver),
               NetParameter.from_text(net), device="cpu")
    arrays = convert.params_to_numpy(s.train_net.init(seed))
    np.savez(tmp_path / "params.npz", **{f"{ln}/{bn}": a for ln, bl in
                                        arrays.items()
                                        for bn, a in bl.items()})
    np.savez(tmp_path / "batches.npz", **{f"{i}/{n}": v for i, b in
                                         enumerate(batches)
                                         for n, v in b.items()})
    got = _specs(tmp_path, "mesh", procs, tag, dims=dims, net=net,
                 solver=solver, params=str(tmp_path / "params.npz"),
                 batches=str(tmp_path / "batches.npz"))
    for key in got[0].files:
        if key.startswith("param/") or key == "losses":
            for other in got[1:]:
                np.testing.assert_array_equal(got[0][key], other[key],
                                              err_msg=key)
    return got, arrays


def _params(res):
    out = {}
    for key in res.files:
        if key.startswith("param/"):
            _, ln, bn = key.split("/")
            out.setdefault(ln, {})[bn] = res[key]
    return out


def _jax_run(net, solver, arrays, batches, mesh_kw):
    """The JAX ParallelSolver's steps (jitted) on its virtual devices."""
    js = JaxSolver(JaxSolverParameter.from_text(solver),
                   JaxNetParameter.from_text(net))
    n = int(np.prod(list(mesh_kw.values())))
    ps = JaxParallelSolver(js, jax_build_mesh(devices=jax.devices()[:n],
                                              **mesh_kw))
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


def _close(got, want):
    for ln, bl in want.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(got[ln][bn], w, rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=f"{ln}/{bn}")


def _equal(a, b):
    for ln, bl in b.items():
        for bn, w in bl.items():
            np.testing.assert_array_equal(a[ln][bn], w, err_msg=f"{ln}/{bn}")


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clip"])
def test_tp2_across_processes_matches_jax_and_one_process(tmp_path, clip):
    """tp 2 spanning two processes, 3 steps: against the JAX package's
    tp 2 and byte-equal to one process's -mesh 1,2; fc_big's weight and
    bias are half in each process.  Under clip_gradients the global
    norm sums each process's half of fc_big over the tp line (its
    squares associated otherwise: within rtol 1e-5 of one process)."""
    batches = _tp_batches()
    dims = {"dp": 1, "tp": 2}
    solver = SGD + ("clip_gradients: 0.1\n" if clip else "")
    two, arrays = _mesh_run(tmp_path, TP_NET, solver, batches, dims, 2,
                            "two")
    one, _ = _mesh_run(tmp_path, TP_NET, solver, batches, dims, 1, "one")
    if clip:
        np.testing.assert_allclose(two[0]["losses"], one[0]["losses"],
                                   rtol=1e-5)
        for ln, bl in _params(one[0]).items():
            for bn, w in bl.items():
                np.testing.assert_allclose(_params(two[0])[ln][bn], w,
                                           rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(two[0]["losses"], one[0]["losses"])
        _equal(_params(two[0]), _params(one[0]))
    whole = (1024 * 784 + 1024) * 4
    assert [int(r["split_bytes"]) for r in two] == [whole // 2] * 2
    assert [int(r["state_bytes"]) for r in two] == [whole // 2] * 2
    assert int(one[0]["split_bytes"]) == 0     # one process holds it whole
    traffic = [json.loads(str(r["traffic"])) for r in two]
    assert all(t["tp"] > 0 and t["dp"] == 0 for t in traffic)
    want, wp = _jax_run(TP_NET, solver, arrays, batches, dims)
    np.testing.assert_allclose(two[0]["losses"], want, rtol=LOSS_REL)
    _close(_params(two[0]), wp)


def test_sp2_lm_across_processes_matches_jax_and_one_process(
        tmp_path, monkeypatch):
    """A tiny transformer_lm (d_model 64, 4 heads x 16, T 64, 1 layer)
    at sp 2 spanning two processes, 3 Adam steps: the fused ring's plain
    versions with the hop across processes, against the JAX package's sp
    2 (its Pallas kernels in interpret mode) and byte-equal to one
    process's -mesh 1,1,2."""
    text = zoo.transformer_lm(**LM).to_text()
    batches = _lm_batches()
    dims = {"dp": 1, "tp": 1, "sp": 2}
    two, arrays = _mesh_run(tmp_path, text, ADAM, batches, dims, 2, "two")
    one, _ = _mesh_run(tmp_path, text, ADAM, batches, dims, 1, "one")
    np.testing.assert_array_equal(two[0]["losses"], one[0]["losses"])
    _equal(_params(two[0]), _params(one[0]))
    traffic = [json.loads(str(r["traffic"])) for r in two]
    assert all(t["sp"] > 0 and t["tp"] == 0 for t in traffic)
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    want, wp = _jax_run(text, ADAM, arrays, batches, dims)
    np.testing.assert_allclose(two[0]["losses"], want, rtol=LOSS_REL)
    _close(_params(two[0]), wp)


@pytest.mark.parametrize("net", ["image", "lm"])
def test_four_processes_dp2_tp2_equal_one_process(tmp_path, net):
    """-mesh 2,2 over 4 processes, one rank each (dp and tp both span),
    byte-equal to one process's -mesh 2,2: the image net's fc_big split
    over tp, the LM's heads (and its logits, vocab 1024)."""
    if net == "image":
        text, solver = TP_NET, SGD
        batches = _tp_batches(2)
    else:
        text = zoo.transformer_lm(**dict(LM, vocab=1024)).to_text()
        solver, batches = ADAM, _lm_batches(2)
    dims = {"dp": 2, "tp": 2}
    four, _ = _mesh_run(tmp_path, text, solver, batches, dims, 4, "four")
    one, _ = _mesh_run(tmp_path, text, solver, batches, dims, 1, "one")
    np.testing.assert_array_equal(four[0]["losses"], one[0]["losses"])
    _equal(_params(four[0]), _params(one[0]))
    traffic = [json.loads(str(r["traffic"])) for r in four]
    assert all(t["tp"] > 0 and t["dp"] > 0 for t in traffic)


def test_process_boxes_and_data_ranks():
    """The JAX package's dp-fastest order: -mesh 2,2 over 4 processes
    puts process p at (tp, dp) = divmod(p, 2), so dp lines {0, 1}, {2, 3}
    feed blocks 0 and 1, tp peers the same block; over 2 processes each
    holds both dp ranks of its tp rank; a box the processes cannot cut
    is refused by name.  A comma -mesh over processes is the global
    mesh, as the JAX package reads it (`-cluster 2 -mesh 2,1` is dp 2,
    one rank a process; it trained dp 4 before), a bare count k dp
    ranks a process."""
    assert mesh_dims("2,1", 2) == {"dp": 2, "tp": 1}
    assert process_box(mesh_dims("2,1", 2), 2, 1)[0]["dp"] == 1
    assert mesh_dims("2", 2) == {"dp": 4}
    assert mesh_dims("1,1,2", 2) == {"dp": 1, "tp": 1, "sp": 2}
    dims = {"dp": 2, "tp": 2}
    for p in range(4):
        local, offs = process_box(dims, 4, p)
        assert (offs["tp"], offs["dp"]) == divmod(p, 2)
        assert all(n == 1 for n in local.values())
        dev = np.empty(1, dtype=object)
        dev[:] = [torch.device("cpu")]
        mesh = Mesh(dev.reshape(1, 1, 1, 1, 1), 4, p, dict(dims, pp=1, ep=1,
                                                         sp=1), offs)
        assert dp_data_rank(mesh) == (p % 2, 2)
    local, offs = process_box(dims, 2, 1)
    assert (local["dp"], local["tp"], offs["tp"]) == (2, 1, 1)
    local, offs = process_box({"dp": 1, "tp": 1, "sp": 2}, 2, 1)
    assert (local["sp"], offs["sp"]) == (1, 1)
    with pytest.raises(ValueError, match="no box of the mesh"):
        process_box({"dp": 2, "tp": 3}, 2, 0)


# ---------------------------------------------------------------------------
# mini_cluster over a tp axis across processes
# ---------------------------------------------------------------------------

def _lmdb(tmp_path, n=64, size=28):
    src = tmp_path / "lmdb"
    if not src.exists():
        rng = np.random.RandomState(9)
        LmdbWriter(str(src)).write([(b"%06d" % i, Datum(
            channels=1, height=size, width=size,
            data=rng.randint(0, 256, size * size).astype(np.uint8)
            .tobytes(), label=int(rng.randint(10))).to_binary())
            for i in range(n)])
    return src


def _mc_solver(tmp_path, extra="", test=False):
    src = _lmdb(tmp_path)
    data = ('layer {{ name: "data" type: "MemoryData" top: "data" '
            'top: "label"\n  source_class: "com.yahoo.ml.caffe.LMDB"\n'
            '  transform_param {{ scale: 0.00390625 }}\n'
            '  memory_data_param {{ source: "{src}" batch_size: {b}\n'
            '    channels: 1 height: 28 width: 28 }}{inc} }}\n')
    net = data.format(src=src, b=8, inc=' include { phase: TRAIN }'
                      if test else '')
    if test:
        net += data.format(src=src, b=4, inc=' include { phase: TEST }')
    net += TP_LAYERS
    if test:
        net += ('layer { name: "acc" type: "Accuracy" bottom: "ip" '
                'bottom: "label" top: "acc" include { phase: TEST } }\n')
    (tmp_path / "net.prototxt").write_text(net)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{tmp_path / "net.prototxt"}"\nbase_lr: 0.05\n'
                      'momentum: 0.9\nlr_policy: "fixed"\nmax_iter: 8\n'
                      'random_seed: 7\ndisplay: 1\nsnapshot_prefix: "t"\n'
                      + extra)
    return str(solver)


def _mc(tmp_path, solver, outs, *extra, procs=2):
    """mini_cluster in `procs` processes (-output outs[r] each); their
    printed outputs."""
    port = _free_port()
    argvs = []
    for r in range(procs):
        d = tmp_path / outs[r]
        d.mkdir(exist_ok=True)
        cluster = (["-server", f"127.0.0.1:{port}", "-cluster", str(procs),
                    "-rank", str(r)] if procs > 1 else [])
        argvs.append(["mini_cluster", "-solver", solver, "-device", "cpu",
                      "-output", str(d), "-model",
                      str(d / "final.caffemodel"), *cluster, *extra])
    return _spawn(argvs, tmp_path)


def _printed_losses(out):
    return [line.split("loss=")[1].split()[0] for line in out.splitlines()
            if line.startswith("iter ")]


def test_mini_cluster_tp_across_processes_sidecars_and_resume(tmp_path):
    """`mini_cluster -cluster 2 -mesh 1,2` on an LMDB, snapshots at 4
    and 8: both processes feed the same records (their printed losses
    agree), each writes `<state>.shard<rank>` with its half of fc_big's
    momentum, which the JAX package's reader assembles into the arrays
    the port's reader gives; rank 0's model is byte-equal to one
    process's -mesh 1,2; a one-process resume from the sharded snapshot
    at 4 runs to 8."""
    solver = _mc_solver(tmp_path, "snapshot: 4\n")
    outs = _mc(tmp_path, solver, ["two", "two"], "-mesh", "1,2")
    assert _printed_losses(outs[0]) == _printed_losses(outs[1])
    assert len(_printed_losses(outs[0])) == 8
    _mc(tmp_path, solver, ["one"], "-mesh", "1,2", procs=1)
    two, one = tmp_path / "two", tmp_path / "one"
    assert (two / "final.caffemodel").read_bytes() == \
        (one / "final.caffemodel").read_bytes()
    assert (two / "t_iter_4.caffemodel").read_bytes() == \
        (one / "t_iter_4.caffemodel").read_bytes()
    state = two / "t_iter_4.solverstate"
    assert sorted(p.name for p in two.iterdir() if ".shard" in p.name) == [
        f"t_iter_{i}.solverstate.shard{r}" for i in (4, 8) for r in (0, 1)]
    it, _, hist = checkpoint._read_state(str(state))
    it1, _, dense = checkpoint._read_state(str(one / "t_iter_4.solverstate"))
    assert it == it1 == 4
    for h, d in zip(hist, dense):
        np.testing.assert_array_equal(h, d)
    slabs = jax_ckpt._load_state_shards(str(state))
    assert sorted(slabs) == ["b0__0-512_0-784", "b0__512-1024_0-784",
                             "b1__0-512", "b1__512-1024"]
    for i in (0, 1):
        np.testing.assert_array_equal(
            jax_ckpt._assemble_blob(i, hist[i].shape, slabs), hist[i])
    out = _mc(tmp_path, solver, ["resume"], "-snapshot", str(state),
              procs=1)[0]
    assert "resumed from iter 4" in out and "iter 8/8" in out
    assert (tmp_path / "resume" / "final.caffemodel").exists()


def test_validation_across_processes(tmp_path):
    """Validation rounds at -cluster 2 -mesh 1,2 run in lockstep on the
    spanning mesh: rank 0 alone writes validation.json, whose rows
    equal one process's -mesh 1,2."""
    solver = _mc_solver(tmp_path, "test_interval: 4\ntest_iter: 2\n",
                        test=True)
    outs = _mc(tmp_path, solver, ["r0", "r1"], "-mesh", "1,2")
    _mc(tmp_path, solver, ["one"], "-mesh", "1,2", procs=1)
    assert not (tmp_path / "r1" / "validation.json").exists()
    got = (tmp_path / "r0" / "validation.json").read_text().splitlines()
    want = (tmp_path / "one" / "validation.json").read_text().splitlines()
    assert len(got) == 2 and got == want
    assert "validation iter 4" in outs[0]
    assert "validation iter" not in outs[1]
