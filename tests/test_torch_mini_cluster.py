"""The PyTorch port's standalone trainer (`mini_cluster`) against the JAX
package's, on the CPU.

The net is tests/test_steploop.py's E2E_NET (an LMDB-fed MemoryData net
with a source_class, a TEST layer and an Accuracy), its solver with
`display: 1` so that `-metrics` logs every step; both CLIs start from
one `-weights` .caffemodel.

  * float32: per-step losses to rtol 1e-5, the final blobs to rtol 1e-4
    (atol 1e-6), validation.json to rtol 1e-5;
  * mixed and bfloat16, end to end: the same files, iterations and
    rounds; per-step losses, validation losses and final blobs within
    the tolerances of BF16_E2E.  This small net is chaotic in bf16: one
    bf16 ulp of difference at step 1 (the frameworks round at other
    points) flips a ReLU a few steps later, so the two runs part by far
    more than the per-step rounding (measured over the 24 steps: losses
    0.8 % mixed, 3 % bfloat16; ip1's weights 7 % / 53 % of their
    movement).  Hence also:
  * mixed and bfloat16, step by step: every step the port's CLI takes
    against the JAX solver's step from the same params, history and
    batch (the port's, before the step): losses to one bf16 ulp, params
    to two bf16 ulps of the blob's largest element (bfloat16) or, with
    f32 master weights (mixed), to 2^-5 of the step's largest update
    (the bf16 backward rounds at other points in the two frameworks:
    about 0.5 % of a gradient element, measured);
  * the reference's own defect under -dtype bfloat16: its
    `checkpoint.copy_layers` keeps the -weights blobs in f32, so its
    "bfloat16" run from -weights trains f32 params (ROADMAP Queue 3);
    the end-to-end comparison casts them to the net's dtype, as the port
    does, and a test pins the port's bf16 params;
  * the LM (transformer_lm vocab 16, T 128) in mixed through both CLIs
    (the JAX one with COS_FLASH_INTERPRET=1 and -devices 1), and the
    port's with -mesh 1,1,4 against its run without;
  * a -snapshot resume equal to the uninterrupted run, SIGHUP
    snapshots, SIGINT stops with a resumable snapshot (signals sent by
    the step itself: no timing), the handlers restored afterwards;
  * PipelinedFeed batches equal to the JAX package's over two shuffled
    epochs; the flusher writes metrics.json; the default -device cuda
    refuses on a machine without a card.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu import mini_cluster as jax_mc
from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.data.queue_runner import PipelinedFeed as JaxFeed
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import checkpoint, mini_cluster
from caffeonspark_tpu_torch.data import get_source
from caffeonspark_tpu_torch.data.queue_runner import PipelinedFeed
from caffeonspark_tpu_torch.metrics import (MetricsFlusher,
                                            PipelineMetrics)
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.solver import Solver
from test_steploop import E2E_NET, E2E_SOLVER, _write_lmdb
from torch_common import cap_torch_threads

cap_torch_threads()

BF16 = torch.bfloat16
# (per-step loss, validation loss: relative; final blobs: of the blob's
# largest movement from -weights)
BF16_E2E = {"mixed": (2.0 ** -6, 2.0 ** -5, 0.15),
            "bfloat16": (2.0 ** -4, 2.0 ** -4, 0.6)}


@pytest.fixture()
def e2e(tmp_path):
    _write_lmdb(tmp_path / "train_lmdb", 64, seed=5)
    _write_lmdb(tmp_path / "test_lmdb", 16, seed=99)
    net = tmp_path / "net.prototxt"
    net.write_text(E2E_NET.format(train=tmp_path / "train_lmdb",
                                  test=tmp_path / "test_lmdb"))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(E2E_SOLVER.format(net=net).replace("display: 0",
                                                         "display: 1"))
    ts = Solver(SolverParameter.from_text(solver.read_text()),
                NetParameter.from_text(net.read_text()), device="cpu")
    weights = tmp_path / "init.caffemodel"
    checkpoint.save_caffemodel(str(weights), ts.train_net,
                               ts.train_net.init(3))
    return tmp_path, str(solver), str(weights)


def _argv(tmp, solver, weights, out, dtype, extra=()):
    os.makedirs(tmp / out, exist_ok=True)
    return ["-solver", solver, "-weights", weights, "-dtype", dtype,
            "-output", str(tmp / out), "-metrics", str(tmp / out / "m.jsonl"),
            "-model", str(tmp / out / "final.caffemodel"), *extra]


def _jax_cast_weights(monkeypatch):
    """The reference's -weights under -dtype bfloat16 keeps f32 blobs
    (its copy_layers never casts); cast them to the net's dtype."""
    real = jax_ckpt.copy_layers

    def copy_layers(net, params, path, **kw):
        out = real(net, params, path, **kw)
        return {ln: {bn: v.astype(net.dtype) for bn, v in bl.items()}
                for ln, bl in out.items()}

    monkeypatch.setattr(jax_ckpt, "copy_layers", copy_layers)


def _run_both(e2e, dtype, monkeypatch, extra=()):
    tmp, solver, weights = e2e
    assert mini_cluster.main(_argv(tmp, solver, weights, "t", dtype,
                                   ["-device", "cpu", *extra])) == 0
    if dtype == "bfloat16":
        _jax_cast_weights(monkeypatch)
    # one device: the test harness's 8 virtual CPUs would shard batch 8
    assert jax_mc.main(_argv(tmp, solver, weights, "j", dtype,
                             ["-devices", "1", *extra])) == 0
    return tmp / "t", tmp / "j"


def _jsonl(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


@pytest.mark.parametrize("dtype", ["float32", "mixed", "bfloat16"])
def test_mini_cluster_matches_jax(dtype, e2e, monkeypatch):
    t, j = _run_both(e2e, dtype, monkeypatch)
    assert sorted(os.listdir(t)) == sorted(os.listdir(j)) == [
        "final.caffemodel", "m.jsonl", "steploop_iter_16.caffemodel",
        "steploop_iter_16.solverstate", "validation.json"]
    mt, mj = _jsonl(t / "m.jsonl"), _jsonl(j / "m.jsonl")
    assert [r["iter"] for r in mt] == [r["iter"] for r in mj] \
        == list(range(1, 25))
    np.testing.assert_allclose([r["lr"] for r in mt],
                               [r["lr"] for r in mj], rtol=1e-7)
    lt = np.array([r["loss"] for r in mt])
    lj = np.array([r["loss"] for r in mj])
    vt, vj = _jsonl(t / "validation.json"), _jsonl(j / "validation.json")
    assert len(vt) == len(vj) == 2
    assert all(sorted(r) == ["accuracy", "loss"] for r in vt)
    bt = checkpoint.load_caffemodel_blobs(str(t / "final.caffemodel"))
    bj = jax_ckpt.load_caffemodel_blobs(str(j / "final.caffemodel"))
    b0 = checkpoint.load_caffemodel_blobs(e2e[2])
    assert set(bt) == set(bj) == {"ip1", "ip2"}
    if dtype == "float32":
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        for a, b in zip(vt, vj):
            for k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6)
        for ln in bj:
            for a, b in zip(bt[ln], bj[ln]):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        return
    loss_tol, val_tol, blob_tol = BF16_E2E[dtype]
    assert np.all(np.abs(lt - lj) <= loss_tol * np.abs(lj)), (lt, lj)
    for a, b in zip(vt, vj):
        assert abs(a["loss"] - b["loss"]) <= val_tol * abs(b["loss"])
    for ln in bj:
        for a, b, w0 in zip(bt[ln], bj[ln], b0[ln]):
            move = float(np.abs(b - w0).max())
            assert float(np.abs(a - b).max()) <= blob_tol * move, ln


@pytest.mark.parametrize("dtype", ["mixed", "bfloat16"])
def test_mini_cluster_steps_match_jax_step_by_step(dtype, e2e):
    """Each step of the port's CLI against the JAX solver's step from
    the same params, history and batch."""
    tmp, solver, weights = e2e
    args = mini_cluster.build_argparser().parse_args(
        _argv(tmp, solver, weights, "t", dtype,
              ["-device", "cpu", "-iterations", "12"]))
    mc = mini_cluster.MiniCluster(args)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    js = JaxSolver(JaxSolverParameter.from_text(open(solver).read()),
                   JaxNetParameter.from_text(mc.net_param.to_text()),
                   dtype=jdt,
                   compute_dtype=jnp.bfloat16 if dtype == "mixed" else None)
    jstep = jax.jit(js.train_step_fn())
    real = mc.solver.train_step
    seen = []

    def to_jax(tree):
        return {ln: {bn: jnp.array(np.array(t.float().numpy())).astype(jdt)
                     for bn, t in bl.items()} for ln, bl in tree.items()}

    def step(params, state, inputs):
        before = (to_jax(params), to_jax(state.history), state.iter)
        loss, out = real(params, state, inputs)
        jp, jh, it = before
        from caffeonspark_tpu.solver import OptState as JaxOptState
        jst = JaxOptState(iter=jnp.asarray(it, jnp.int32), history=jh,
                          history2=jax.tree_util.tree_map(jnp.zeros_like,
                                                          jh))
        jb = {k: jnp.array(np.array(v.float().numpy())).astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
            for k, v in inputs.items()}
        jp2, _, jout = jstep(jp, jst, jb, js.step_rng(it))
        seen.append((float(loss), float(jout["loss"])))
        for ln, bl in params.items():
            for bn, w in bl.items():
                want = np.asarray(jp2[ln][bn].astype(jnp.float32))
                if dtype == "bfloat16":
                    tol = 2.0 ** -7 * float(np.abs(want).max())
                else:
                    moved = want - np.asarray(jp[ln][bn])
                    tol = 2.0 ** -5 * float(np.abs(moved).max())
                got = w.float().numpy()
                assert float(np.abs(got - want).max()) <= tol, \
                    (it, ln, bn, float(np.abs(got - want).max()), tol)
        return loss, out

    mc.solver.train_step = step
    mc.train()
    assert len(seen) == 12
    for lt, lj in seen:
        assert abs(lt - lj) <= 2.0 ** -7 * abs(lj)


def test_bfloat16_weights_are_bf16_params(e2e):
    tmp, solver, weights = e2e
    args = mini_cluster.build_argparser().parse_args(
        _argv(tmp, solver, weights, "t", "bfloat16",
              ["-device", "cpu", "-iterations", "1"]))
    mc = mini_cluster.MiniCluster(args)
    mc.train()
    init = checkpoint.load_caffemodel_blobs(weights)
    for ln, bl in mc.final_params.items():
        for bn, w in bl.items():
            assert w.dtype == BF16
            assert mc.final_state.history[ln][bn].dtype == BF16
    # the first step starts from the bf16 rounding of -weights
    mc2 = mini_cluster.MiniCluster(args)
    p, _ = mc2.solver.init()
    p = checkpoint.copy_layers(mc2.solver.train_net, p, weights)
    assert torch.equal(p["ip1"]["weight"],
                       torch.from_numpy(init["ip1"][0]).to(BF16))


# ---------------------------------------------------------------------------
# the LM in mixed precision
# ---------------------------------------------------------------------------

LM = dict(vocab=16, d_model=32, heads=2, layers=1, seq=128, batch=4)
SGD = ('type: "SGD" base_lr: 0.1 momentum: 0.9 lr_policy: "fixed" '
       'random_seed: 1 display: 1')


def test_mini_cluster_lm_mixed_matches_jax(tmp_path, monkeypatch):
    """transformer_lm(vocab 16, T 128) in mixed through both CLIs from
    one -weights, 4 SGD steps across an epoch boundary: losses to 2^-6
    relative (a bf16 loss blob, one ulp and a half), the final blobs to
    2^-4 of their largest movement from -weights (bf16 gradients, the
    frameworks rounding at other points)."""
    rng = np.random.RandomState(9)
    rows = tmp_path / "rows.json"
    with open(rows, "w") as f:
        for _ in range(12):
            toks = rng.randint(0, LM["vocab"], LM["seq"] + 1).tolist()
            f.write(json.dumps({"input_sentence": toks[:-1],
                                "target_sentence": toks[1:]}) + "\n")
    npm = zoo.transformer_lm(**LM)
    npm.layer[0].cos_data_param.source = str(rows)
    npm.layer[0].cos_data_param.dataframe_format = "json"
    npm.layer[0].source_class = "com.yahoo.ml.caffe.DataFrameSource"
    net = tmp_path / "net.prototxt"
    net.write_text(npm.to_text())
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\n{SGD}\nmax_iter: 4\n'
                      'snapshot_prefix: "lm"\n')
    ts = Solver(SolverParameter.from_text(SGD), npm, device="cpu")
    weights = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(weights, ts.train_net, ts.train_net.init(21))
    assert mini_cluster.main(_argv(tmp_path, str(solver), weights, "t",
                                   "mixed", ["-device", "cpu"])) == 0
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    assert jax_mc.main(_argv(tmp_path, str(solver), weights, "j", "mixed",
                             ["-devices", "1"])) == 0
    lt = [r["loss"] for r in _jsonl(tmp_path / "t" / "m.jsonl")]
    lj = [r["loss"] for r in _jsonl(tmp_path / "j" / "m.jsonl")]
    assert len(lt) == len(lj) == 4
    np.testing.assert_allclose(lt, lj, rtol=2.0 ** -6)
    bt = checkpoint.load_caffemodel_blobs(
        str(tmp_path / "t" / "final.caffemodel"))
    bj = jax_ckpt.load_caffemodel_blobs(
        str(tmp_path / "j" / "final.caffemodel"))
    b0 = checkpoint.load_caffemodel_blobs(weights)
    for ln in bj:
        for a, b, w0 in zip(bt[ln], bj[ln], b0[ln]):
            assert float(np.abs(a - b).max()) <= \
                2.0 ** -4 * float(np.abs(b - w0).max()), ln
    # -mesh 1,1,4: every MultiHeadAttention the ring (K9's plain version
    # with its f32 carry here), the same run to one bf16 ulp a loss
    assert mini_cluster.main(_argv(tmp_path, str(solver), weights, "sp",
                                   "mixed", ["-device", "cpu", "-mesh",
                                             "1,1,4"])) == 0
    ls = [r["loss"] for r in _jsonl(tmp_path / "sp" / "m.jsonl")]
    np.testing.assert_allclose(ls, lt, rtol=2.0 ** -7)


# ---------------------------------------------------------------------------
# snapshots and signals
# ---------------------------------------------------------------------------

@pytest.fixture()
def one_batch(tmp_path):
    """E2E_NET on an LMDB of one batch (8 records): every step sees the
    same records, so a resumed run (whose source restarts at epoch 0)
    feeds what the uninterrupted one feeds, in another order."""
    _write_lmdb(tmp_path / "train_lmdb", 8, seed=5)
    _write_lmdb(tmp_path / "test_lmdb", 16, seed=99)
    net = tmp_path / "net.prototxt"
    net.write_text(E2E_NET.format(train=tmp_path / "train_lmdb",
                                  test=tmp_path / "test_lmdb"))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(E2E_SOLVER.format(net=net).replace(
        "snapshot: 16", "snapshot: 10"))
    return tmp_path, str(solver)


def _train(solver, out, extra=(), step_hook=None):
    args = mini_cluster.build_argparser().parse_args(
        ["-solver", solver, "-output", str(out), "-device", "cpu",
         *extra])
    mc = mini_cluster.MiniCluster(args)
    if step_hook is not None:
        real = mc.solver.train_step

        def step(params, state, inputs):
            res = real(params, state, inputs)
            step_hook(state.iter)
            return res

        mc.solver.train_step = step
    model = mc.train()
    return mc, model


def _assert_close_state(a, b):
    for ln, bl in a.final_params.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(w.numpy(),
                                       b.final_params[ln][bn].numpy(),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(
                a.final_state.history[ln][bn].numpy(),
                b.final_state.history[ln][bn].numpy(), rtol=1e-5,
                atol=1e-7)


def test_snapshot_resume_equals_uninterrupted(one_batch):
    """24 steps straight against 10 steps (snapshot at 10) and a resume
    from that snapshot to 24: params and history to rtol 1e-5 (the batch
    sums its records in another order)."""
    tmp, solver = one_batch
    full, _ = _train(solver, tmp / "full")
    _train(solver, tmp / "part", ["-iterations", "10"])
    state = tmp / "part" / "steploop_iter_10.solverstate"
    assert state.exists()
    resumed, _ = _train(solver, tmp / "resumed", ["-snapshot", str(state)])
    assert resumed.final_state.iter == full.final_state.iter == 24
    _assert_close_state(resumed, full)


def test_sighup_snapshots_and_sigint_stops_resumably(one_batch, capsys):
    tmp, solver = one_batch
    before = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                signal.SIGTERM,
                                                signal.SIGHUP)}

    def hook(it):
        if it == 3:
            os.kill(os.getpid(), signal.SIGHUP)
        if it == 6:
            os.kill(os.getpid(), signal.SIGINT)

    mc, model = _train(solver, tmp / "sig", step_hook=hook)
    out = capsys.readouterr()
    assert mc.final_state.iter == 6
    assert "SIGHUP → snapshot" in out.err and "SIGINT → stop" in out.err
    for it in (3, 6):
        for ext in ("caffemodel", "solverstate"):
            assert (tmp / "sig" / f"steploop_iter_{it}.{ext}").exists()
    state = tmp / "sig" / "steploop_iter_6.solverstate"
    assert f"stopped at iter 6; resume with -snapshot {state}" in out.out
    assert os.path.exists(model)
    assert {s: signal.getsignal(s) for s in before} == before
    resumed, _ = _train(solver, tmp / "res", ["-snapshot", str(state)])
    full, _ = _train(solver, tmp / "full")
    assert resumed.final_state.iter == 24
    _assert_close_state(resumed, full)


# ---------------------------------------------------------------------------
# ingest, flusher, device
# ---------------------------------------------------------------------------

def test_pipelined_feed_matches_jax_over_two_shuffled_epochs(e2e):
    """16 batches (two shuffled epochs of 64 records) from the port's
    PipelinedFeed, the JAX package's, and the port's inline
    DataSource.batches: equal arrays."""
    tmp, solver, _ = e2e
    net_text = (tmp / "net.prototxt").read_text()
    tl = NetParameter.from_text(net_text).layer[0]
    jl = JaxNetParameter.from_text(net_text).layer[0]
    src = get_source(tl, phase_train=True, seed=42)
    feed = PipelinedFeed(src, num_threads=3)
    jfeed = JaxFeed(jax_get_source(jl, phase_train=True, seed=42),
                    num_threads=2)
    inline = get_source(tl, phase_train=True, seed=42).batches()
    try:
        got = [b for _, b in zip(range(16), feed)]
        want = [b for _, b in zip(range(16), jfeed)]
        ref = [b for _, b in zip(range(16), inline)]
    finally:
        feed.close()
        jfeed.close()
    assert len(got) == len(want) == 16
    for g, w, r in zip(got, want, ref):
        assert sorted(g) == sorted(w) == ["data", "label"]
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
            np.testing.assert_array_equal(r[k], g[k])
    # two epochs of 64 distinct records, each once per epoch
    for e in range(2):
        labels = np.concatenate([b["label"] for b in got[8 * e:8 * e + 8]])
        assert labels.shape == (64,)


def test_flusher_writes_metrics_json(tmp_path, monkeypatch, e2e):
    m = PipelineMetrics()
    m.add("step", 0.25)
    path = tmp_path / "f" / "metrics.json"
    fl = MetricsFlusher(m, str(path), 0.05).start()
    try:
        fl._stop.wait(0.2)       # a few periods; the content is checked
    finally:
        fl.stop()
    assert fl.flushes >= 1 and fl.errors == 0
    doc = json.loads(path.read_text())
    assert doc["stages"]["step"]["count"] == 1
    assert not [p for p in os.listdir(path.parent) if ".tmp." in p]
    # through mini_cluster: <output>/metrics.json after the run
    tmp, solver, weights = e2e
    monkeypatch.setenv("COS_METRICS_FLUSH_S", "30")
    assert mini_cluster.main(_argv(tmp, solver, weights, "fl", "float32",
                                   ["-device", "cpu", "-iterations",
                                    "3"])) == 0
    doc = json.loads((tmp / "fl" / "metrics.json").read_text())
    assert doc["steps"] == 3 and doc["stages"]["step"]["count"] == 3
    # and through caffe_on_spark -train (the processor's flusher)
    from caffeonspark_tpu_torch import caffe_on_spark
    assert caffe_on_spark.main(["-conf", solver, "-train", "-weights",
                                weights, "-output", str(tmp / "cos"),
                                "-device", "cpu"]) == 0
    doc = json.loads((tmp / "cos" / "metrics.json").read_text())
    assert doc["steps"] == 24 and doc["info"]["train"]["iter"][-1] == 24


def test_profile_writes_a_chrome_trace(e2e):
    tmp, solver, weights = e2e
    assert mini_cluster.main(_argv(tmp, solver, weights, "p", "float32",
                                   ["-device", "cpu", "-iterations", "2",
                                    "-profile", str(tmp / "trace")])) == 0
    doc = json.loads((tmp / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_default_device_is_cuda_and_refuses_without_a_card(e2e):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default -device runs there")
    tmp, solver, weights = e2e
    with pytest.raises(RuntimeError, match="-device cuda"):
        mini_cluster.main(["-solver", solver, "-output", str(tmp / "d")])
    assert not (tmp / "d").exists()
    assert mini_cluster.build_argparser().parse_args(
        ["-solver", solver]).device == "cuda"
