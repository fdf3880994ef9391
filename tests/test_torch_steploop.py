"""The port's multi-step loop (COS_STEPS_PER_LOOP) against the JAX
package's (tests/test_steploop.py's checks, on the CPU):

  * the knob; `chunk_schedule` equal to the JAX function over a grid of
    (start, max_iter, K, boundaries), and its one log line a boundary;
    `stack_chunks` stacking and flushing as the JAX one does;
    `PipelineMetrics.add_chunk` accounting as the JAX one does;
  * `Solver.train_step_many(k)` on the CPU (k eager steps, the plain
    version of the CUDA graph) against k `train_step` calls: the
    learning rates of all 7 policies (and the JAX fused step's, rtol
    1e-6), and params / histories bit-equal with clip_gradients and
    iter_size 2 under SGD and Adam;
  * the port's mini_cluster and CLI at K=4 (and 3: single-step
    remainders) against the JAX ones at the same K from one -weights,
    at the f32 tolerances of tests/test_torch_mini_cluster.py (losses
    rtol 1e-5, blobs rtol 1e-4 / atol 1e-6, validation rtol 1e-5;
    the CLI's validation rtol 1e-4 as tests/test_torch_driver.py), and
    the port at K against itself at K=1 bit-equal; the CLI's display
    lines at their exact iterations inside chunks;
  * a resume mid-schedule equal to the K=1 stop/resume run;
  * -mesh 1,1,4 with K=2 (the ring in every step) equal to K=1.
The graph itself runs only on a card: tests/test_torch_cuda.py holds it
bit-equal to eager steps and counts its replays' launches.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu import mini_cluster as jax_mc
from caffeonspark_tpu.data import queue_runner as jax_qr
from caffeonspark_tpu.metrics import PipelineMetrics as JaxMetrics
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import caffe_on_spark, checkpoint, mini_cluster
from caffeonspark_tpu_torch.data.queue_runner import (chunk_schedule,
                                                      stack_chunks,
                                                      steps_per_loop)
from caffeonspark_tpu_torch.metrics import PipelineMetrics
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.solver import Solver
from test_steploop import (E2E_NET, E2E_SOLVER, TINY_NET, _rand_batches,
                           _write_lmdb)
from test_torch_driver import (init_model, read_json_rows,
                               write_config)
from torch_common import cap_torch_threads

cap_torch_threads()

POLICIES = [
    "lr_policy: 'fixed'",
    "lr_policy: 'step' gamma: 0.5 stepsize: 2",
    "lr_policy: 'exp' gamma: 0.9",
    "lr_policy: 'inv' gamma: 0.1 power: 0.75",
    "lr_policy: 'multistep' gamma: 0.1 stepvalue: 2 stepvalue: 5",
    "lr_policy: 'poly' power: 1.5 max_iter: 6",
    "lr_policy: 'sigmoid' gamma: 0.5 stepsize: 3",
]


# ---------------------------------------------------------------- units

def test_steps_per_loop_knob(monkeypatch):
    monkeypatch.delenv("COS_STEPS_PER_LOOP", raising=False)
    assert steps_per_loop() == jax_qr.steps_per_loop() == 1
    for value, want in (("8", 8), ("0", 1), ("-3", 1), ("nope", 1)):
        monkeypatch.setenv("COS_STEPS_PER_LOOP", value)
        assert steps_per_loop() == jax_qr.steps_per_loop() == want, value


@pytest.mark.parametrize("start,max_iter,k,bounds", [
    (0, 24, 8, (12, 16, 0)), (0, 10, 8, ()), (16, 24, 8, (12, 16)),
    (9, 24, 8, (12, 16)), (0, 5, 1, (2,)), (3, 40, 4, (10, 0, 7)),
    (0, 30, 5, (5, 15)), (7, 7, 4, (3,)), (0, 33, 6, (1000, 11)),
    (2, 19, 3, (4, 4, 9))])
def test_chunk_schedule_matches_jax(start, max_iter, k, bounds):
    got = list(chunk_schedule(start, max_iter, k, bounds))
    assert got == list(jax_qr.chunk_schedule(start, max_iter, k, bounds))
    assert sum(got) == max(0, max_iter - start)
    it = start
    for n in got:       # no chunk spans a boundary
        for b in bounds:
            if b and n > 1:
                assert it // b == (it + n - 1) // b
        it += n
    with pytest.raises(ValueError):
        list(chunk_schedule(0, 4, 0))


def test_chunk_schedule_logs_once_per_boundary(caplog):
    with caplog.at_level(
            logging.INFO, logger="caffeonspark_tpu_torch.data.queue_runner"):
        list(chunk_schedule(0, 24, 8, (12,)))
    msgs = [r.getMessage() for r in caplog.records
            if "single-step remainder" in r.getMessage()]
    assert len(msgs) == 2, msgs
    assert "configured chunk size 8" in msgs[0]


@pytest.mark.parametrize("schedule", [[4, 4, 4], [1, 3, 1, 4], [2, 2, 2, 2]])
def test_stack_chunks_matches_jax(schedule):
    """Chunks of n stack on a new axis 0 (fresh buffers), singles pass
    through, a stream ending mid-chunk flushes as singles: the same
    chunks as the JAX function, one `stack` sample a stacked chunk."""
    batches = _rand_batches(7)
    m, jm = PipelineMetrics(), JaxMetrics()
    got = list(stack_chunks(iter(batches), iter(schedule), metrics=m))
    want = list(jax_qr.stack_chunks(iter(batches), iter(schedule),
                                    metrics=jm))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    stacked = sum(1 for n, _ in got if n > 1)
    assert m.summary()["stages"].get("stack", {"count": 0})["count"] \
        == stacked
    for n, block in got:
        if n > 1:
            assert block["data"].shape == (n, 8, 1, 4, 4)
            assert not any(np.shares_memory(block["data"], b["data"])
                           for b in batches)


def test_metrics_chunk_accounting_matches_jax():
    m, jm = PipelineMetrics(), JaxMetrics()
    for metrics in (m, jm):
        metrics.add_chunk(8, 0.4)
        metrics.mark_step(2)
    s, js = m.summary(), jm.summary()
    assert s["stages"]["scan_step"]["count"] == 1
    assert s["stages"]["step"]["count"] == 8
    assert s["stages"]["step"]["mean_ms"] == pytest.approx(50.0)
    assert s["steps"] == js["steps"] == 10
    for stage in ("scan_step", "step"):
        assert s["stages"][stage]["count"] == js["stages"][stage]["count"]
        assert s["stages"][stage]["mean_ms"] == pytest.approx(
            js["stages"][stage]["mean_ms"])


# ------------------------------------------------------- solver parity

def _torch_block(batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches]))
            for k in batches[0]}


@pytest.mark.parametrize("policy", POLICIES)
def test_lr_sequence_matches_single_steps_and_jax(policy):
    k = 6
    text = f"base_lr: 0.1 momentum: 0.9 {policy} random_seed: 5"
    if "max_iter" not in text:
        text += " max_iter: 6"
    batches = _rand_batches(k, seed=3)
    a = Solver(SolverParameter.from_text(text),
               NetParameter.from_text(TINY_NET), device="cpu")
    pa, sa = a.init()
    single = [float(a.train_step(pa, sa, {n: torch.from_numpy(v)
                                          for n, v in b.items()})[1]["lr"])
              for b in batches]
    b_ = Solver(SolverParameter.from_text(text),
                NetParameter.from_text(TINY_NET), device="cpu")
    pb, sb = b_.init()
    losses, out = b_.train_step_many(k)(pb, sb, _torch_block(batches))
    assert losses.shape == (k,) and out["lr"].shape == (k,)
    assert out["lr"].tolist() == single
    js = JaxSolver(JaxSolverParameter.from_text(text),
                   JaxNetParameter.from_text(TINY_NET))
    jp, jst = js.init()
    _, _, jout = js.jit_train_step_many(k)(
        jp, jst, {n: jnp.asarray(np.stack([b[n] for b in batches]))
                  for n in batches[0]})
    np.testing.assert_allclose(out["lr"].numpy(), np.asarray(jout["lr"]),
                               rtol=1e-6)
    for ln in pa:
        for bn in pa[ln]:
            assert torch.equal(pa[ln][bn], pb[ln][bn])


@pytest.mark.parametrize("stype", ["SGD", "ADAM"])
def test_train_step_many_bit_equal_with_clip_and_iter_size(stype):
    """train_step_many(4) twice against 8 train_step calls: params,
    histories, iteration, losses and outputs bit-equal, with
    clip_gradients, iter_size 2 and an lr_mult of 2 (two update
    factors a step)."""
    text = (f"type: '{stype}' base_lr: 0.05 momentum: 0.9 "
            "momentum2: 0.999 lr_policy: 'step' gamma: 0.5 stepsize: 3 "
            "clip_gradients: 1.0 iter_size: 2 weight_decay: 0.001 "
            "max_iter: 100 random_seed: 7")
    batches = _rand_batches(8, batch=16, seed=11)
    a = Solver(SolverParameter.from_text(text),
               NetParameter.from_text(TINY_NET), device="cpu")
    assert a._mult_values == [1.0, 2.0]
    pa, sa = a.init()
    want = [a.train_step(pa, sa, {n: torch.from_numpy(v)
                                  for n, v in b.items()})
            for b in batches]
    b_ = Solver(SolverParameter.from_text(text),
                NetParameter.from_text(TINY_NET), device="cpu")
    pb, sb = b_.init()
    many = b_.train_step_many(4)
    assert b_.train_step_many(4) is many
    got = [many(pb, sb, _torch_block(batches[i:i + 4])) for i in (0, 4)]
    assert sa.iter == sb.iter == 8
    for tree_a, tree_b in ((pa, pb), (sa.history, sb.history),
                           (sa.history2, sb.history2)):
        for ln in tree_a:
            for bn in tree_a[ln]:
                assert torch.equal(tree_a[ln][bn], tree_b[ln][bn]), (ln, bn)
    losses = torch.cat([g[0] for g in got])
    assert torch.equal(losses, torch.stack([w[0] for w in want]))
    assert torch.equal(torch.cat([g[1]["loss"] for g in got]),
                       torch.stack([w[1]["loss"] for w in want]))
    with pytest.raises(ValueError):
        b_.train_step_many(0)


# ------------------------------------------------ mini_cluster and CLI

@pytest.fixture()
def e2e(tmp_path):
    """E2E_NET and its solver with `display: 4` (a display boundary the
    chunks respect); one -weights file for every run."""
    _write_lmdb(tmp_path / "train_lmdb", 64, seed=5)
    _write_lmdb(tmp_path / "test_lmdb", 16, seed=99)
    net = tmp_path / "net.prototxt"
    net.write_text(E2E_NET.format(train=tmp_path / "train_lmdb",
                                  test=tmp_path / "test_lmdb"))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(E2E_SOLVER.format(net=net).replace("display: 0",
                                                         "display: 4"))
    ts = Solver(SolverParameter.from_text(solver.read_text()),
                NetParameter.from_text(net.read_text()), device="cpu")
    weights = tmp_path / "init.caffemodel"
    checkpoint.save_caffemodel(str(weights), ts.train_net,
                               ts.train_net.init(3))
    return tmp_path, str(solver), str(weights)


def _mc(main, tmp, solver, weights, out, k, monkeypatch, extra=()):
    os.makedirs(tmp / out, exist_ok=True)
    monkeypatch.setenv("COS_STEPS_PER_LOOP", str(k))
    try:
        return main(["-solver", solver, "-weights", weights, "-output",
                     str(tmp / out), "-metrics", str(tmp / out / "m.jsonl"),
                     "-model", str(tmp / out / "final.caffemodel"),
                     *extra])
    finally:
        monkeypatch.delenv("COS_STEPS_PER_LOOP")


def _jsonl(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _blobs_close(got_path, want_path, rtol=1e-4, atol=1e-6):
    got = checkpoint.load_caffemodel_blobs(str(got_path))
    want = jax_ckpt.load_caffemodel_blobs(str(want_path))
    assert set(got) == set(want)
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=ln)


@pytest.mark.parametrize("k", [3, 4])
def test_mini_cluster_at_k_matches_jax_at_k(k, e2e, monkeypatch):
    """Both standalone trainers at COS_STEPS_PER_LOOP=k (3 forces single
    steps before the display, validation and snapshot boundaries) from
    one -weights: the same files, the display-step losses (rtol 1e-5),
    validation.json (rtol 1e-5), the snapshot and final blobs (rtol
    1e-4, atol 1e-6); the port at k bit-equal to the port at K=1."""
    tmp, solver, weights = e2e
    assert _mc(mini_cluster.main, tmp, solver, weights, "t", k, monkeypatch,
               ["-device", "cpu"]) == 0
    assert _mc(jax_mc.main, tmp, solver, weights, "j", k, monkeypatch,
               ["-devices", "1"]) == 0
    assert _mc(mini_cluster.main, tmp, solver, weights, "t1", 1,
               monkeypatch, ["-device", "cpu"]) == 0
    files = ["final.caffemodel", "m.jsonl", "steploop_iter_16.caffemodel",
             "steploop_iter_16.solverstate", "validation.json"]
    assert sorted(os.listdir(tmp / "t")) == sorted(os.listdir(tmp / "j")) \
        == files
    mt, mj = _jsonl(tmp / "t" / "m.jsonl"), _jsonl(tmp / "j" / "m.jsonl")
    assert [r["iter"] for r in mt] == [r["iter"] for r in mj] \
        == [4, 8, 12, 16, 20, 24]
    np.testing.assert_allclose([r["loss"] for r in mt],
                               [r["loss"] for r in mj], rtol=1e-5)
    np.testing.assert_allclose([r["lr"] for r in mt],
                               [r["lr"] for r in mj], rtol=1e-6)
    vt = _jsonl(tmp / "t" / "validation.json")
    vj = _jsonl(tmp / "j" / "validation.json")
    assert len(vt) == len(vj) == 2
    for a, b in zip(vt, vj):
        for key in b:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6)
    for name in ("steploop_iter_16.caffemodel", "final.caffemodel"):
        _blobs_close(tmp / "t" / name, tmp / "j" / name)
        with open(tmp / "t" / name, "rb") as a, \
                open(tmp / "t1" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert [r["loss"] for r in mt] == \
        [r["loss"] for r in _jsonl(tmp / "t1" / "m.jsonl")]


def test_cli_at_k4_matches_jax_cli_at_k4(tmp_path, monkeypatch, caplog):
    """-train through both CLIs at COS_STEPS_PER_LOOP=4 from one
    -weights, validating every 10 steps and snapshotting every 6
    (single-step remainders before both): validation.json within rtol
    1e-4, the snapshot and final blobs within rtol 1e-4; the port at
    K=4 writes the K=1 run's files byte for byte, its per-step losses
    equal, and logs each display line (display 3) at its iteration."""
    solver = write_config(tmp_path, max_iter=20, test_interval=10)
    with open(solver) as f:
        text = f.read()
    with open(solver, "w") as f:
        f.write(text.replace("snapshot: 0", "snapshot: 6")
                .replace("display: 25", "display: 3"))
    init = init_model(tmp_path, solver)
    infos = {}
    for out, k in (("t", 4), ("t1", 1)):
        monkeypatch.setenv("COS_STEPS_PER_LOOP", str(k))
        monkeypatch.setenv("COS_PIPELINE_METRICS", str(tmp_path / f"{out}.json"))
        with caplog.at_level(logging.INFO,
                             logger="caffeonspark_tpu_torch.processor"):
            caplog.clear()
            assert caffe_on_spark.main(["-conf", solver, "-train",
                                        "-weights", init, "-output",
                                        str(tmp_path / out), "-device",
                                        "cpu"]) == 0
        shown = [r.getMessage() for r in caplog.records
                 if r.getMessage().startswith("Iteration ")]
        assert [int(x.split()[1].rstrip(",")) for x in shown] == \
            [3, 6, 9, 12, 15, 18], shown
        infos[out] = json.load(open(tmp_path / f"{out}.json"))
    monkeypatch.delenv("COS_PIPELINE_METRICS")
    monkeypatch.setenv("COS_STEPS_PER_LOOP", "4")
    assert jax_cos.main(["-conf", solver, "-train", "-weights", init,
                         "-output", str(tmp_path / "j"), "-devices",
                         "1"]) == 0
    got = read_json_rows(tmp_path / "t" / "validation.json")
    want = read_json_rows(tmp_path / "j" / "validation.json")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "t1"))
    assert "lenetish_iter_18.caffemodel" in names
    for name in ("lenetish_iter_6.caffemodel", "lenetish_iter_18.caffemodel",
                 "model.caffemodel"):
        _blobs_close(tmp_path / "t" / name, tmp_path / "j" / name,
                     atol=1e-7)
    for name in names:
        with open(tmp_path / "t" / name, "rb") as a, \
                open(tmp_path / "t1" / name, "rb") as b:
            assert a.read() == b.read(), name
    t4, t1 = infos["t"], infos["t1"]
    assert t4["info"]["train"]["iter"] == list(range(1, 21))
    assert t4["info"]["train"]["loss"] == t1["info"]["train"]["loss"]
    assert t4["info"]["train"]["lr"] == t1["info"]["train"]["lr"]
    # chunks of 4 (scan_step) and single steps, 20 steps in all
    assert t4["stages"]["scan_step"]["count"] >= 2
    assert t4["stages"]["step"]["count"] == t4["steps"] == 20


def test_resume_mid_schedule_equals_k1(e2e, monkeypatch):
    """Stop at the snapshot at 16 (mid-schedule: the 12 boundary cut
    single steps before it) and resume at the same K: K=4 and K=1 end
    bit-equal, at iteration 24."""
    tmp, solver, weights = e2e
    finals = {}
    for k in (1, 4):
        out = f"r{k}"
        assert _mc(mini_cluster.main, tmp, solver, weights, out, k,
                   monkeypatch, ["-device", "cpu", "-iterations", "16"]) == 0
        state = tmp / out / "steploop_iter_16.solverstate"
        assert state.exists()
        monkeypatch.setenv("COS_STEPS_PER_LOOP", str(k))
        args = mini_cluster.build_argparser().parse_args(
            ["-solver", solver, "-output", str(tmp / out), "-device", "cpu",
             "-snapshot", str(state)])
        mc = mini_cluster.MiniCluster(args)
        mc.train()
        monkeypatch.delenv("COS_STEPS_PER_LOOP")
        assert mc.final_state.iter == 24
        finals[k] = mc
    a, b = finals[1], finals[4]
    for tree_a, tree_b in ((a.final_params, b.final_params),
                           (a.final_state.history, b.final_state.history)):
        for ln in tree_a:
            for bn in tree_a[ln]:
                assert torch.equal(tree_a[ln][bn], tree_b[ln][bn])


LM = dict(vocab=16, d_model=32, heads=2, layers=1, seq=128, batch=4)


def test_mesh_with_k2_equals_k1(tmp_path, monkeypatch):
    """-mesh 1,1,4 (the ring in every step) at K=2 on the CPU: the same
    losses and final model as K=1."""
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
    sgd = ('type: "SGD" base_lr: 0.1 momentum: 0.9 lr_policy: "fixed" '
           'random_seed: 1 display: 2')
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\n{sgd}\nmax_iter: 4\n'
                      'snapshot_prefix: "lm"\n')
    ts = Solver(SolverParameter.from_text(sgd), npm, device="cpu")
    weights = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(weights, ts.train_net, ts.train_net.init(21))
    for out, k in (("k2", 2), ("k1", 1)):
        assert _mc(mini_cluster.main, tmp_path, str(solver), weights, out,
                   k, monkeypatch, ["-device", "cpu", "-mesh",
                                    "1,1,4"]) == 0
    assert _jsonl(tmp_path / "k2" / "m.jsonl") and [
        r["loss"] for r in _jsonl(tmp_path / "k2" / "m.jsonl")] == [
        r["loss"] for r in _jsonl(tmp_path / "k1" / "m.jsonl")]
    with open(tmp_path / "k2" / "final.caffemodel", "rb") as a, \
            open(tmp_path / "k1" / "final.caffemodel", "rb") as b:
        assert a.read() == b.read()
