"""The PyTorch port's transformer-LM training slice against the JAX
package: the DataFrameSource that feeds it, one solver step of the zoo's
causal `transformer_lm`, and `-train` through both CLIs.

  * the same JSON-lines table through both packages' DataFrameSource
    gives equal batches over two shuffled epochs (rows shorter and
    longer than `channels` included) and the same rank shards;
  * one Adam step of transformer_lm(vocab=16, d_model=32, heads=2,
    layers=1, seq=128, batch=4) from the same params and batch: loss to
    rtol 1e-5, every gradient to 1e-4 of its largest element (the JAX
    side through its Pallas flash kernels in interpret mode);
  * `-train -device cpu` of the port against the JAX CLI
    (COS_FLASH_INTERPRET=1) from one -weights .caffemodel on the same
    rows: the per-step losses and the snapshot and final blobs to
    rtol 1e-4 (sums run in other orders on each side).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import caffe_on_spark, checkpoint, convert
from caffeonspark_tpu_torch.data import get_source
from caffeonspark_tpu_torch.data.dataframe import DataFrameSource
from caffeonspark_tpu_torch.data.queue_runner import combine_batches
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.proto import (NetParameter, SolverParameter,
                                          TopBlobType)
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

LM = dict(vocab=16, d_model=32, heads=2, layers=1, seq=128, batch=4)
ADAM = ('type: "Adam" base_lr: 0.001 momentum: 0.9 momentum2: 0.999 '
        'delta: 1e-8 lr_policy: "fixed" random_seed: 1')


def _lm_text(source="", fmt="json", **kw):
    npm = zoo.transformer_lm(**{**LM, **kw})
    p = npm.layer[0].cos_data_param
    p.source = source
    p.dataframe_format = fmt
    npm.layer[0].source_class = "com.yahoo.ml.caffe.DataFrameSource"
    return npm.to_text()


def _write_rows(path, n, seq, vocab, seed, ragged=False):
    """n rows of `seq + 1` seeded tokens: input = tokens[:-1], target =
    tokens[1:]; with `ragged`, every third row is cut short and every
    fourth runs long (the source pads with 0 and cuts at `channels`)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            toks = rng.randint(0, vocab, seq + 1).tolist()
            inp, tgt = toks[:-1], toks[1:]
            if ragged and i % 3 == 1:
                inp, tgt = inp[:seq // 2], tgt[:seq // 3]
            if ragged and i % 4 == 2:
                inp, tgt = inp + [1, 2, 3], tgt + [4]
            f.write(json.dumps({"input_sentence": inp,
                                "target_sentence": tgt, "id": f"r{i}",
                                "w": float(i) / 2}) + "\n")


# ---------------------------------------------------------------------------
# DataFrameSource
# ---------------------------------------------------------------------------

TOPS = """
layer { name: "data" type: "CoSData" top: "input_sentence"
  top: "target_sentence" top: "id" top: "w"
  source_class: "com.yahoo.ml.caffe.DataFrameSource"
  cos_data_param { batch_size: 3 source: "%s" dataframe_format: "json"
    top { name: "input_sentence" type: INT_ARRAY channels: 8
          sample_num_axes: 1 transpose: true }
    top { name: "target_sentence" type: INT_ARRAY channels: 8
          sample_num_axes: 1 }
    top { name: "id" type: STRING sample_num_axes: 0 }
    top { name: "w" type: FLOAT sample_num_axes: 0 } } }
"""


def test_dataframe_batches_match_jax_over_two_shuffled_epochs(tmp_path):
    """Both packages' DataFrameSource over one JSON-lines file: the same
    shuffled row order in each of two epochs, and equal packed batches
    (transposed and plain int arrays, strings, floats)."""
    path = str(tmp_path / "rows.json")
    _write_rows(path, 14, 8, 50, seed=3, ragged=True)
    tl = NetParameter.from_text(TOPS % path).layer[0]
    jl = JaxNetParameter.from_text(TOPS % path).layer[0]
    src = get_source(tl, phase_train=True, seed=5)
    jsrc = jax_get_source(jl, phase_train=True, seed=5)
    assert isinstance(src, DataFrameSource)
    assert src.pack_batch.__func__ is DataFrameSource.next_batch
    for epoch in range(2):
        rows = list(src.shuffled_records(epoch))
        jrows = list(jsrc.shuffled_records(epoch))
        assert [r["id"] for r in rows] == [r["id"] for r in jrows]
        for i in range(0, len(rows) - 2, 3):
            got = src.pack_batch(rows[i:i + 3])
            want = jsrc.pack_batch(jrows[i:i + 3])
            assert set(got) == set(want)
            for name in want:
                assert got[name].shape == want[name].shape, name
                assert got[name].dtype == want[name].dtype, name
                np.testing.assert_array_equal(got[name], want[name])
    got = src.pack_batch(rows[:3])
    assert got["input_sentence"].shape == (8, 3)        # (T, B)
    assert got["target_sentence"].shape == (3, 8)


@pytest.mark.parametrize("ranks", [2, 3])
def test_dataframe_rank_shards_match_jax(tmp_path, ranks):
    path = str(tmp_path / "rows.json")
    _write_rows(path, 10, 8, 50, seed=4)
    tl = NetParameter.from_text(TOPS % path).layer[0]
    jl = JaxNetParameter.from_text(TOPS % path).layer[0]
    for rank in range(ranks):
        got = [r["id"] for r in get_source(
            tl, rank=rank, num_ranks=ranks).rows()]
        want = [r["id"] for r in jax_get_source(
            jl, phase_train=False, rank=rank, num_ranks=ranks).rows()]
        assert got == want and got


def test_dataframe_refuses_what_waits(tmp_path, monkeypatch):
    """An image top, refused before the data-path slice, now decodes its
    base64 JSON column (lossless PNGs) to the images encoded; parquet
    without pyarrow says so; an unknown format is refused."""
    import base64

    import cv2
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    jpegs = [bytes(cv2.imencode(".png", im)[1]) for im in imgs]
    path = str(tmp_path / "rows.json")
    with open(path, "w") as f:
        for i, b in enumerate(jpegs):
            f.write(json.dumps({"id": base64.b64encode(b).decode(),
                                "label": float(i)}) + "\n")
    lp = NetParameter.from_text(TOPS % path).layer[0]
    top = lp.cos_data_param.top[2]
    top.type = TopBlobType.ENCODED_IMAGE
    top.channels, top.height, top.width = 3, 8, 8
    src = get_source(lp)
    got = src.next_batch(list(src.rows()))["id"]
    np.testing.assert_array_equal(got, imgs.transpose(0, 3, 1, 2))
    lp.cos_data_param.dataframe_format = "parquet"
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        list(get_source(lp).rows())
    lp.cos_data_param.dataframe_format = "csv"
    with pytest.raises(ValueError, match="csv"):
        list(get_source(lp).rows())


def test_time_major_inputs_combine_and_split_on_the_batch_axis():
    """iter_size > 1 on time-major (T, B) tops: combine_batches joins
    them on axis 1 and the solver splits them there, so two sub-batches
    of 2 give the mean of the two steps' gradients."""
    a = {"x": np.zeros((5, 2)), "y": np.zeros((2, 3))}
    b = {"x": np.ones((5, 2)), "y": np.ones((2, 3))}
    (out,) = combine_batches(iter([a, b]), 2, frozenset({"x"}))
    assert out["x"].shape == (5, 4) and out["y"].shape == (4, 3)
    assert out["x"][0].tolist() == [0, 0, 1, 1]

    net = NetParameter.from_text(_lm_text(batch=4, seq=16))
    one = Solver(SolverParameter.from_text(ADAM), net, device="cpu")
    two = Solver(SolverParameter.from_text(ADAM + " iter_size: 2"), net,
                 device="cpu")
    params = one.train_net.init(3)
    rng = np.random.RandomState(2)
    batch = {k: torch.from_numpy(rng.randint(0, 16, (16, 4))
                                 .astype(np.float32))
             for k in ("input_sentence", "target_sentence")}
    _, _, g2 = two.loss_and_grads(params, batch)
    halves = [one.loss_and_grads(params, {k: v[:, i:i + 2]
                                          for k, v in batch.items()})[2]
              for i in (0, 2)]
    for ln, bl in g2.items():
        for bn, g in bl.items():
            want = (halves[0][ln][bn] + halves[1][ln][bn]) / 2
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# one solver step, and -train through both CLIs
# ---------------------------------------------------------------------------

def test_lm_solver_step_matches_jax(monkeypatch):
    """One Adam step of the slice's net: loss and gradients of the port
    (plain flash versions on the CPU) against the JAX solver (Pallas
    flash kernels in interpret mode) on the same params and batch, then
    the updated params."""
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    text = _lm_text()
    jsolver = JaxSolver(JaxSolverParameter.from_text(ADAM),
                        JaxNetParameter.from_text(text))
    tsolver = Solver(SolverParameter.from_text(ADAM),
                     NetParameter.from_text(text), device="cpu")
    net = tsolver.train_net
    arrays = convert.params_to_numpy(net.init(7))
    assert {ln: {bn: a.shape for bn, a in bl.items()}
            for ln, bl in arrays.items()} == {
        ln: {bn: tuple(s) for bn, s, _ in specs}
        for ln, specs in jsolver.train_net.param_layout.items()}
    rng = np.random.RandomState(8)
    batch = {k: rng.randint(0, LM["vocab"], (LM["seq"], LM["batch"]))
             .astype(np.float32)
             for k in ("input_sentence", "target_sentence")}
    jp = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
          for ln, bl in arrays.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jsolver.train_net.loss(p, jbatch), has_aux=True)(jp)
    tp = convert.params_from_numpy(net, arrays)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, _, tgrads = tsolver.loss_and_grads(tp, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert abs(float(tloss) - np.log(LM["vocab"])) < 0.5
    for ln, bl in tgrads.items():
        for bn, g in bl.items():
            want = np.asarray(jgrads[ln][bn])
            err = float(np.abs(g.numpy() - want).max())
            assert err <= 1e-4 * float(np.abs(want).max()), (ln, bn, err)

    jp2, jst, jout = jsolver.train_step_fn()(jp, jsolver.init_state(jp),
                                             jbatch, jsolver.step_rng(0))
    tst = tsolver.init_state(tp)
    loss, out = tsolver.train_step(tp, tst, tbatch)
    np.testing.assert_allclose(float(loss), float(jout["loss"]), rtol=1e-5)
    assert tst.iter == int(jst.iter) == 1
    for ln, bl in tp.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(w.numpy(), np.asarray(jp2[ln][bn]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{ln}/{bn}")


def test_cli_train_lm_matches_jax_cli(tmp_path, monkeypatch):
    """-train of the LM through both CLIs from one -weights .caffemodel
    on the same JSON rows (12 rows, batch 4: the 4 steps cross an epoch
    boundary and its reshuffle): the port's snapshots, metrics and
    per-step losses (against the JAX solver replaying the same feed)
    and its snapshot and final blobs against the JAX CLI's."""
    rows = str(tmp_path / "rows.json")
    _write_rows(rows, 12, LM["seq"], LM["vocab"], seed=9)
    net_path = tmp_path / "net.prototxt"
    net_path.write_text(_lm_text(rows))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net_path}"\n{ADAM}\nmax_iter: 4\n'
                      'snapshot: 2\nsnapshot_prefix: "lm"\n')
    ts = Solver(SolverParameter.from_text(ADAM),
                NetParameter.from_text(net_path.read_text()), device="cpu")
    init = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(init, ts.train_net, ts.train_net.init(21))

    monkeypatch.setenv("COS_PIPELINE_METRICS", str(tmp_path / "m.json"))
    assert caffe_on_spark.main(["-conf", str(solver), "-train", "-weights",
                                init, "-output", str(tmp_path / "t"),
                                "-device", "cpu"]) == 0
    monkeypatch.delenv("COS_PIPELINE_METRICS")
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    # one device: the test harness's 8 virtual CPUs would shard batch 4
    assert jax_cos.main(["-conf", str(solver), "-train", "-weights", init,
                         "-output", str(tmp_path / "j"),
                         "-devices", "1"]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == [
        "lm_iter_2.caffemodel", "lm_iter_2.solverstate",
        "lm_iter_4.caffemodel", "lm_iter_4.solverstate",
        "model.caffemodel"]
    info = json.load(open(tmp_path / "m.json"))["info"]["train"]
    assert info["iter"] == [1, 2, 3, 4]

    # the JAX solver on the feed both CLIs see: per-epoch shuffled rows
    # (source seed 0, as -train builds it) in batches of 4
    jl = JaxNetParameter.from_text(net_path.read_text()).layer[0]
    jsrc = jax_get_source(jl, phase_train=True)
    feed = [r for e in range(2) for r in jsrc.shuffled_records(e)]
    jsolver = JaxSolver(JaxSolverParameter.from_text(ADAM),
                        JaxNetParameter.from_text(net_path.read_text()))
    blobs = jax_ckpt.load_caffemodel_blobs(init)
    jp = {ln: {bn: jnp.asarray(a) for (bn, _, _), a in
               zip(specs, blobs[ln])}
          for ln, specs in jsolver.train_net.param_layout.items()}
    jst = jsolver.init_state(jp)
    step = jax.jit(jsolver.train_step_fn())
    losses = []
    for it in range(4):
        b = jsrc.pack_batch(feed[4 * it:4 * it + 4])
        jp, jst, out = step(jp, jst, {k: jnp.asarray(v) for k, v in
                                      b.items()}, jsolver.step_rng(it))
        losses.append(float(out["loss"]))
    np.testing.assert_allclose(info["loss"], losses, rtol=1e-4)

    for name in ("lm_iter_2.caffemodel", "model.caffemodel"):
        got = checkpoint.load_caffemodel_blobs(str(tmp_path / "t" / name))
        want = jax_ckpt.load_caffemodel_blobs(str(tmp_path / "j" / name))
        assert set(got) == set(want)
        for ln in want:
            for g, w in zip(got[ln], want[ln]):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name} {ln}")
