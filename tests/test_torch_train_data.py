"""The PyTorch port's training data path, checkpoints and -train CLI
against the JAX package.

  * an LMDB written by either package reads identically in the other;
  * TRAIN-phase transformer batches (random crop, mirror, mean, scale)
    are equal, not merely close, for the same seed: both draw from
    numpy in the same order;
  * a source's records, `shuffled_records(epoch)` order and packed
    TRAIN batches are equal;
  * a .caffemodel/.solverstate pair written by either package restores
    in the other, and the two packages write the same bytes;
  * 4 straight solver steps equal 2 steps + snapshot + restore + 2;
  * `-train` of LeNet through both CLIs from the same -weights file on
    the same LMDB ends within rtol 1e-4 (convolutions sum in other
    orders on each side).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.data import LmdbReader as JaxLmdbReader
from caffeonspark_tpu.data import LmdbWriter as JaxLmdbWriter
from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.data.transformer import Transformer as JaxTransformer
from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import OptState as JaxOptState
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import caffe_on_spark, checkpoint, convert
from caffeonspark_tpu_torch.data import LmdbReader, LmdbWriter, get_source
from caffeonspark_tpu_torch.data.queue_runner import (FeedQueue,
                                                      combine_batches)
from caffeonspark_tpu_torch.data.source import STOP_MARK
from caffeonspark_tpu_torch.data.transformer import Transformer
from caffeonspark_tpu_torch.proto import (NetParameter, SolverParameter,
                                          TransformationParameter)
from caffeonspark_tpu_torch.proto.caffe import DBBackend, Datum
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()


def _records(n, c=1, h=28, w=28, seed=0):
    rng = np.random.RandomState(seed)
    return [(b"%08d" % i, Datum(
        channels=c, height=h, width=w,
        data=rng.randint(0, 256, c * h * w).astype(np.uint8).tobytes(),
        label=int(rng.randint(10))).to_binary()) for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lmdb_written_by_either_package_reads_in_the_other(tmp_path,
                                                           writer):
    recs = _records(40, 3, 9, 7, seed=1)
    recs.append((b"big", Datum(channels=3, height=64, width=64,
                               data=bytes(3 * 64 * 64),
                               label=3).to_binary()))   # overflow pages
    recs.sort()
    path = str(tmp_path / "db")
    (JaxLmdbWriter if writer == "jax" else LmdbWriter)(path).write(recs)
    for reader in (JaxLmdbReader, LmdbReader):
        with reader(path) as r:
            assert list(r.items(None, None)) == recs
            parts = r.partition_ranges(3)
        with reader(path) as r:
            got = [kv for lo, hi in parts for kv in r.items(lo, hi)]
        assert got == recs


def _tp(text):
    return TransformationParameter.from_text(text)


@pytest.mark.parametrize("text", [
    "crop_size: 5 mirror: true mean_value: 104 mean_value: 117 "
    "mean_value: 123",
    "crop_size: 7 scale: 0.00390625",
    "mirror: true mean_value: 10 scale: 0.5",
])
def test_train_transformer_batches_equal_jax(text):
    from caffeonspark_tpu.proto.caffe import (
        TransformationParameter as JaxTP)
    rng = np.random.RandomState(2)
    jt = JaxTransformer(JaxTP.from_text(text), phase_train=True, seed=11)
    tt = Transformer(_tp(text), phase_train=True, seed=11)
    for _ in range(3):
        batch = rng.randint(0, 256, (6, 3, 9, 8)).astype(np.float32)
        np.testing.assert_array_equal(tt(batch.copy()),
                                      jt(batch.copy()))
    test_t = Transformer(_tp(text), phase_train=False, seed=11)
    test_j = JaxTransformer(JaxTP.from_text(text), phase_train=False,
                            seed=11)
    batch = rng.randint(0, 256, (2, 3, 9, 8)).astype(np.float32)
    np.testing.assert_array_equal(test_t(batch), test_j(batch))


def _lenet_text(src, batch=8):
    """The zoo's LeNet on an LMDB-backed MemoryData layer with random
    crop and mirror."""
    npm = jax_zoo.lenet(batch)
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.LMDB"
    data.memory_data_param.source = src
    data.transform_param.crop_size = 24
    data.transform_param.mirror = True
    return npm.to_text()


def test_source_records_shuffle_and_train_batches_equal_jax(tmp_path):
    path = str(tmp_path / "db")
    LmdbWriter(path).write(_records(30, seed=3))
    text = _lenet_text(path)
    jl = JaxNetParameter.from_text(text).layer[0]
    tl = NetParameter.from_text(text).layer[0]
    jsrc = jax_get_source(jl, phase_train=True, rank=0, num_ranks=1,
                          seed=5)
    tsrc = get_source(tl, phase_train=True, rank=0, num_ranks=1, seed=5)
    assert tsrc.batch_size == jsrc.batch_size == 8
    assert list(tsrc.records()) == list(jsrc.records())
    for epoch in (0, 1, 7):
        assert [r[0] for r in tsrc.shuffled_records(epoch)] == \
            [r[0] for r in jsrc.shuffled_records(epoch)]
    recs = list(tsrc.shuffled_records(0))
    for i in range(2):
        b_t = tsrc.next_batch(recs[8 * i:8 * i + 8])
        b_j = jsrc.next_batch(recs[8 * i:8 * i + 8])
        assert set(b_t) == set(b_j) == {"data", "label"}
        for k in b_t:
            np.testing.assert_array_equal(b_t[k], b_j[k])


def test_caffe_data_layer_reads_its_lmdb_as_jax(tmp_path):
    """Caffe's source-less `Data` layer over an LMDB: the same geometry
    (from the first record), records, shuffle and packed TRAIN batches
    as the JAX package; so does a LevelDB backend over the same records
    (written by the JAX package's LevelDBWriter, snappy blocks)."""
    from caffeonspark_tpu.net import data_layer_input_specs as jax_specs
    from caffeonspark_tpu_torch.data.source import CaffeDataSource
    from caffeonspark_tpu_torch.net import data_layer_input_specs
    path = str(tmp_path / "db")
    LmdbWriter(path).write(_records(12, 3, 10, 9, seed=6))
    text = ('layer { name: "d" type: "Data" top: "data" top: "label" '
            f'data_param {{ source: "file:{path}" batch_size: 4 '
            'backend: LMDB } transform_param { crop_size: 8 mirror: true '
            'mean_value: 100 } }')
    jl = JaxNetParameter.from_text(text).layer[0]
    tl = NetParameter.from_text(text).layer[0]
    jsrc = jax_get_source(jl, phase_train=True, seed=3)
    tsrc = get_source(tl, phase_train=True, seed=3)
    assert isinstance(tsrc, CaffeDataSource) and tsrc.batch_size == 4
    assert tsrc.image_dims() == jsrc.image_dims() == (3, 10, 9)
    assert data_layer_input_specs(tl) == jax_specs(jl) == [
        ("data", (4, 3, 8, 8), "data"), ("label", (4,), "label")]
    recs = list(tsrc.shuffled_records(1))
    assert recs == list(jsrc.shuffled_records(1))
    for i in range(3):
        b_t = tsrc.next_batch(recs[4 * i:4 * i + 4])
        b_j = jsrc.next_batch(recs[4 * i:4 * i + 4])
        for k in ("data", "label"):
            np.testing.assert_array_equal(b_t[k], b_j[k])
    from caffeonspark_tpu.data.leveldb_io import LevelDBWriter
    ldb = str(tmp_path / "ldb")
    LevelDBWriter(ldb, snappy=True, block_size=512).write(
        _records(12, 3, 10, 9, seed=6))
    jl.data_param.source = tl.data_param.source = ldb
    jl.data_param.backend = tl.data_param.backend = DBBackend.LEVELDB
    tsrc = get_source(tl, phase_train=True, seed=3)
    jsrc = jax_get_source(jl, phase_train=True, seed=3)
    assert tsrc.image_dims() == jsrc.image_dims() == (3, 10, 9)
    assert data_layer_input_specs(tl) == jax_specs(jl)
    assert list(tsrc.shuffled_records(1)) == recs
    b_t = tsrc.next_batch(recs[:4])
    b_j = jsrc.next_batch(recs[:4])
    for k in ("data", "label"):
        np.testing.assert_array_equal(b_t[k], b_j[k])


def test_feed_queue_and_combine_batches():
    q = FeedQueue(capacity=2)
    assert q.offer(1) and q.offer(2)
    assert not q.offer(3, timeout=0)          # full: one attempt, False
    assert q.take() == 1 and len(q) == 1
    q.stop()
    assert not q.offer(4)                     # stopped
    q.reset()
    assert len(q) == 0 and q.offer(5)
    q.mark_epoch_end()
    assert q.take() == 5 and q.take() is STOP_MARK
    bs = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    out = list(combine_batches(iter(bs), 2))
    assert len(out) == 2 and out[1]["x"].shape == (4, 3)
    np.testing.assert_array_equal(out[1]["x"][:, 0], [2, 2, 3, 3])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

SOLVER = ('base_lr: 0.01 momentum: 0.9 weight_decay: 0.0005 '
          'lr_policy: "inv" gamma: 0.0001 power: 0.75 max_iter: 100')


def _pair(stype):
    text = f'type: "{stype}" ' + SOLVER
    npm = jax_zoo.lenet(4)
    js = JaxSolver(JaxSolverParameter.from_text(text), npm)
    ts = Solver(SolverParameter.from_text(text),
                NetParameter.from_text(npm.to_text()), device="cpu")
    return js, ts


def _state_arrays(layout, seed):
    rng = np.random.RandomState(seed)
    return {ln: {bn: rng.randn(*shape).astype(np.float32)
                 for bn, shape, _ in specs} for ln, specs in layout.items()}


@pytest.mark.parametrize("stype", ["SGD", "Adam"])
def test_snapshot_pairs_restore_across_packages(tmp_path, stype):
    js, ts = _pair(stype)
    net = ts.train_net
    layout = net.param_layout
    params = _state_arrays(layout, 1)
    h1, h2 = _state_arrays(layout, 2), _state_arrays(layout, 3)
    tp = convert.params_from_numpy(net, params)
    tst = convert.opt_state_from_numpy(net, 7, h1, h2)
    tm, tsp = checkpoint.snapshot(net, tp, tst, str(tmp_path / "t" / "m"),
                                  solver_type=ts.solver_type)
    jst = JaxOptState(iter=jnp.asarray(7, jnp.int32),
                      history={ln: {bn: jnp.asarray(a) for bn, a in
                                    bl.items()} for ln, bl in h1.items()},
                      history2={ln: {bn: jnp.asarray(a) for bn, a in
                                     bl.items()} for ln, bl in h2.items()})
    jm, jsp = jax_ckpt.snapshot(
        js.train_net, {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
                       for ln, bl in params.items()},
        jst, str(tmp_path / "j" / "m"), solver_type=js.solver_type)
    assert os.path.basename(tm) == os.path.basename(jm) == \
        "m_iter_7.caffemodel"
    for a, b in ((tm, jm), (tsp, jsp)):      # the same bytes
        assert open(a, "rb").read() == open(b, "rb").read()

    # the JAX pair restores in the port, and the port's in the JAX package
    p0, s0 = ts.init()
    rp, rst = checkpoint.restore(net, p0, s0, jsp)
    it, rh1, _ = convert.opt_state_to_numpy(rst)
    assert rst.iter == it == 7
    assert all(np.array_equal(rh1[ln][bn], h1[ln][bn])
               for ln in h1 for bn in h1[ln])
    jp0 = {ln: {bn: jnp.zeros(shape) for bn, shape, _ in specs}
           for ln, specs in layout.items()}
    js0 = js.init_state(jp0)
    jrp, jrst = jax_ckpt.restore(js.train_net, jp0, js0, tsp)
    assert int(jrst.iter) == 7
    two = stype == "Adam"
    for ln, bl in layout.items():
        for bn, _, _ in bl:
            for got, want in ((rp[ln][bn], params[ln][bn]),
                              (rst.history[ln][bn], h1[ln][bn]),
                              (jrp[ln][bn], params[ln][bn]),
                              (jrst.history[ln][bn], h1[ln][bn])):
                np.testing.assert_array_equal(np.asarray(got), want)
            want2 = h2[ln][bn] if two else np.zeros_like(h2[ln][bn])
            np.testing.assert_array_equal(rst.history2[ln][bn].numpy(),
                                          want2)


def test_resume_equals_straight_run(tmp_path):
    """4 straight steps == 2 steps, snapshot, restore into a new solver,
    2 more steps (the same batches), bit for bit."""
    _, ts = _pair("SGD")
    rng = np.random.RandomState(4)
    batches = [{"data": torch.from_numpy(
                    rng.rand(4, 1, 28, 28).astype(np.float32)),
                "label": torch.from_numpy(
                    rng.randint(0, 10, 4).astype(np.float32))}
               for _ in range(4)]
    p, st = ts.init()
    for b in batches:
        ts.train_step(p, st, b)
    _, ts2 = _pair("SGD")
    q, st2 = ts2.init()
    for b in batches[:2]:
        ts2.train_step(q, st2, b)
    _, state_path = checkpoint.snapshot(ts2.train_net, q, st2,
                                        str(tmp_path / "snap"))
    _, ts3 = _pair("SGD")
    r, st3 = ts3.init()
    r, st3 = checkpoint.restore(ts3.train_net, r, st3, state_path)
    assert st3.iter == 2
    for b in batches[2:]:
        ts3.train_step(r, st3, b)
    assert st3.iter == st.iter == 4
    for ln, bl in p.items():
        for bn, w in bl.items():
            assert torch.equal(w, r[ln][bn]), (ln, bn)
            assert torch.equal(st.history[ln][bn], st3.history[ln][bn])


# ---------------------------------------------------------------------------
# the -train CLI
# ---------------------------------------------------------------------------

def _cli_setup(tmp_path, max_iter=4, extra=""):
    path = str(tmp_path / "lmdb")
    if not os.path.exists(path):
        LmdbWriter(path).write(_records(48, seed=9))
    net = tmp_path / "net.prototxt"
    net.write_text(_lenet_text(path))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\n{SOLVER.replace("max_iter: 100", "")}'
                      f'\nmax_iter: {max_iter}\nsnapshot: 2\n'
                      f'random_seed: 13\n{extra}')
    return str(solver)


def test_cli_train_matches_jax_cli(tmp_path, monkeypatch):
    """Both CLIs train LeNet from the same -weights file on the same LMDB
    (shuffled, randomly cropped and mirrored): the final models agree,
    and the port writes its snapshots and metrics."""
    solver = _cli_setup(tmp_path)
    ts = Solver(SolverParameter.from_text("base_lr: 0.01"),
                NetParameter.from_text(_lenet_text("unused")),
                device="cpu")
    init = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(init, ts.train_net, ts.train_net.init(21))
    monkeypatch.setenv("COS_PIPELINE_METRICS", str(tmp_path / "m.json"))
    assert caffe_on_spark.main(["-conf", solver, "-train", "-weights", init,
                                "-output", str(tmp_path / "t"),
                                "-device", "cpu"]) == 0
    monkeypatch.delenv("COS_PIPELINE_METRICS")
    assert jax_cos.main(["-conf", solver, "-train", "-weights", init,
                         "-output", str(tmp_path / "j")]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == [
        "model.caffemodel", "model_iter_2.caffemodel",
        "model_iter_2.solverstate", "model_iter_4.caffemodel",
        "model_iter_4.solverstate"]
    got = checkpoint.load_caffemodel_blobs(str(tmp_path / "t" /
                                               "model.caffemodel"))
    want = jax_ckpt.load_caffemodel_blobs(str(tmp_path / "j" /
                                              "model.caffemodel"))
    assert set(got) == set(want)
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7,
                                       err_msg=ln)
    m = json.load(open(tmp_path / "m.json"))
    assert m["info"]["train"]["iter"] == [1, 2, 3, 4]
    assert all(np.isfinite(m["info"]["train"]["loss"]))
    assert m["stages"]["step"]["count"] == 4 and m["steps"] == 4


def test_cli_resume_from_snapshot(tmp_path):
    """-snapshot resumes at the state's iteration (its model found next
    to it) and runs to max_iter."""
    solver = _cli_setup(tmp_path, max_iter=2)
    out = tmp_path / "a"
    assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                str(out), "-device", "cpu"]) == 0
    state = str(out / "model_iter_2.solverstate")
    solver4 = _cli_setup(tmp_path, max_iter=4)
    out2 = tmp_path / "b"
    assert caffe_on_spark.main(["-conf", solver4, "-train", "-snapshot",
                                state, "-output", str(out2),
                                "-device", "cpu"]) == 0
    assert sorted(os.listdir(out2)) == [
        "model.caffemodel", "model_iter_4.caffemodel",
        "model_iter_4.solverstate"]


def test_cli_refuses_what_waits_for_later_slices(tmp_path):
    """The CLI's -server (the JAX package's Spark engine, ROADMAP Queue 1
    item 6d) is refused by name beside -clusterSize 2; a SequenceFile
    source and an HDF5Data layer, refused before the data-path slice,
    now read the records the JAX package reads."""
    from caffeonspark_tpu.data.hdf5 import HDF5Source as JaxHDF5Source
    from caffeonspark_tpu.data.sequencefile import SequenceFileWriter
    from caffeonspark_tpu_torch.data.hdf5 import HDF5Source
    from caffeonspark_tpu_torch.data.source import SeqImageDataSource
    solver = _cli_setup(tmp_path, extra="test_iter: 2\ntest_interval: 2\n")
    with pytest.raises(ValueError, match="^-server h:1"):
        caffe_on_spark.main(["-conf", solver, "-train", "-clusterSize",
                             "2", "-server", "h:1", "-device", "cpu"])
    seq = str(tmp_path / "recs.seq")
    recs = _records(6, 1, 2, 2, seed=2)
    with SequenceFileWriter(seq) as w:
        for k, v in recs:
            w.append(k.decode(), v)
    text = ('layer { name: "d" type: "MemoryData" top: "data" '
            'source_class: "com.yahoo.ml.caffe.SeqImageDataSource" '
            f'memory_data_param {{ source: "{seq}" batch_size: 2 '
            'channels: 1 height: 2 width: 2 } }')
    src = get_source(NetParameter.from_text(text).layer[0],
                     phase_train=True)
    assert isinstance(src, SeqImageDataSource)
    assert list(src.records()) == list(jax_get_source(
        JaxNetParameter.from_text(text).layer[0],
        phase_train=True).records())
    h5py = pytest.importorskip("h5py")
    with h5py.File(str(tmp_path / "a.h5"), "w") as f:
        f.create_dataset("data", data=np.arange(12, dtype=np.float32
                                                ).reshape(6, 2))
    (tmp_path / "list.txt").write_text("a.h5\n")
    text = ('layer { name: "h" type: "HDF5Data" top: "data" '
            f'hdf5_data_param {{ source: "{tmp_path / "list.txt"}" '
            'batch_size: 3 } }')
    h5 = get_source(NetParameter.from_text(text).layer[0])
    assert isinstance(h5, HDF5Source)
    jh5 = JaxHDF5Source(JaxNetParameter.from_text(text).layer[0],
                        phase_train=False)
    got, want = list(h5.records()), list(jh5.records())
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_array_equal(h5.next_batch(got[:3])["data"],
                                  jh5.next_batch(want[:3])["data"])


def test_bad_records_drop_their_batch_then_fail_loudly(tmp_path,
                                                       monkeypatch):
    """A record of the wrong geometry drops its batch and training goes
    on; a source of nothing but bad records stops after 20 consecutive
    drops and the error surfaces from the CLI."""
    good = _records(47, seed=9)
    bad = _records(1, h=27, w=27, seed=10)
    path = tmp_path / "lmdb"
    LmdbWriter(str(path)).write(sorted(good + [(b"00000005x",
                                                bad[0][1])]))
    solver = _cli_setup(tmp_path, max_iter=8)    # past one epoch of 6
    monkeypatch.setenv("COS_PIPELINE_METRICS", str(tmp_path / "m.json"))
    assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                str(tmp_path / "out"), "-device",
                                "cpu"]) == 0
    m = json.load(open(tmp_path / "m.json"))
    assert m["counters"]["dropped_batches"] >= 1
    assert m["info"]["train"]["iter"] == list(range(1, 9))

    all_bad = tmp_path / "bad"
    all_bad.mkdir()
    LmdbWriter(str(all_bad / "lmdb")).write(_records(16, h=27, w=27))
    solver = _cli_setup(all_bad, max_iter=4)
    with pytest.raises(RuntimeError, match="consecutive batch failures"):
        caffe_on_spark.main(["-conf", solver, "-train", "-output",
                             str(all_bad / "out"), "-device", "cpu"])
