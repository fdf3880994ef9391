"""The port's CaffeOnSpark facade and CLI against the JAX package's:
interleaved validation, -test, -features / -outputFormat, on the CPU.

The LeNet-sized net and solver of tests/test_driver.py (a TRAIN and a
TEST MemoryData layer on seeded LMDBs, Accuracy at TEST) go through both
CLIs from one -weights file:
  * `-train -test`: the port's `validation.json` rows match the JAX
    CLI's within rtol 1e-4 and `test_result` within 1e-5;
  * `-features ip2 -label label` on one -model: SampleIDs equal and rows
    within 1e-5, a ragged tail included, written as json and as parquet
    and read back;
  * `vector_mean` and `DataFrame.select` against the JAX package's;
  * `-mesh 2` with a validating solver, -test or -features writes what
    the run without -mesh writes; an unknown -outputFormat is refused;
  * the digits gate: the port CLI trains LeNet on sklearn's bundled
    digits (`tools/datasets.py::build_digits`) past accuracy 0.8 and
    loss 0.5 in its last validation round.
No test here waits on a thread without a timeout or asserts on timing.
"""

import json
import os
import sys

import numpy as np
import pytest

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu.data.synthetic import make_images
from caffeonspark_tpu_torch import caffe_on_spark, checkpoint
from caffeonspark_tpu_torch.caffe_on_spark import DataFrame, vector_mean
from caffeonspark_tpu_torch.config import Config
from caffeonspark_tpu_torch.data import LmdbWriter
from caffeonspark_tpu_torch.processor import CaffeProcessor
from caffeonspark_tpu_torch.proto.caffe import Datum
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

NET = """name: "LeNetish"
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  include {{ phase: TRAIN }}
  source_class: "com.yahoo.ml.caffe.LMDB"
  memory_data_param {{ source: "{train}" batch_size: 16
    channels: 1 height: 28 width: 28 }}
  transform_param {{ scale: 0.00390625 mirror: true }} }}
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  include {{ phase: TEST }}
  source_class: "com.yahoo.ml.caffe.LMDB"
  memory_data_param {{ source: "{test}" batch_size: 16
    channels: 1 height: 28 width: 28 }}
  transform_param {{ scale: 0.00390625 }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param {{ num_output: 12 kernel_size: 5 stride: 2
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }}
layer {{ name: "ip1" type: "InnerProduct" bottom: "conv1" top: "ip1"
  inner_product_param {{ num_output: 64
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "relu2" type: "ReLU" bottom: "ip1" top: "ip1" }}
layer {{ name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param {{ num_output: 10
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "accuracy" type: "Accuracy" bottom: "ip2" bottom: "label"
  top: "accuracy" include {{ phase: TEST }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip2"
  bottom: "label" top: "loss" }}
"""

SOLVER = """net: "{net}"
test_iter: {test_iter}
test_interval: {test_interval}
base_lr: 0.01
momentum: 0.9
weight_decay: 0.0005
lr_policy: "inv"
gamma: 0.0001
power: 0.75
display: 25
max_iter: {max_iter}
snapshot: 0
snapshot_prefix: "lenetish"
random_seed: 42
"""


def write_lmdb(path, n, seed):
    imgs, labels = make_images(n, seed=seed)
    LmdbWriter(str(path)).write([(b"%08d" % i, Datum(
        channels=1, height=28, width=28,
        data=(imgs[i, 0] * 255).astype(np.uint8).tobytes(),
        label=int(labels[i])).to_binary()) for i in range(n)])


def write_config(tmp_path, max_iter=20, test_interval=10, test_iter=4,
                 n_test=72):
    """LMDBs of 160 train and `n_test` test records (72: four batches of
    16 and a tail of 8), the net and the solver; returns the solver."""
    if not (tmp_path / "train_lmdb").exists():
        write_lmdb(tmp_path / "train_lmdb", 160, seed=5)
        write_lmdb(tmp_path / "test_lmdb", n_test, seed=99)
    net = tmp_path / "net.prototxt"
    net.write_text(NET.format(train=tmp_path / "train_lmdb",
                              test=tmp_path / "test_lmdb"))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(SOLVER.format(net=net, max_iter=max_iter,
                                    test_interval=test_interval,
                                    test_iter=test_iter))
    return str(solver)


def init_model(tmp_path, solver):
    conf = Config(["-conf", solver, "-device", "cpu"])
    s = Solver(conf.solverParameter, conf.netParam, device="cpu")
    path = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(path, s.train_net, s.train_net.init(21))
    return path


def read_json_rows(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def read_parquet_rows(path):
    import pyarrow.parquet as pq
    return pq.read_table(path).to_pylist()


def test_cli_train_with_validation_and_test_match_jax(tmp_path, capsys):
    """-train -test through both CLIs from one -weights file: two
    validation rounds of (accuracy, loss) within rtol 1e-4, test_result
    within 1e-5, the port's printed on stdout too."""
    solver = write_config(tmp_path)
    init = init_model(tmp_path, solver)
    assert caffe_on_spark.main(["-conf", solver, "-train", "-test",
                                "-weights", init, "-output",
                                str(tmp_path / "t"), "-device",
                                "cpu"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_cos.main(["-conf", solver, "-train", "-test", "-weights",
                         init, "-output", str(tmp_path / "j"),
                         "-devices", "1"]) == 0
    got = read_json_rows(tmp_path / "t" / "validation.json")
    want = read_json_rows(tmp_path / "j" / "validation.json")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["accuracy", "loss"]
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    res = json.loads(open(tmp_path / "t" / "test_result").read())
    assert json.loads(printed) == res
    ref = json.loads(open(tmp_path / "j" / "test_result").read())
    assert sorted(res) == sorted(ref) == ["accuracy", "loss"]
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert os.path.exists(tmp_path / "t" / "model.caffemodel")


def test_cli_features_match_jax_json_and_parquet(tmp_path):
    """-features ip2 -label label over the 72 TEST records (a ragged tail
    of 8) on one -model: the port's json and parquet rows against the
    JAX CLI's parquet rows."""
    solver = write_config(tmp_path)
    model = init_model(tmp_path, solver)
    args = ["-conf", solver, "-features", "ip2", "-label", "label",
            "-model", model]
    for fmt in ("json", "parquet"):
        assert caffe_on_spark.main([*args, "-output", str(tmp_path / fmt),
                                    "-outputFormat", fmt,
                                    "-device", "cpu"]) == 0
    assert jax_cos.main([*args, "-output", str(tmp_path / "j"),
                         "-outputFormat", "parquet", "-devices", "1"]) == 0
    want = read_parquet_rows(tmp_path / "j" / "features.parquet")
    assert len(want) == 72
    for got in (read_json_rows(tmp_path / "json" / "features.json"),
                read_parquet_rows(tmp_path / "parquet" /
                                  "features.parquet")):
        assert [r["SampleID"] for r in got] == \
            [r["SampleID"] for r in want] == ["%08d" % i for i in range(72)]
        for g, w in zip(got, want):
            assert sorted(g) == ["SampleID", "ip2", "label"]
            np.testing.assert_allclose(g["ip2"], w["ip2"], rtol=1e-5,
                                       atol=1e-5)
            assert g["label"] == w["label"]


def test_cli_test_after_training_uses_the_trained_model(tmp_path):
    """-train -test's result equals a -test run of the model it wrote,
    and -test alone on -weights uses those weights."""
    solver = write_config(tmp_path, max_iter=10, test_interval=10,
                          test_iter=1)
    init = init_model(tmp_path, solver)
    out = tmp_path / "a"
    assert caffe_on_spark.main(["-conf", solver, "-train", "-test",
                                "-weights", init, "-output", str(out),
                                "-device", "cpu"]) == 0
    after = json.loads(open(out / "test_result").read())
    assert caffe_on_spark.main(["-conf", solver, "-test", "-weights",
                                str(out / "model.caffemodel"), "-output",
                                str(tmp_path / "b"), "-device",
                                "cpu"]) == 0
    again = json.loads(open(tmp_path / "b" / "test_result").read())
    assert again == after
    assert caffe_on_spark.main(["-conf", solver, "-test", "-weights", init,
                                "-output", str(tmp_path / "c"), "-device",
                                "cpu"]) == 0
    before = json.loads(open(tmp_path / "c" / "test_result").read())
    assert before["loss"] != after["loss"]


def test_cli_train_makes_its_output_directory(tmp_path):
    """-train with no snapshot before the end writes its final model and
    validation rows into an -output directory it has to make."""
    solver = write_config(tmp_path, max_iter=4, test_interval=2,
                          test_iter=1)
    with open(solver, "a") as f:
        f.write("snapshot_after_train: false\n")
    out = tmp_path / "new" / "out"
    assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                str(out), "-device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["model.caffemodel",
                                       "validation.json"]
    assert len(read_json_rows(out / "validation.json")) == 2


def test_vector_mean_and_select_match_jax():
    rng = np.random.RandomState(4)
    rows = [{"SampleID": str(i), "f": rng.rand(5).tolist(),
             "label": float(i % 3)} for i in range(7)]
    got, want = DataFrame(rows), jax_cos.DataFrame(rows)
    assert got.columns == want.columns == ["SampleID", "f", "label"]
    assert vector_mean(got, "f") == jax_cos.vector_mean(want, "f")
    assert vector_mean(DataFrame([]), "f") == []
    sel = got.select("SampleID", "label")
    assert sel.columns == ["SampleID", "label"]
    assert sel.collect() == want.select("SampleID", "label").collect()
    assert len(sel) == 7


def test_parquet_needs_pyarrow_and_formats_are_checked(tmp_path,
                                                       monkeypatch):
    """Without pyarrow a parquet write fails naming it (the card's
    machine has none); an unknown -outputFormat is refused up front."""
    df = DataFrame([{"SampleID": "a", "f": [1.0]}])
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="pyarrow"):
        df.write(str(tmp_path / "x.parquet"), "parquet")
    with pytest.raises(ValueError, match="outputFormat 'xml'"):
        df.write(str(tmp_path / "x.xml"), "xml")
    solver = write_config(tmp_path)
    with pytest.raises(ValueError, match="^-outputFormat 'csv'"):
        caffe_on_spark.main(["-conf", solver, "-features", "ip2",
                             "-outputFormat", "csv", "-device", "cpu"])


@pytest.mark.parametrize("args,what", [
    (["-train"], "a validating solver"),
    (["-train", "-test"], "-test"),
    (["-features", "ip2"], "-features")])
def test_mesh_with_evaluation_is_refused(tmp_path, args, what):
    """Evaluation runs on a mesh (it was refused before the data-parallel
    slice): -mesh 2 with a validating solver, -test or -features splits
    each batch over 2 dp ranks, and what it writes equals the run
    without -mesh (validation rows and test_result within 1e-5, feature
    rows within 1e-5)."""
    solver = write_config(tmp_path, max_iter=10, test_interval=5,
                          test_iter=2)
    init = init_model(tmp_path, solver)
    weights = ["-model" if what == "-features" else "-weights", init]
    outs = {}
    for key, mesh in (("mesh", ["-mesh", "2"]), ("one", [])):
        outs[key] = tmp_path / key
        assert caffe_on_spark.main(["-conf", solver, *args, *weights,
                                    *mesh, "-output", str(outs[key]),
                                    "-device", "cpu"]) == 0
    name = {"a validating solver": "validation.json",
            "-test": "test_result", "-features": "features.json"}[what]
    got = read_json_rows(outs["mesh"] / name)
    want = read_json_rows(outs["one"] / name)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "SampleID":
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


@pytest.mark.parametrize("threads", ["0", "2"])
def test_validation_stall_fails_loudly(tmp_path, monkeypatch, threads):
    """A round whose batches never come fails with the stall error
    instead of shrinking silently (the timeout cut to 0.5 s), packed
    inline or on the pool."""
    monkeypatch.setenv("COS_TRANSFORM_THREADS", threads)
    monkeypatch.setattr(CaffeProcessor, "VALIDATION_STALL_TIMEOUT", 0.5)
    solver = write_config(tmp_path, max_iter=10, test_interval=10,
                          test_iter=4)
    conf = Config(["-conf", solver, "-train", "-device", "cpu"])
    proc = CaffeProcessor.instance(conf)
    proc.interleave_validation = True
    proc.start()
    src = caffe_on_spark.get_source(conf.train_data_layer(),
                                    phase_train=True)
    val = caffe_on_spark.get_source(conf.test_data_layer())
    try:
        for rec in list(src.records())[:160]:
            assert proc.feed_queue(0, rec)
        for rec in list(val.records())[:16]:     # one batch of four
            assert proc.feed_queue(1, rec)
    finally:
        proc.queues[0].offer(None, timeout=5)
    proc._thread.join(timeout=120)
    assert not proc._thread.is_alive()
    with pytest.raises(RuntimeError, match="validation feed stalled: 1/4"):
        proc.stop()


def test_digits_gate(tmp_path):
    """The port CLI trains the reference's LeNet on sklearn's digits;
    its last validation round clears accuracy 0.8 and loss 0.5."""
    from caffeonspark_tpu.tools.datasets import (build_digits,
                                                 emit_lenet_configs)
    build_digits(str(tmp_path))
    emit_lenet_configs(str(tmp_path))
    solver = tmp_path / "lenet_solver.prototxt"
    text = solver.read_text()
    for old, new in (("max_iter: 1000", "max_iter: 200"),
                     ("test_iter: 10", "test_iter: 2"),
                     ("snapshot: 500", "snapshot: 0")):
        text = text.replace(old, new)
    solver.write_text(text)
    out = tmp_path / "out"
    assert caffe_on_spark.main(["-conf", str(solver), "-train", "-output",
                                str(out), "-device", "cpu"]) == 0
    rounds = read_json_rows(out / "validation.json")
    assert len(rounds) == 2
    assert rounds[-1]["accuracy"] >= 0.8, rounds
    assert rounds[-1]["loss"] <= 0.5, rounds
