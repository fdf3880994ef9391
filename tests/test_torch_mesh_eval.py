"""Evaluation on a mesh, and the CLIs' `-mesh dp[,tp[,sp]]`, against the
JAX package, on the CPU.

  * `-train -mesh 2` with interleaved validation, then `-test` and
    `-features ip2 -label label` of the model it wrote, through the
    port's CLI and the JAX CLI (`-devices 2 -mesh 2`, its dp 2 on two
    virtual devices) from one -weights file: validation rows rtol 1e-4,
    test_result and feature rows 1e-5, the final models 1e-4; the
    metrics' `info.mesh`;
  * `mini_cluster -mesh 2` (a bare count is dp 2) against the JAX
    `mini_cluster -mesh 2`: the final model and the validation rows;
  * the evaluation forward (`BlobForward(net, layout)`) at dp 2 and 4
    equal to dp 1's on a net whose loss and Accuracy ignore a label, so
    that their normalizers must be the whole batch's;
  * snapshots from a ZeRO-1 mesh: the `.solverstate` has dp 1's layout
    (it equals the plain dp 2 run's), and `-snapshot` resumes onto the
    mesh by splitting again, to the model of the same resume on dp 1;
  * `-serve -mesh` and a TEST batch dp does not divide are refused by
    name before a step.
"""

import json
import os

import numpy as np
import pytest
import torch

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu import mini_cluster as jax_mini_cluster
from caffeonspark_tpu_torch import caffe_on_spark, checkpoint, mini_cluster
from caffeonspark_tpu_torch.parallel import (MeshLayout, ParallelSolver,
                                             build_mesh)
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.serving.forward import BlobForward
from caffeonspark_tpu_torch.solver import Solver
from test_torch_driver import (init_model, read_json_rows,
                               read_parquet_rows, write_config)
from torch_common import cap_torch_threads

cap_torch_threads()

CPU = torch.device("cpu")


def _blobs_close(got_path, want_path, rtol, load_want, atol=1e-6):
    got = checkpoint.load_caffemodel_blobs(str(got_path))
    want = load_want(str(want_path))
    assert set(got) == set(want)
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=ln)


def test_cli_train_mesh_validation_test_features_match_jax(tmp_path,
                                                           monkeypatch):
    solver = write_config(tmp_path)
    init = init_model(tmp_path, solver)
    metrics = str(tmp_path / "m.json")
    monkeypatch.setenv("COS_PIPELINE_METRICS", metrics)
    assert caffe_on_spark.main(["-conf", solver, "-train", "-test",
                                "-weights", init, "-output",
                                str(tmp_path / "t"), "-device", "cpu",
                                "-mesh", "2"]) == 0
    monkeypatch.delenv("COS_PIPELINE_METRICS")
    with open(metrics) as f:
        assert json.load(f)["info"]["mesh"] == {
            "axes": {"dp": 2}, "devices": 2, "sharded_params": []}
    assert jax_cos.main(["-conf", solver, "-train", "-test", "-weights",
                         init, "-output", str(tmp_path / "j"), "-devices",
                         "2", "-mesh", "2"]) == 0
    got = read_json_rows(tmp_path / "t" / "validation.json")
    want = read_json_rows(tmp_path / "j" / "validation.json")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["accuracy", "loss"]
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    res = json.loads(open(tmp_path / "t" / "test_result").read())
    ref = json.loads(open(tmp_path / "j" / "test_result").read())
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    _blobs_close(tmp_path / "t" / "model.caffemodel",
                 tmp_path / "j" / "model.caffemodel", 1e-4,
                 jax_ckpt.load_caffemodel_blobs)

    # -features of one model on both meshes: 72 rows, a ragged tail of 8
    model = str(tmp_path / "t" / "model.caffemodel")
    args = ["-conf", solver, "-features", "ip2", "-label", "label",
            "-model", model, "-mesh", "2"]
    assert caffe_on_spark.main([*args, "-output", str(tmp_path / "tf"),
                                "-device", "cpu"]) == 0
    assert jax_cos.main([*args, "-output", str(tmp_path / "jf"),
                         "-outputFormat", "parquet", "-devices", "2"]) == 0
    got = read_json_rows(tmp_path / "tf" / "features.json")
    want = read_parquet_rows(tmp_path / "jf" / "features.parquet")
    assert [r["SampleID"] for r in got] == [r["SampleID"] for r in want] \
        == ["%08d" % i for i in range(72)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["ip2"], w["ip2"], rtol=1e-5,
                                   atol=1e-5)
        assert g["label"] == w["label"]


def test_mini_cluster_mesh_matches_jax(tmp_path):
    """mini_cluster -mesh 2 of the port against the JAX mini_cluster
    -mesh 2 from one -weights file, validating on the mesh: the final
    models within 1e-4, the validation rows within 1e-4."""
    solver = write_config(tmp_path, max_iter=10, test_interval=5,
                          test_iter=2)
    init = init_model(tmp_path, solver)
    common = ["-solver", solver, "-weights", init, "-mesh", "2"]
    assert mini_cluster.main([*common, "-output", str(tmp_path / "t"),
                              "-model", str(tmp_path / "t.caffemodel"),
                              "-device", "cpu"]) == 0
    assert jax_mini_cluster.main([*common, "-output", str(tmp_path / "j"),
                                  "-model",
                                  str(tmp_path / "j.caffemodel")]) == 0
    _blobs_close(tmp_path / "t.caffemodel", tmp_path / "j.caffemodel", 1e-4,
                 jax_ckpt.load_caffemodel_blobs)
    got = read_json_rows(tmp_path / "t" / "validation.json")
    want = read_json_rows(tmp_path / "j" / "validation.json")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


IGNORE_NET = """
name: "ignore"
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 2 height: 5 width: 5 } }
layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" loss_param { ignore_label: 3 } }
layer { name: "acc" type: "Accuracy" bottom: "fc" bottom: "label"
  top: "acc" accuracy_param { ignore_label: 3 } }
layer { name: "acc2" type: "Accuracy" bottom: "fc" bottom: "label"
  top: "acc2" accuracy_param { top_k: 2 } }
"""


@pytest.mark.parametrize("dp", [2, 4])
def test_eval_forward_on_mesh_equals_dp1(dp):
    """The evaluation forward under a dp layout: the loss and the
    Accuracy with ignore_label divide by the whole batch's valid count
    (labels 3 fall unevenly over the ranks), Accuracy top-2 by the whole
    batch; fc rows come back in row order."""
    s = Solver(SolverParameter.from_text("base_lr: 0.1"),
               NetParameter.from_text(IGNORE_NET), device="cpu")
    net = s.test_net
    params = s.train_net.init(3)
    rng = np.random.RandomState(1)
    inputs = {"data": torch.from_numpy(rng.randn(8, 2, 5, 5).astype(
                  np.float32)),
              "label": torch.tensor([3, 3, 3, 0, 1, 2, 3, 1],
                                    dtype=torch.float32)}
    names = ("loss", "acc", "acc2", "fc")
    one = BlobForward(net)(names)(params, inputs)
    layout = MeshLayout(s.train_net, build_mesh(dp=dp, devices=[CPU] * dp))
    got = BlobForward(net, layout=layout)(names)(params, inputs)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), one[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    # the ranks' own normalizers would give another loss
    assert float(one["loss"]) != pytest.approx(
        float(torch.nn.functional.cross_entropy(
            one["fc"][4:], inputs["label"][4:].long(), ignore_index=3)))


def test_zero_snapshot_has_dp1_layout_and_resumes_on_the_mesh(tmp_path,
                                                               monkeypatch):
    """-train -mesh 2 under COS_ZERO=1 with a snapshot at 5 of 10 steps:
    the snapshot's state file and model equal the plain -mesh 2 run's
    (dp 1's layout, the ZeRO state gathered); -snapshot of it under
    COS_ZERO=1 -mesh 2 splits the state again and trains to the final
    model of the run that did not stop."""
    solver = write_config(tmp_path, max_iter=10, test_interval=0,
                          test_iter=0)
    with open(solver, "a") as f:
        f.write("snapshot: 5\n")
    init = init_model(tmp_path, solver)

    def train(out, zero, *extra):
        if zero:
            monkeypatch.setenv("COS_ZERO", "1")
        else:
            monkeypatch.delenv("COS_ZERO", raising=False)
        assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                    str(tmp_path / out), "-device", "cpu",
                                    "-mesh", "2", *extra]) == 0

    train("z", True, "-weights", init)
    train("p", False, "-weights", init)
    for name in ("lenetish_iter_5.solverstate",
                 "lenetish_iter_5.caffemodel"):
        a = checkpoint._read_state if name.endswith("state") else None
        if a is None:
            _blobs_close(tmp_path / "z" / name, tmp_path / "p" / name,
                         1e-6, checkpoint.load_caffemodel_blobs, atol=1e-8)
            continue
        it_z, _, hz = a(str(tmp_path / "z" / name))
        it_p, _, hp = a(str(tmp_path / "p" / name))
        assert it_z == it_p == 5 and len(hz) == len(hp)
        for x, y in zip(hz, hp):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-8)
    snap = str(tmp_path / "z" / "lenetish_iter_5.solverstate")
    train("r", True, "-snapshot", snap)
    monkeypatch.delenv("COS_ZERO", raising=False)
    assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                str(tmp_path / "r1"), "-device", "cpu",
                                "-snapshot", snap]) == 0
    _blobs_close(tmp_path / "r" / "model.caffemodel",
                 tmp_path / "r1" / "model.caffemodel", 1e-5,
                 checkpoint.load_caffemodel_blobs, atol=1e-7)


@pytest.mark.parametrize("argv,match", [
    (["-serve", "-model", "m.caffemodel", "-mesh", "2"],
     "serving on a mesh is ROADMAP Queue 1 item 7"),
    (["-test", "-mesh", "3"], "layer 'data': batch 16 .*dp axis"),
    (["-train", "-clusterSize", "2"], "-clusterSize 2"),
    (["-train", "-devices", "2"], "-devices 2")])
def test_mesh_refusals_by_name(tmp_path, argv, match):
    """Serving on a mesh (item 7) waits, a batch of 16 over dp 3 is
    refused naming its layer; -clusterSize and -devices above 1
    (items 6b and 6c) are refused by name before a step runs."""
    solver = write_config(tmp_path)
    with pytest.raises(ValueError, match=match):
        caffe_on_spark.main(["-conf", solver, *argv, "-output",
                             str(tmp_path / "out"), "-device", "cpu"])
    assert not os.path.exists(tmp_path / "out")


def test_parallel_solver_refuses_test_batch_at_eval(tmp_path):
    """A TEST batch that dp does not divide is refused when the
    evaluation forward is made, naming the TEST layer, while the TRAIN
    batch trains."""
    text = IGNORE_NET.replace(
        "layer { name: \"data\"",
        "layer { name: \"tdata\" type: \"MemoryData\" top: \"data\" top: "
        "\"label\" include { phase: TEST } memory_data_param { batch_size: "
        "6 channels: 2 height: 5 width: 5 } }\nlayer { include { phase: "
        "TRAIN } name: \"data\"", 1)
    s = Solver(SolverParameter.from_text("base_lr: 0.1"),
               NetParameter.from_text(text), device="cpu")
    ps = ParallelSolver(s, build_mesh(dp=4, devices=[CPU] * 4))
    with pytest.raises(ValueError, match="layer 'tdata': batch 6"):
        ps.eval_step()
