"""The rest of checkpoint.py in the PyTorch port, against the JAX
package's files: HDF5 snapshots, the sharded sidecars, the write-behind
snapshotter and the quant sidecar.

  * HDF5: model and state round trips; a JAX-written `.h5` resumes in
    the port to the params and history JAX's own `restore` gives, and
    the other way round; the CLI with `snapshot_format: HDF5` writes
    `_iter_N.caffemodel.h5` / `.solverstate.h5` and `-snapshot` resumes
    from them to the final model of the same run in binaryproto;
    `mini_cluster -model x.caffemodel.h5` writes an HDF5 model;
  * HDF5 where h5py is missing: the CLI and mini_cluster refuse it by
    name before step 1 and leave no file;
  * sharded: the JAX package's `save_sharded_caffemodel(force_shards=
    True)` and `snapshot(force_shards=True)` load in the port equal to
    the dense values; sidecars that are gone, of two generations or
    short of a slab are refused by name;
  * the streamed encoder every snapshot writes with gives the bytes of
    `to_binary()` and of the JAX package;
  * write-behind (`AsyncSnapshotter`, -async_snapshot): its files are
    byte-equal to the synchronous ones; a `submit` followed by an
    in-place `train_step` still writes the values of the submit; an
    error surfaces as RuntimeError on the next `wait` or `submit`;
    `close` joins the worker; the CLI with and without -async_snapshot
    writes byte-equal files.  The thread tests wait with a timeout and
    assert no timing;
  * quant sidecar: the port's and the JAX package's files cross in both
    directions (int8, bf16 as uint16 bit patterns, the scales); a
    registry loading `<model>.quant` serves the rows of the f32 load
    followed by quantization, without loading the f32 file; a sidecar of
    another weight dtype is ignored with a warning; exporting a model
    resident in f32 is refused.

Every comparison of values is exact: the files hold f32 (or int8 /
bf16) bits, and nothing is recomputed.
"""

import filecmp
import logging
import os
import sys
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.solver import OptState as JaxOptState
from caffeonspark_tpu_torch import (caffe_on_spark, checkpoint, convert,
                                    mini_cluster)
from caffeonspark_tpu_torch.data import LmdbWriter
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.proto.caffe import Datum, SnapshotFormat
from caffeonspark_tpu_torch.serving import quant
from caffeonspark_tpu_torch.serving.registry import (ModelRegistry,
                                                     build_serving_net)
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

WAIT_S = 60

# conv -> BatchNorm -> Scale -> ReLU -> InnerProduct: the running
# statistics ride in every snapshot
TINY_NET = """name: "TinyBN"
layer {{
  name: "data" type: "MemoryData" top: "data" top: "label"
  source_class: "com.yahoo.ml.caffe.LMDB"
  transform_param {{ scale: 0.00390625 }}
  memory_data_param {{ batch_size: 4 channels: 1 height: 6 width: 6
                      source: "{src}" }}
}}
layer {{ name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param {{ num_output: 4 kernel_size: 3 bias_term: false
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "bn" type: "BatchNorm" bottom: "conv" top: "conv" }}
layer {{ name: "sc" type: "Scale" bottom: "conv" top: "conv"
  scale_param {{ bias_term: true }} }}
layer {{ name: "relu" type: "ReLU" bottom: "conv" top: "conv" }}
layer {{ name: "ip" type: "InnerProduct" bottom: "conv" top: "ip"
  inner_product_param {{ num_output: 10 weight_filler {{ type: "xavier" }}
  }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }}
"""
SOLVER = ('base_lr: 0.05 momentum: 0.9 weight_decay: 0.0005 '
          'lr_policy: "fixed" random_seed: 5 ')


def _setup(tmp_path, max_iter=4, extra=""):
    src = tmp_path / "lmdb"
    if not src.exists():
        rng = np.random.RandomState(3)
        LmdbWriter(str(src)).write([(b"%08d" % i, Datum(
            channels=1, height=6, width=6,
            data=rng.randint(0, 256, 36).astype(np.uint8).tobytes(),
            label=int(rng.randint(10))).to_binary()) for i in range(32)])
    net = tmp_path / "net.prototxt"
    net.write_text(TINY_NET.format(src=src))
    solver = tmp_path / f"solver_{max_iter}.prototxt"
    solver.write_text(f'net: "{net}"\n{SOLVER}\nmax_iter: {max_iter}\n'
                      f'snapshot: 2\n{extra}')
    return str(solver), net.read_text()


def _trained(tmp_path, solver_text=SOLVER + 'type: "Adam"', steps=2):
    """A port solver (Adam: history and history2) after a few steps."""
    _, text = _setup(tmp_path)
    s = Solver(SolverParameter.from_text(solver_text),
               NetParameter.from_text(text), device="cpu")
    params, st = s.init()
    rng = np.random.RandomState(4)
    for _ in range(steps):
        s.train_step(params, st, {
            "data": torch.from_numpy(rng.rand(4, 1, 6, 6)
                                     .astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 10, 4)
                                      .astype(np.float32))})
    return s, params, st, text


def _jax(text, params, st):
    jnet = JaxNet(JaxNetParameter.from_text(text), JaxNetState(phase=0))

    def tree(p):
        return {ln: {bn: jnp.asarray(t.numpy()) for bn, t in bl.items()}
                for ln, bl in p.items()}

    return jnet, tree(params), JaxOptState(
        iter=jnp.asarray(st.iter, jnp.int32), history=tree(st.history),
        history2=tree(st.history2))


def _same_params(got, want, what=""):
    assert set(got) == set(want)
    for ln in want:
        assert set(got[ln]) == set(want[ln]), ln
        for bn in want[ln]:
            g = got[ln][bn]
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            assert np.array_equal(g, np.asarray(want[ln][bn])), \
                f"{what} {ln}/{bn}"


def _fresh(s):
    p = s.train_net.init(99)
    return p, s.init_state(p)


# ---------------------------------------------------------------------------
# HDF5
# ---------------------------------------------------------------------------

def test_h5_model_and_state_round_trip(tmp_path):
    s, params, st, _ = _trained(tmp_path)
    prefix = str(tmp_path / "h5" / "m")
    model, state = checkpoint.snapshot(s.train_net, params, st, prefix,
                                       fmt=SnapshotFormat.HDF5,
                                       solver_type="ADAM")
    assert model.endswith("_iter_2.caffemodel.h5")
    assert state.endswith("_iter_2.solverstate.h5")
    assert not [f for f in os.listdir(tmp_path / "h5") if ".tmp." in f]
    p0, st0 = _fresh(s)
    got_p, got_st = checkpoint.restore(s.train_net, p0, st0, state)
    assert got_st.iter == 2
    _same_params(got_p, params)
    _same_params(got_st.history, st.history)
    _same_params(got_st.history2, st.history2)
    # the model alone: copy_layers, load_serving_params (via the state)
    _same_params(checkpoint.copy_layers(s.train_net, p0, model), params)
    _same_params(checkpoint.load_serving_params(s.train_net, state),
                 params)


def test_jax_h5_resumes_in_the_port_and_back(tmp_path):
    s, params, st, text = _trained(tmp_path)
    jnet, jp, jst = _jax(text, params, st)
    jmodel, jstate = jax_ckpt.snapshot(
        jnet, jp, jst, str(tmp_path / "j" / "m"), fmt=SnapshotFormat.HDF5,
        solver_type="ADAM")
    jp2, jst2 = jax_ckpt.restore(jnet, jp, jst, jstate)
    p0, st0 = _fresh(s)
    tp, tst = checkpoint.restore(s.train_net, p0, st0, jstate)
    assert tst.iter == int(jst2.iter) == 2
    _same_params(tp, jp2, "params")
    _same_params(tst.history, jst2.history, "history")
    _same_params(tst.history2, jst2.history2, "history2")
    # the port's files in JAX
    _, tstate = checkpoint.snapshot(s.train_net, params, st,
                                    str(tmp_path / "t" / "m"),
                                    fmt=SnapshotFormat.HDF5,
                                    solver_type="ADAM")
    jp3, jst3 = jax_ckpt.restore(jnet, jp, jst, tstate)
    assert int(jst3.iter) == 2
    _same_params(jp3, convert.params_to_numpy(params), "params")
    _same_params(jst3.history, convert.params_to_numpy(st.history))
    _same_params(jst3.history2, convert.params_to_numpy(st.history2))


def _final(path):
    return checkpoint.load_caffemodel_blobs(path)


def test_cli_hdf5_snapshots_and_resume(tmp_path):
    """The same run in binaryproto and HDF5: snapshots under both names,
    -snapshot resumes from either to the same final model."""
    finals = {}
    for fmt in ("BINARYPROTO", "HDF5"):
        solver, _ = _setup(tmp_path, 2, f"snapshot_format: {fmt}\n")
        out = tmp_path / fmt
        assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                    str(out), "-device", "cpu"]) == 0
        ext = ".h5" if fmt == "HDF5" else ""
        assert sorted(os.listdir(out)) == [
            "model.caffemodel", f"model_iter_2.caffemodel{ext}",
            f"model_iter_2.solverstate{ext}"]
        solver4, _ = _setup(tmp_path, 4, f"snapshot_format: {fmt}\n")
        out2 = tmp_path / (fmt + "_resumed")
        assert caffe_on_spark.main([
            "-conf", solver4, "-train", "-snapshot",
            str(out / f"model_iter_2.solverstate{ext}"), "-output",
            str(out2), "-device", "cpu"]) == 0
        assert sorted(os.listdir(out2)) == [
            "model.caffemodel", f"model_iter_4.caffemodel{ext}",
            f"model_iter_4.solverstate{ext}"]
        finals[fmt] = _final(str(out2 / "model.caffemodel"))
        assert _final(str(out2 / f"model_iter_4.caffemodel{ext}")).keys() \
            == finals[fmt].keys()
    for ln, blobs in finals["BINARYPROTO"].items():
        for a, b in zip(blobs, finals["HDF5"][ln]):
            assert np.array_equal(a, b), ln


def test_mini_cluster_exports_an_h5_model(tmp_path):
    solver, text = _setup(tmp_path, 2)
    out = tmp_path / "mc"
    model = str(out / "final.caffemodel.h5")
    assert mini_cluster.main(["-solver", solver, "-output", str(out),
                              "-model", model, "-device", "cpu"]) == 0
    got = jax_ckpt._load_h5_blobs(model)
    want = _final(str(out / "model_iter_2.caffemodel"))
    assert set(got) == set(want) == {"conv", "bn", "sc", "ip"}
    for ln in want:
        for a, b in zip(got[ln], want[ln]):
            assert np.array_equal(a, b), ln
    assert float(got["bn"][2][0]) > 0          # the statistics moved


# ---------------------------------------------------------------------------
# sharded sidecars
# ---------------------------------------------------------------------------

def test_jax_sharded_files_load_in_the_port(tmp_path):
    s, params, st, text = _trained(tmp_path)
    jnet, jp, jst = _jax(text, params, st)
    model = str(tmp_path / "j" / "sharded.caffemodel")
    os.makedirs(os.path.dirname(model))
    jax_ckpt.save_sharded_caffemodel(model, jnet, jp, force_shards=True)
    assert os.path.exists(model + ".shard0")
    dense = convert.params_to_numpy(params)
    got = checkpoint.load_caffemodel_blobs(model)
    for ln, specs in s.train_net.param_layout.items():
        for (bn, _, _), arr in zip(specs, got[ln]):
            assert np.array_equal(arr, dense[ln][bn]), f"{ln}/{bn}"
    p0, st0 = _fresh(s)
    _same_params(checkpoint.copy_layers(s.train_net, p0, model), dense)
    _same_params(checkpoint.load_serving_params(s.train_net, model), dense)
    _, jstate = jax_ckpt.snapshot(jnet, jp, jst, str(tmp_path / "j" / "s"),
                                  solver_type="ADAM", force_shards=True)
    assert os.path.exists(jstate + ".shard0")
    tp, tst = checkpoint.restore(s.train_net, p0, st0, jstate)
    assert tst.iter == 2
    _same_params(tp, dense)
    _same_params(tst.history, convert.params_to_numpy(st.history))
    _same_params(tst.history2, convert.params_to_numpy(st.history2))


def _jax_sharded_model(tmp_path):
    s, params, st, text = _trained(tmp_path)
    jnet, jp, _ = _jax(text, params, st)
    model = str(tmp_path / "j" / "sharded.caffemodel")
    os.makedirs(os.path.dirname(model))
    jax_ckpt.save_sharded_caffemodel(model, jnet, jp, force_shards=True)
    return model


def _drop_first_slab(model):
    with np.load(model + ".shard0") as z:
        kept = {k: z[k] for k in z.files}
    del kept[min(k for k in kept if k.startswith("b"))]
    with open(model + ".shard0", "wb") as f:
        np.savez(f, **kept)


@pytest.mark.parametrize("fault,error,match", [
    ("no_sidecar", FileNotFoundError, "no sharded.caffemodel.shard"),
    ("stale_sidecar", ValueError, "mixed-generation"),
    ("missing_slab", ValueError, "a shard file is missing"),
])
def test_broken_sidecars_are_refused(tmp_path, fault, error, match):
    """A JAX sharded model whose sidecars are gone, of two generations,
    or short of a slab is refused by name, never read with zeros."""
    model = _jax_sharded_model(tmp_path)
    if fault == "no_sidecar":
        os.remove(model + ".shard0")
    elif fault == "stale_sidecar":
        with open(model + ".shard0", "rb") as f:
            data = f.read()
        with open(model + ".shard1", "wb") as f:
            f.write(data)
    else:
        _drop_first_slab(model)
    with pytest.raises(error, match=match):
        checkpoint.load_caffemodel_blobs(model)


@pytest.mark.parametrize("entry", ["cli", "mini_cluster",
                                   "mini_cluster_h5_model"])
def test_hdf5_without_h5py_is_refused_before_the_first_step(
        tmp_path, monkeypatch, entry):
    """Where h5py is missing (the card's machine), an HDF5 solver, or
    mini_cluster's `-model x.caffemodel.h5` under a binaryproto one, is
    refused by name before step 1, and no model or snapshot file is
    left; it is never written in another format."""
    monkeypatch.setitem(sys.modules, "h5py", None)    # import raises
    h5_model = entry == "mini_cluster_h5_model"
    solver, _ = _setup(tmp_path, 4,
                       "" if h5_model else "snapshot_format: HDF5\n")
    steps = []
    real = Solver.train_step
    monkeypatch.setattr(Solver, "train_step",
                        lambda self, *a: steps.append(1) or real(self, *a))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="need the h5py package"):
        if entry == "cli":
            caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                 str(out), "-device", "cpu"])
        else:
            mini_cluster.main(["-solver", solver, "-output", str(out),
                               "-device", "cpu"]
                              + (["-model", str(out / "m.caffemodel.h5")]
                                 if h5_model else []))
    assert steps == []
    assert not out.exists() or os.listdir(out) == []


# ---------------------------------------------------------------------------
# write-behind snapshots
# ---------------------------------------------------------------------------

def test_streamed_encoding_equals_the_jax_bytes(tmp_path):
    """`Message.write_to` (the file writes of every snapshot: float
    arrays from their buffers) gives `to_binary()`'s bytes, which are the
    JAX package's for the same model and state."""
    s, params, st, text = _trained(tmp_path)
    jnet, jp, jst = _jax(text, params, st)
    model = checkpoint.params_to_net_param(s.train_net, params)
    want = jax_ckpt.params_to_net_param(jnet, jp).to_binary()
    assert model.to_binary() == want
    path = tmp_path / "m.caffemodel"
    with open(path, "wb") as f:
        assert model.write_to(f) == len(want)
    assert path.read_bytes() == want
    _, jstate = jax_ckpt.snapshot(jnet, jp, jst, str(tmp_path / "j" / "m"),
                                  solver_type="ADAM")
    _, tstate = checkpoint.snapshot(s.train_net, params, st,
                                    str(tmp_path / "t" / "m"),
                                    solver_type="ADAM")
    with open(jstate, "rb") as a, open(tstate, "rb") as b:
        assert a.read() == b.read()


def _dir_equal(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert not [n for n in names if ".tmp." in n]
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


@pytest.mark.parametrize("fmt", ["BINARYPROTO", "HDF5"])
def test_async_files_equal_the_synchronous_ones(tmp_path, fmt):
    s, params, st, _ = _trained(tmp_path)
    f = getattr(SnapshotFormat, fmt)
    checkpoint.snapshot(s.train_net, params, st, str(tmp_path / "sync/m"),
                        fmt=f, solver_type="ADAM")
    snap = checkpoint.AsyncSnapshotter()
    try:
        done = snap.submit(s.train_net, params, st,
                           str(tmp_path / "async/m"), fmt=f,
                           solver_type="ADAM")
        snap.wait(timeout=WAIT_S)
        assert done.is_set()
    finally:
        snap.close()
    # h5py writes no timestamps: an HDF5 file's bytes are its values
    _dir_equal(tmp_path / "sync", tmp_path / "async")


def test_submit_then_in_place_step_writes_the_submitted_values(
        tmp_path, monkeypatch):
    """The solver updates params and history in place right after the
    submit; the worker, held back until then, still writes the values
    of the submit."""
    s, params, st, _ = _trained(tmp_path, SOLVER)
    checkpoint.snapshot(s.train_net, params, st, str(tmp_path / "sync/m"))
    gate = threading.Event()
    real = checkpoint.snapshot

    def gated(*a, **kw):
        assert gate.wait(WAIT_S)
        return real(*a, **kw)

    monkeypatch.setattr(checkpoint, "snapshot", gated)
    snap = checkpoint.AsyncSnapshotter()
    try:
        snap.submit(s.train_net, params, st, str(tmp_path / "async/m"))
        before = params["ip"]["weight"].clone()
        rng = np.random.RandomState(8)
        s.train_step(params, st, {
            "data": torch.from_numpy(rng.rand(4, 1, 6, 6)
                                     .astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 10, 4)
                                      .astype(np.float32))})
        assert not torch.equal(before, params["ip"]["weight"])
        assert st.iter == 3
        gate.set()
        snap.wait(timeout=WAIT_S)
    finally:
        gate.set()
        snap.close()
    _dir_equal(tmp_path / "sync", tmp_path / "async")


def test_async_error_surfaces_on_the_next_wait_or_submit(tmp_path):
    s, params, st, _ = _trained(tmp_path, SOLVER)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    bad = str(blocker / "m")            # its directory cannot be made
    snap = checkpoint.AsyncSnapshotter()
    try:
        snap.submit(s.train_net, params, st, bad)
        with pytest.raises(RuntimeError, match="async snapshot failed"):
            snap.wait(timeout=WAIT_S)
        snap.wait(timeout=WAIT_S)        # the error was taken
        snap.submit(s.train_net, params, st, bad)
        with pytest.raises(RuntimeError, match="async snapshot failed"):
            snap.submit(s.train_net, params, st, str(tmp_path / "ok/m"))
        # after the error, the snapshotter goes on working
        snap.submit(s.train_net, params, st, str(tmp_path / "ok/m"))
        snap.wait(timeout=WAIT_S)
    finally:
        snap.close()
    assert sorted(os.listdir(tmp_path / "ok")) == [
        "m_iter_2.caffemodel", "m_iter_2.solverstate"]


def test_close_joins_the_worker(tmp_path):
    s, params, st, _ = _trained(tmp_path, SOLVER)
    snap = checkpoint.AsyncSnapshotter()
    snap.submit(s.train_net, params, st, str(tmp_path / "a/m"))
    thread = snap._thread
    assert thread is not None
    snap.close()
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive()
    assert snap._thread is None
    assert snap not in checkpoint._LIVE_SNAPSHOTTERS
    assert os.path.exists(tmp_path / "a" / "m_iter_2.solverstate")


def test_cli_async_snapshot_writes_the_same_files(tmp_path):
    solver, _ = _setup(tmp_path, 4)
    for name, extra in (("sync", []), ("async", ["-async_snapshot"])):
        assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                    str(tmp_path / name), "-device", "cpu",
                                    *extra]) == 0
    assert sorted(os.listdir(tmp_path / "async")) == [
        "model.caffemodel", "model_iter_2.caffemodel",
        "model_iter_2.solverstate", "model_iter_4.caffemodel",
        "model_iter_4.solverstate"]
    _dir_equal(tmp_path / "sync", tmp_path / "async")


# ---------------------------------------------------------------------------
# quant sidecar
# ---------------------------------------------------------------------------

SERVE_NET = """name: "Served"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 4 dim: 3 dim: 8 dim: 8 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 8 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.2 } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "fc1" type: "InnerProduct" bottom: "conv" top: "fc1"
  inner_product_param { num_output: 64
    weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "relu1" type: "ReLU" bottom: "fc1" top: "fc1" }
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.1 } } }
"""


def _registry(monkeypatch, wd):
    monkeypatch.setenv("COS_SERVE_WEIGHT_DTYPE", wd)
    return ModelRegistry(build_serving_net(NetParameter.from_text(SERVE_NET),
                                           device="cpu"))


def _model(tmp_path):
    net = build_serving_net(NetParameter.from_text(SERVE_NET),
                            device="cpu")
    path = str(tmp_path / "served.caffemodel")
    checkpoint.save_caffemodel(path, net, net.init(3))
    return path


def _rows(reg, mv):
    x = torch.from_numpy(np.random.RandomState(1).rand(4, 3, 8, 8)
                         .astype(np.float32))
    return reg.forward(("fc2",), weight_dtype=mv.weight_dtype)(
        mv.params, mv.scales or {}, {"data": x})["fc2"]


@pytest.mark.parametrize("wd", ["int8", "bf16"])
def test_registry_serves_from_the_sidecar(tmp_path, monkeypatch, wd):
    model = _model(tmp_path)
    reg = _registry(monkeypatch, wd)
    mv = reg.load(model)
    assert mv.weight_dtype == wd
    sidecar = reg.export_quant_sidecar(model)
    assert sidecar == model + ".quant"
    want = _rows(reg, mv)
    # a second replica: the f32 file, the quantization and the drift
    # gate are never reached
    reg2 = _registry(monkeypatch, wd)

    def forbidden(*a, **k):
        raise AssertionError("the f32 model was loaded or quantized")

    monkeypatch.setattr(checkpoint, "load_serving_params", forbidden)
    monkeypatch.setattr(quant, "compress_params", forbidden)
    mv2 = reg2.load(model)
    assert mv2.weight_dtype == wd and mv2.nbytes == mv.nbytes
    assert torch.equal(_rows(reg2, mv2), want)
    for ln, bl in mv.params.items():
        for bn, t in bl.items():
            assert torch.equal(mv2.params[ln][bn], t), f"{ln}/{bn}"
    if wd == "int8":
        assert mv2.params["fc1"]["weight"].dtype == torch.int8
        assert torch.equal(mv2.scales["fc1"]["weight"],
                           mv.scales["fc1"]["weight"])


def test_sidecar_of_another_dtype_is_ignored_with_a_warning(
        tmp_path, monkeypatch, caplog):
    model = _model(tmp_path)
    reg = _registry(monkeypatch, "int8")
    reg.load(model)
    reg.export_quant_sidecar(model)
    fresh = _registry(monkeypatch, "bf16")
    want = _rows(fresh, fresh.publish(checkpoint.load_serving_params(
        fresh.net, model), model))
    reg2 = _registry(monkeypatch, "bf16")
    with caplog.at_level(logging.WARNING):
        mv = reg2.load(model)
    assert "ignoring sidecar" in caplog.text
    assert mv.weight_dtype == "bf16"
    assert torch.equal(_rows(reg2, mv), want)


def test_export_of_an_f32_model_is_refused(tmp_path, monkeypatch):
    model = _model(tmp_path)
    reg = _registry(monkeypatch, "f32")
    reg.load(model)
    with pytest.raises(ValueError, match="resident in f32"):
        reg.export_quant_sidecar(model)
    assert not os.path.exists(model + ".quant")


@pytest.mark.parametrize("wd", ["int8", "bf16"])
def test_sidecar_files_cross_between_the_packages(tmp_path, monkeypatch,
                                                  wd):
    model = _model(tmp_path)
    reg = _registry(monkeypatch, wd)
    mv = reg.load(model)
    path = reg.export_quant_sidecar(model)
    jblobs, jscales, jwd = jax_ckpt.load_quant_sidecar(path)
    assert jwd == wd
    for ln, bl in mv.params.items():
        for bn, t in bl.items():
            got = jblobs[ln][bn]
            if t.dtype == torch.bfloat16:
                assert got.dtype == ml_dtypes.bfloat16
                assert np.array_equal(
                    got.view(np.uint16),
                    t.view(torch.int16).numpy().view(np.uint16))
            else:
                assert np.array_equal(got, t.numpy()), f"{ln}/{bn}"
    for ln, bl in (mv.scales or {}).items():
        for bn, s in bl.items():
            assert np.float32(jscales[ln][bn]) == s.item()
    # and a sidecar written by the JAX package reads back in the port
    jpath = str(tmp_path / "j.quant")
    jax_ckpt.save_quant_sidecar(jpath, jblobs, jscales, jwd)
    tblobs, tscales, twd = checkpoint.load_quant_sidecar(jpath)
    assert twd == wd and tscales == jscales
    for ln, bl in mv.params.items():
        for bn, t in bl.items():
            assert tblobs[ln][bn].dtype == t.dtype
            assert torch.equal(tblobs[ln][bn], t), f"{ln}/{bn}"
