"""The PyTorch port's HDF5Data source and HDF5Output sink against the JAX
package.

  * `hdf5_top_shapes` and the HDF5Data layer's input specs equal JAX's;
  * HDF5Source: whole files round-robin across ranks, or rows striped
    within one file; records and packed batches equal; row counts that
    disagree and corrupt files raise ValueError in both;
  * the source feeds `-train` through the transformer pool (no draw)
    bit-equal to the inline pack;
  * an HDF5Output layer: the bottoms its forward records under
    "hdf5_output:<name>" equal JAX's, the step merges none of them into
    the params, and `write_hdf5_outputs` writes a file equal to the JAX
    package's, which the JAX HDF5Data source reads back;
  * without h5py, HDF5Data and HDF5Output files are refused by name.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch_common import cap_torch_threads

cap_torch_threads()

h5py = pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from caffeonspark_tpu.data import get_source as jax_get_source  # noqa: E402
from caffeonspark_tpu.data import hdf5 as JH  # noqa: E402
from caffeonspark_tpu.net import Net as JaxNet  # noqa: E402
from caffeonspark_tpu.net import data_layer_input_specs as jax_specs  # noqa
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter  # noqa
from caffeonspark_tpu_torch import convert  # noqa: E402
from caffeonspark_tpu_torch.data import get_source  # noqa: E402
from caffeonspark_tpu_torch.data import hdf5 as TH  # noqa: E402
from caffeonspark_tpu_torch.net import Net, data_layer_input_specs  # noqa
from caffeonspark_tpu_torch.proto import NetParameter  # noqa: E402
from caffeonspark_tpu_torch.proto import SolverParameter  # noqa: E402
from caffeonspark_tpu_torch.solver import Solver  # noqa: E402
from torch_port_helpers import jax_params_numpy  # noqa: E402

NET = """
name: "h5net"
layer {{ name: "data" type: "HDF5Data" top: "data" top: "label"
  hdf5_data_param {{ source: "{list}" batch_size: 4 }} }}
layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param {{ num_output: 3
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip"
  bottom: "label" top: "loss" }}
"""


def _files(tmp_path, n_files, rows=10, seed=0):
    rng = np.random.RandomState(seed)
    names = []
    for k in range(n_files):
        name = f"part{k}.h5"
        with h5py.File(tmp_path / name, "w") as f:
            f["data"] = rng.randn(rows, 2, 3).astype(np.float32)
            f["label"] = (np.arange(rows) % 3).astype(np.float32)
        names.append(name)
    lst = tmp_path / "files.txt"
    lst.write_text("\n".join(names) + "\n")    # relative to the list
    return str(lst)


@pytest.mark.parametrize("n_files,ranks", [(1, 1), (1, 2), (3, 2), (2, 3)])
def test_hdf5_source_records_and_batches_equal_jax(tmp_path, n_files,
                                                   ranks):
    lst = _files(tmp_path, n_files)
    text = NET.format(list=lst)
    tl = NetParameter.from_text(text).layer[0]
    jl = JaxNetParameter.from_text(text).layer[0]
    assert data_layer_input_specs(tl) == jax_specs(jl) == [
        ("data", (4, 2, 3), "data"), ("label", (4,), "label")]
    assert TH.hdf5_top_shapes(lst, ["data", "label"], 4) == \
        JH.hdf5_top_shapes(lst, ["data", "label"], 4)
    ids = []
    for rank in range(ranks):
        tsrc = get_source(tl, phase_train=True, rank=rank,
                          num_ranks=ranks, seed=1)
        jsrc = jax_get_source(jl, phase_train=True, rank=rank,
                              num_ranks=ranks, seed=1)
        assert tsrc.make_draw_fn() is None
        got, want = list(tsrc.shuffled_records(1)), \
            list(jsrc.shuffled_records(1))
        assert [r[0] for r in got] == [r[0] for r in want]
        ids += [r[0] for r in got]
        for i in range(len(got) // 4):
            b_t = tsrc.pack_batch(got[4 * i:4 * i + 4])
            b_j = jsrc.next_batch(want[4 * i:4 * i + 4])
            assert set(b_t) == set(b_j) == {"data", "label"}
            for k in b_t:
                np.testing.assert_array_equal(b_t[k], b_j[k])
    assert sorted(ids) == sorted(set(ids)) and len(ids) == 10 * n_files


def test_row_counts_and_corrupt_files_raise_value_error_in_both(tmp_path):
    lst = _files(tmp_path, 1)
    with h5py.File(tmp_path / "part0.h5", "a") as f:
        del f["label"]
        f["label"] = np.zeros(4, np.float32)
    text = NET.format(list=lst)
    for src in (get_source(NetParameter.from_text(text).layer[0]),
                jax_get_source(JaxNetParameter.from_text(text).layer[0],
                               phase_train=False)):
        with pytest.raises(ValueError, match="row count"):
            list(src.records())
    _files(tmp_path, 1, seed=2)
    wire = (tmp_path / "part0.h5").read_bytes()
    rng = np.random.RandomState(3)
    rejected = 0
    for _ in range(30):
        m = bytearray(wire)
        m[rng.randint(0, len(m) // 4)] = rng.randint(0, 256)
        (tmp_path / "part0.h5").write_bytes(bytes(m))
        res = []
        for shapes, src in (
                (TH.hdf5_top_shapes,
                 get_source(NetParameter.from_text(text).layer[0])),
                (JH.hdf5_top_shapes, jax_get_source(
                    JaxNetParameter.from_text(text).layer[0],
                    phase_train=False))):
            try:
                shapes(lst, ["data", "label"], 4)
                res.append(len(list(src.records())))
            except ValueError:
                res.append("ValueError")
        assert res[0] == res[1]
        rejected += res[0] == "ValueError"
    assert rejected


def test_hdf5_trains_through_the_pool_as_inline(tmp_path):
    """-train of the HDF5 net with 2 pool workers (no augmentation draw)
    and inline: byte-equal final models."""
    from caffeonspark_tpu_torch import caffe_on_spark
    lst = _files(tmp_path, 2, rows=12)
    net = tmp_path / "net.prototxt"
    net.write_text(NET.format(list=lst))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.1\nmomentum: 0.9\n'
                      'lr_policy: "fixed"\nmax_iter: 9\nrandom_seed: 2\n')
    models = []
    for threads in ("0", "2"):
        os.environ["COS_TRANSFORM_THREADS"] = threads
        try:
            out = tmp_path / f"o{threads}"
            assert caffe_on_spark.main(["-conf", str(solver), "-train",
                                        "-output", str(out), "-device",
                                        "cpu"]) == 0
        finally:
            del os.environ["COS_TRANSFORM_THREADS"]
        models.append((out / "model.caffemodel").read_bytes())
    assert models[0] == models[1]


SINK = """
name: "sink"
layer { name: "data" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 4 dim: 3 } shape { dim: 4 } } }
layer { name: "lp" type: "Input" top: "label_pair"
  input_param { shape { dim: 4 dim: 2 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "out" type: "HDF5Output" bottom: "ip" bottom: "label"
  hdf5_output_param { file_name: "unused.h5" } }
layer { name: "loss" type: "EuclideanLoss" bottom: "ip"
  bottom: "label_pair" top: "loss" }
"""


def test_hdf5_output_collects_and_writes_as_jax(tmp_path):
    jnet = JaxNet(JaxNetParameter.from_text(SINK))
    tnet = Net(NetParameter.from_text(SINK), device="cpu")
    pnp = jax_params_numpy(jnet, seed=1)
    jparams = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
               for ln, bl in pnp.items()}
    tparams = convert.params_from_numpy(tnet, pnp)
    t_batches, j_batches = [], []
    for i in range(3):
        x = np.random.RandomState(i).randn(4, 3).astype(np.float32)
        lab = np.arange(4, dtype=np.float32) + i
        _, jstate = jnet.apply(jparams, {
            "data": jnp.asarray(x), "label": jnp.asarray(lab),
            "label_pair": jnp.zeros((4, 2))}, train=False)
        state = {}
        tnet(tparams, {"data": torch.from_numpy(x),
                       "label": torch.from_numpy(lab),
                       "label_pair": torch.zeros(4, 2)}, state_out=state)
        t_out, j_out = TH.collect_hdf5_outputs(state), \
            JH.collect_hdf5_outputs(jstate)
        assert list(t_out) == list(j_out) == ["out"]
        for a, b in zip(t_out["out"], j_out["out"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
        t_batches.append(t_out["out"])
        j_batches.append(j_out["out"])
    TH.write_hdf5_outputs(str(tmp_path / "t.h5"), t_batches)
    JH.write_hdf5_outputs(str(tmp_path / "j.h5"), j_batches)
    with h5py.File(tmp_path / "t.h5", "r") as t, \
            h5py.File(tmp_path / "j.h5", "r") as j:
        assert sorted(t) == sorted(j) == ["data", "label"]
        np.testing.assert_allclose(t["data"][:], j["data"][:], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(t["label"][:], j["label"][:])
        assert t["data"].shape == (12, 2)
    # the JAX package's HDF5Data reads the port's file back
    (tmp_path / "out.txt").write_text("t.h5\n")
    jsrc = JH.HDF5Source(JaxNetParameter.from_text(
        'layer { name: "d" type: "HDF5Data" top: "data" top: "label" '
        f'hdf5_data_param {{ source: "{tmp_path / "out.txt"}" '
        'batch_size: 12 } }').layer[0], phase_train=False)
    back = jsrc.next_batch(list(jsrc.records()))
    np.testing.assert_array_equal(
        back["data"], np.concatenate([b[0].numpy() for b in t_batches]))
    np.testing.assert_array_equal(
        back["label"], np.concatenate([b[1].numpy() for b in t_batches]))


def test_a_step_merges_no_hdf5_output_into_the_params():
    """The solver's step (iter_size 2: the sub-batches thread the
    forward state) leaves the side channel out of the params; the
    update equals the same net's without the HDF5Output."""
    plain = "layer {".join(p for p in SINK.split("layer {")
                           if "HDF5Output" not in p)
    outs = []
    for t in (SINK, plain):
        s = Solver(SolverParameter.from_text(
            'base_lr: 0.1 lr_policy: "fixed" iter_size: 2'),
            NetParameter.from_text(t), device="cpu")
        params, st = s.init()
        inputs = {"data": torch.ones(4, 3), "label": torch.zeros(4),
                  "label_pair": torch.ones(4, 2)}
        s.train_step(params, st, inputs)
        outs.append(params)
    assert set(outs[0]) == set(outs[1]) == {"ip"}
    for bn in outs[0]["ip"]:
        torch.testing.assert_close(outs[0]["ip"][bn], outs[1]["ip"][bn],
                                   rtol=0, atol=0)


def test_without_h5py_hdf5_files_are_refused_by_name(tmp_path,
                                                     monkeypatch):
    lst = _files(tmp_path, 1)
    monkeypatch.setitem(sys.modules, "h5py", None)
    lp = NetParameter.from_text(NET.format(list=lst)).layer[0]
    with pytest.raises(ImportError, match="h5py"):
        data_layer_input_specs(lp)
    with pytest.raises(ImportError, match="h5py"):
        list(get_source(lp).records())
    with pytest.raises(ImportError, match="h5py"):
        TH.write_hdf5_outputs(str(tmp_path / "x.h5"),
                              [[np.zeros((1, 2))]])
