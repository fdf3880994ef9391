"""The rest of the PyTorch port's data path against the JAX package:
Caffe's ImageData list, the image DataFrame, a DataFrameSource's image
tops, the growing part directory (StreamingDir), the `module:Class`
extension point and `register_source`, DummyData, and
data/synthetic.py.

  * ImageListSource: records, `shuffled_records(epoch)` over two epochs
    (a fresh shuffle each, rand_skip at epoch 0 only), rank striping
    and packed TRAIN batches equal the JAX source's;
  * ImageDataFrame over parquet: records and batches equal; without
    pyarrow it is refused by name;
  * DataFrame image tops (RAW_IMAGE, ENCODED_IMAGE,
    ENCODED_IMAGE_WITH_DIM, out_height / out_width, a transform_param
    each) through parquet: batches equal; the same table as JSON lines
    (base64 columns) packs equal to the parquet one in the port, where
    the JAX package fails (ROADMAP, defects of the reference);
  * StreamingDirSource as its parts grow (LMDB and SequenceFile parts,
    a flaky injector, a corrupt part quarantined): records equal after
    each poll;
  * data_layer_input_specs of ImageData and DummyData equal JAX's;
  * mini_cluster takes a SequenceFile, a LevelDB and an ImageData list
    with the ingest knobs (the model byte-equal across them, and within
    rtol 1e-4 of the JAX mini_cluster's), and -test / -features over a
    LevelDB and an ImageData list equal the JAX CLI's.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.data import streaming as JStream
from caffeonspark_tpu.data import synthetic as JSynth
from caffeonspark_tpu.net import data_layer_input_specs as jax_specs
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.tools.converters import _write_parquet
from caffeonspark_tpu_torch.data import get_source, register_source
from caffeonspark_tpu_torch.data import streaming as TStream
from caffeonspark_tpu_torch.data import synthetic as TSynth
from caffeonspark_tpu_torch.data.sequencefile import SequenceFileWriter
from caffeonspark_tpu_torch.data.source import (DataSource,
                                                ImageDataFrame,
                                                ImageListSource)
from caffeonspark_tpu_torch.net import Net, data_layer_input_specs
from caffeonspark_tpu_torch.proto import NetParameter
from torch_port_helpers import datum_records
from torch_common import cap_torch_threads

cap_torch_threads()


def _both(text, **kw):
    return (get_source(NetParameter.from_text(text).layer[0], **kw),
            jax_get_source(JaxNetParameter.from_text(text).layer[0], **kw))


def _assert_batches_equal(b_t, b_j):
    assert set(b_t) == set(b_j)
    for k in b_t:
        np.testing.assert_array_equal(b_t[k], b_j[k])


def _images(tmp_path, n, hw=(12, 10), ext=".jpg", seed=0):
    rng = np.random.RandomState(seed)
    d = tmp_path / "imgs"
    d.mkdir(exist_ok=True)
    names = []
    for i in range(n):
        name = f"im{i:03d}{ext}"
        cv2.imwrite(str(d / name), rng.randint(0, 256, hw + (3,),
                                               dtype=np.uint8))
        names.append(name)
    return str(d), names


# ---------------------------------------------------------------------------
# ImageData
# ---------------------------------------------------------------------------

def _image_data_layer(listfile, root, shuffle=True, rand_skip=5,
                      is_color=True, batch=4):
    return ('layer { name: "data" type: "ImageData" top: "data" '
            'top: "label" transform_param { crop_size: 6 mirror: true '
            'mean_value: 100 } image_data_param { '
            f'source: "{listfile}" root_folder: "{root}/" '
            f'batch_size: {batch} new_height: 8 new_width: 8 '
            f'shuffle: {str(shuffle).lower()} rand_skip: {rand_skip} '
            f'is_color: {str(is_color).lower()} }} }}')


@pytest.mark.parametrize("shuffle,ranks,is_color",
                         [(True, 1, True), (True, 2, True),
                          (False, 1, False), (False, 2, True)])
def test_image_list_records_epochs_and_batches_equal_jax(
        tmp_path, shuffle, ranks, is_color):
    root, names = _images(tmp_path, 13, ext=".png")
    listfile = tmp_path / "list.txt"
    listfile.write_text("".join(f"{n} {i % 5}\n"
                                for i, n in enumerate(names)) + "\n")
    text = _image_data_layer(listfile, root, shuffle=shuffle,
                             is_color=is_color)
    seen = []
    for rank in range(ranks):
        tsrc, jsrc = _both(text, phase_train=True, rank=rank,
                           num_ranks=ranks, seed=7)
        assert isinstance(tsrc, ImageListSource)
        assert tsrc.image_dims() == jsrc.image_dims() == \
            (3 if is_color else 1, 8, 8)
        epochs = []
        for epoch in (0, 1):
            got = list(tsrc.shuffled_records(epoch))
            assert got == list(jsrc.shuffled_records(epoch))
            epochs.append([r[0] for r in got])
        assert epochs[0] != epochs[1] or not shuffle
        seen += epochs[1]
        recs = got
        _assert_batches_equal(tsrc.next_batch(recs[:4]),
                              jsrc.next_batch(recs[:4]))
    assert sorted(seen) == sorted(names)     # the ranks partition the list


def test_image_data_specs_equal_jax_and_refuse_without_dims(tmp_path):
    text = _image_data_layer(tmp_path / "l.txt", tmp_path)
    tl = NetParameter.from_text(text).layer[0]
    jl = JaxNetParameter.from_text(text).layer[0]
    assert data_layer_input_specs(tl) == jax_specs(jl) == [
        ("data", (4, 3, 6, 6), "data"), ("label", (4,), "label")]
    for lp in (tl, jl):
        lp.transform_param.crop_size = 0
        lp.image_data_param.new_height = 0
    with pytest.raises(ValueError, match="new_height"):
        data_layer_input_specs(tl)
    with pytest.raises(ValueError, match="new_height"):
        jax_specs(jl)


# ---------------------------------------------------------------------------
# ImageDataFrame and the DataFrame's image tops
# ---------------------------------------------------------------------------

def _image_rows(n, hw=(12, 10), seed=3):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        img = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        rows.append({"id": f"r{i}", "label": float(i % 7),
                     "raw": img.transpose(2, 0, 1).tobytes(),
                     "enc": bytes(cv2.imencode(".jpg", img)[1]),
                     "dim": bytes(cv2.imencode(".png", img)[1])})
    return rows


def test_image_dataframe_records_and_batches_equal_jax(tmp_path,
                                                       monkeypatch):
    pytest.importorskip("pyarrow")
    rows = _image_rows(9)
    path = str(tmp_path / "images.parquet")
    _write_parquet([{"id": r["id"], "label": r["label"], "encoded": True,
                     "data": r["enc"]} for r in rows], path)
    text = ('layer { name: "data" type: "MemoryData" top: "data" '
            'top: "label" source_class: "com.yahoo.ml.caffe.ImageDataFrame"'
            ' transform_param { crop_size: 8 mirror: true scale: 0.5 } '
            f'memory_data_param {{ source: "{path}" batch_size: 3 '
            'channels: 3 height: 12 width: 10 } }')
    for rank, ranks in ((0, 1), (1, 2)):
        tsrc, jsrc = _both(text, phase_train=True, rank=rank,
                           num_ranks=ranks, seed=2)
        assert isinstance(tsrc, ImageDataFrame)
        got = list(tsrc.records())
        assert got == list(jsrc.records()) and got
        recs = list(tsrc.shuffled_records(1))
        assert recs == list(jsrc.shuffled_records(1))
        _assert_batches_equal(tsrc.next_batch(recs[:3]),
                              jsrc.next_batch(recs[:3]))
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        list(get_source(NetParameter.from_text(text).layer[0]).records())


TOPS = """
layer {{ name: "data" type: "CoSData" top: "raw" top: "enc" top: "dim"
  top: "label" source_class: "com.yahoo.ml.caffe.DataFrameSource"
  cos_data_param {{ batch_size: 4 source: "{path}"
    dataframe_format: "{fmt}"
    top {{ name: "raw" type: RAW_IMAGE channels: 3 height: 12 width: 10
          out_height: 11 out_width: 9 }}
    top {{ name: "enc" type: ENCODED_IMAGE channels: 3 height: 12
          width: 10 transform_param {{ crop_size: 8 mirror: true
          mean_value: 100 mean_value: 110 mean_value: 120 }} }}
    top {{ name: "dim" type: ENCODED_IMAGE_WITH_DIM channels: 1
          height: 12 width: 10 out_height: 6 out_width: 5
          transform_param {{ scale: 0.25 }} }}
    top {{ name: "label" type: FLOAT }} }} }}
"""


def test_dataframe_image_tops_equal_jax_and_json_equals_parquet(tmp_path):
    """Parquet through both packages (COS_NATIVE=0 keeps the port on cv2,
    as the JAX DataFrameSource decodes); JSON lines, base64 image
    columns, through the port equal to its parquet batches.  The JAX
    package fails on the JSON table: its image packing calls bytes() on
    the base64 text."""
    pytest.importorskip("pyarrow")
    rows = _image_rows(8)
    pq_path, js_path = str(tmp_path / "t.parquet"), str(tmp_path / "t.json")
    _write_parquet(rows, pq_path)
    _write_parquet(rows, js_path)
    with open(js_path) as f:
        assert isinstance(json.loads(f.readline())["enc"], str)
    pq_text = TOPS.format(path=pq_path, fmt="parquet")
    js_text = TOPS.format(path=js_path, fmt="json")
    os.environ["COS_NATIVE"] = "0"
    try:
        for train in (True, False):
            tsrc, jsrc = _both(pq_text, phase_train=train, seed=4)
            jsn = get_source(NetParameter.from_text(js_text).layer[0],
                             phase_train=train, seed=4)
            recs = list(tsrc.shuffled_records(0))
            assert [r["id"] for r in recs] == \
                [r["id"] for r in jsrc.shuffled_records(0)]
            for i in range(2):
                b_t = tsrc.next_batch(recs[4 * i:4 * i + 4])
                _assert_batches_equal(b_t, jsrc.next_batch(
                    recs[4 * i:4 * i + 4]))
                assert b_t["raw"].shape == (4, 3, 11, 9)
                assert b_t["enc"].shape == (4, 3, 8, 8)
                assert b_t["dim"].shape == (4, 1, 6, 5)
            js_recs = {r["id"]: r for r in jsn.rows()}
            _assert_batches_equal(
                jsn.next_batch([js_recs[r["id"]] for r in recs[:4]]),
                get_source(NetParameter.from_text(pq_text).layer[0],
                           phase_train=train, seed=4).next_batch(recs[:4]))
    finally:
        del os.environ["COS_NATIVE"]
    jsrc = jax_get_source(JaxNetParameter.from_text(js_text).layer[0],
                          phase_train=False)
    with pytest.raises(TypeError):
        jsrc.next_batch(list(jsrc.records())[:4])


def test_dataframe_image_top_shapes_equal_jax(tmp_path):
    text = TOPS.format(path=tmp_path / "x.json", fmt="json")
    assert data_layer_input_specs(NetParameter.from_text(text).layer[0]) \
        == jax_specs(JaxNetParameter.from_text(text).layer[0])


# ---------------------------------------------------------------------------
# StreamingDir
# ---------------------------------------------------------------------------

class _Flaky:
    """An injector: its storage_fault() raises `n` times, then passes."""

    def __init__(self, n):
        self.n = n

    def storage_fault(self):
        if self.n > 0:
            self.n -= 1
            raise OSError("injected storage fault")


STREAM = ('layer { name: "data" type: "MemoryData" top: "data" '
          'top: "label" source_class: "StreamingDir" transform_param { '
          'crop_size: 4 mirror: true } memory_data_param { '
          'source: "%s" batch_size: 3 channels: 1 height: 6 width: 6 } }')


def test_streaming_dir_follows_growing_parts_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(TStream.StreamingDirSource, "POLL_ATTEMPTS", 3)
    monkeypatch.setattr(JStream.StreamingDirSource, "POLL_ATTEMPTS", 3)
    monkeypatch.setattr(TStream.StreamingDirSource, "PART_STRIKES", 2)
    monkeypatch.setattr(JStream.StreamingDirSource, "PART_STRIKES", 2)
    monkeypatch.setattr(TStream.time, "sleep", lambda s: None)
    monkeypatch.setattr(JStream.time, "sleep", lambda s: None)
    d = str(tmp_path / "stream")
    imgs, labels = TSynth.make_images(12, height=6, width=6, seed=1)
    TStream.append_stream_part(d, TStream.datum_records(imgs[:5],
                                                        labels[:5]))
    tsrc, jsrc = _both(STREAM % d, phase_train=True, seed=3)
    assert tsrc.total_records == jsrc.total_records == 5
    assert list(tsrc.records()) == list(jsrc.records())
    # a SequenceFile part written by the port, a corrupt part, then an
    # LMDB part written by the JAX helper
    with SequenceFileWriter(os.path.join(d, "part-00001")) as w:
        for k, v in TStream.datum_records(imgs[5:9], labels[5:9], 5):
            w.append(k.decode(), v)
    with open(os.path.join(d, "part-00002"), "wb") as f:
        f.write(b"not a part")
    JStream.append_stream_part(d, JStream.datum_records(imgs[9:], labels[9:],
                                                        9))
    assert TStream.datum_records(imgs, labels) == \
        JStream.datum_records(imgs, labels)
    for src in (tsrc, jsrc):
        assert src.poll(injector=_Flaky(1)) == 7
        assert src.wait_for_records(1, timeout_s=0.0) == 0
        assert src.describe()["quarantined"] == ["part-00002"]
        assert src.poll(injector=_Flaky(5)) == 0     # past the attempts
    assert tsrc.describe() == jsrc.describe()
    got = list(tsrc.records())
    assert got == list(jsrc.records()) and len(got) == 12
    recs = list(tsrc.shuffled_records(2))
    assert recs == list(jsrc.shuffled_records(2))
    _assert_batches_equal(tsrc.next_batch(recs[:3]),
                          jsrc.next_batch(recs[:3]))


# ---------------------------------------------------------------------------
# get_source's routes, DummyData, synthetic
# ---------------------------------------------------------------------------

class UserSource(DataSource):
    """A user's source, reached through source_class "module:Class"."""

    def records(self):
        for i in range(4):
            yield (f"u{i}", float(i), 1, 2, 2, False,
                   np.full((1, 2, 2), i, np.float32))


def test_module_class_route_and_register_source(tmp_path):
    text = ('layer { name: "data" type: "MemoryData" top: "data" '
            'top: "label" source_class: "%s" memory_data_param { '
            'batch_size: 2 channels: 1 height: 2 width: 2 } }')
    lp = NetParameter.from_text(
        text % "test_torch_sources_rest:UserSource").layer[0]
    src = get_source(lp)
    assert type(src).__name__ == "UserSource"
    b = next(src.batches(loop=False))
    np.testing.assert_array_equal(b["label"], [0.0, 1.0])
    register_source("my.Source", UserSource)
    assert isinstance(get_source(NetParameter.from_text(
        text % "my.Source").layer[0]), UserSource)
    with pytest.raises(ValueError, match="unknown source_class"):
        get_source(NetParameter.from_text(text % "no.Such").layer[0])


DUMMY = """
name: "dummy"
layer { name: "d" type: "DummyData" top: "x" top: "y"
  dummy_data_param { shape { dim: 3 dim: 5 } shape { dim: 3 dim: 2 } } }
layer { name: "e" type: "DummyData" top: "z"
  dummy_data_param { num: 3 channels: 2 height: 1 width: 1 } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "EuclideanLoss" bottom: "ip" bottom: "y"
  top: "loss" }
"""


def test_dummy_data_shapes_equal_jax_and_inputs_come_from_the_caller():
    tnp, jnp_ = NetParameter.from_text(DUMMY), JaxNetParameter.from_text(DUMMY)
    for i in (0, 1):
        assert data_layer_input_specs(tnp.layer[i]) == \
            jax_specs(jnp_.layer[i])
    net = Net(tnp, device="cpu")
    assert net.blob_shapes["x"] == (3, 5) and net.blob_shapes["z"] == \
        (3, 2, 1, 1)
    params = net.init(0)
    x = torch.ones(3, 5)
    loss, _ = net.loss(params, {"x": x, "y": torch.zeros(3, 2),
                                "z": torch.zeros(3, 2, 1, 1)})
    assert torch.isfinite(loss)


def test_synthetic_images_equal_jax():
    for kw in ({}, dict(channels=3, height=8, width=9, num_classes=4,
                        seed=5, noise=0.1)):
        ti, tl = TSynth.make_images(7, **kw)
        ji, jl = JSynth.make_images(7, **kw)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    tg = TSynth.batches(5, 3, seed=2, scale=0.5, height=4, width=4)
    jg = JSynth.batches(5, 3, seed=2, scale=0.5, height=4, width=4)
    for _ in range(3):
        for a, b in zip(next(tg), next(jg)):
            np.testing.assert_array_equal(a, b)


def test_image_list_trains_through_the_pool_as_inline(tmp_path):
    """ImageData through -train with 2 pool workers and inline: the same
    final model (the pool's ordered draws)."""
    from caffeonspark_tpu_torch import caffe_on_spark, checkpoint
    root, names = _images(tmp_path, 12, hw=(30, 28))
    listfile = tmp_path / "list.txt"
    listfile.write_text("".join(f"{n} {i % 10}\n"
                                for i, n in enumerate(names)))
    from torch_port_helpers import narrow_net_text
    text = narrow_net_text("lenet", batch=4)
    body = text[text.index("layer {", text.index("layer {") + 1):]
    layer = ('layer { name: "data" type: "ImageData" top: "data" '
             'top: "label" transform_param { scale: 0.00390625 '
             'crop_size: 28 mirror: true } image_data_param { '
             f'source: "{listfile}" root_folder: "{root}/" batch_size: 4 '
             'new_height: 30 new_width: 28 shuffle: true is_color: false '
             '} }')
    net = tmp_path / "net.prototxt"
    net.write_text(f'name: "LeNet"\n{layer}\n{body}')
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nlr_policy: "fixed"\n'
                      'max_iter: 5\nrandom_seed: 3\n')
    models = []
    for threads in ("0", "2"):
        os.environ["COS_TRANSFORM_THREADS"] = threads
        try:
            out = tmp_path / f"out{threads}"
            assert caffe_on_spark.main(["-conf", str(solver), "-train",
                                        "-output", str(out), "-device",
                                        "cpu"]) == 0
        finally:
            del os.environ["COS_TRANSFORM_THREADS"]
        models.append((out / "model.caffemodel").read_bytes())
    assert models[0] == models[1]
    assert checkpoint.load_caffemodel_blobs(str(out / "model.caffemodel"))


# ---------------------------------------------------------------------------
# the new stores through mini_cluster and -test / -features
# ---------------------------------------------------------------------------

def _lenet_store(tmp_path, store):
    """A LeNet data layer (8 x 28 x 28 grayscale, crop 24, mirror) over 24
    seeded records in `store`, written by the port's writers."""
    from caffeonspark_tpu_torch.data.leveldb_io import LevelDBWriter
    from caffeonspark_tpu_torch.proto.caffe import Datum
    recs = datum_records(24, seed=8)
    xf = ('transform_param { scale: 0.00390625 crop_size: 24 '
          'mirror: true }')
    path = str(tmp_path / store)
    if store == "sequencefile":
        with SequenceFileWriter(path, compression="record") as w:
            for k, v in recs:
                w.append(k.decode(), v)
        return ('layer { name: "data" type: "MemoryData" top: "data" '
                'top: "label" source_class: '
                f'"com.yahoo.ml.caffe.SeqImageDataSource" {xf} '
                f'memory_data_param {{ source: "{path}" batch_size: 8 '
                'channels: 1 height: 28 width: 28 } }')
    if store == "leveldb":
        LevelDBWriter(path, snappy=True).write(recs)
        return ('layer { name: "data" type: "Data" top: "data" '
                f'top: "label" {xf} data_param {{ source: "{path}" '
                'batch_size: 8 backend: LEVELDB } }')
    os.makedirs(path)
    lines = []
    for k, v in recs:
        d = Datum.from_binary(v)
        name = k.decode() + ".png"
        cv2.imwrite(os.path.join(path, name), np.frombuffer(
            d.data, np.uint8).reshape(28, 28))
        lines.append(f"{name} {d.label}\n")
    with open(path + ".txt", "w") as f:
        f.writelines(lines)
    return ('layer { name: "data" type: "ImageData" top: "data" '
            f'top: "label" {xf} image_data_param {{ '
            f'source: "{path}.txt" root_folder: "{path}/" batch_size: 8 '
            'new_height: 28 new_width: 28 is_color: false shuffle: true '
            'rand_skip: 3 } }')


@pytest.mark.parametrize("store", ["sequencefile", "leveldb", "imagedata"])
def test_mini_cluster_takes_each_store_and_the_ingest_knobs(tmp_path,
                                                            store,
                                                            monkeypatch):
    """mini_cluster on each new store from one -weights file: the port's
    run at COS_TRANSFORM_THREADS=0 byte-equal to its run with 2 pool
    workers, COS_DEVICE_TRANSFORM=1 and COS_STEPS_PER_LOOP=2, and within
    rtol 1e-4 of the JAX mini_cluster's."""
    from caffeonspark_tpu import checkpoint as jax_ckpt
    from caffeonspark_tpu import mini_cluster as jax_mc
    from caffeonspark_tpu_torch import checkpoint, mini_cluster
    from torch_port_helpers import lenet_solver
    solver, init = lenet_solver(tmp_path, _lenet_store(tmp_path, store))
    models = {}
    for tag, env in (("t0", {"COS_TRANSFORM_THREADS": "0"}),
                     ("knobs", {"COS_TRANSFORM_THREADS": "2",
                                "COS_DEVICE_TRANSFORM": "1",
                                "COS_STEPS_PER_LOOP": "2"})):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        out = tmp_path / tag
        assert mini_cluster.main(["-solver", solver, "-weights", init,
                                  "-output", str(out), "-model",
                                  str(out / "final.caffemodel"),
                                  "-device", "cpu"]) == 0
        for k in env:
            monkeypatch.delenv(k)
        models[tag] = out / "final.caffemodel"
    assert models["t0"].read_bytes() == models["knobs"].read_bytes()
    out = tmp_path / "j"
    assert jax_mc.main(["-solver", solver, "-weights", init, "-output",
                        str(out), "-model", str(out / "final.caffemodel"),
                        "-devices", "1"]) == 0
    got = checkpoint.load_caffemodel_blobs(str(models["t0"]))
    want = jax_ckpt.load_caffemodel_blobs(str(out / "final.caffemodel"))
    assert set(got) == set(want)
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=ln)


@pytest.mark.parametrize("store", ["leveldb", "imagedata"])
def test_cli_test_and_features_over_each_store_match_jax(tmp_path, store):
    """-test and -features ip2 -label label over a TEST layer on a new
    store, both CLIs on one -model: test_result within 1e-5, rows and
    SampleIDs equal (1e-5)."""
    from caffeonspark_tpu import caffe_on_spark as jax_cos
    from caffeonspark_tpu_torch import caffe_on_spark
    from torch_port_helpers import lenet_solver
    solver, model = lenet_solver(tmp_path, _lenet_store(tmp_path, store))
    outs = {}
    for tag, main, extra in (("t", caffe_on_spark.main, ["-device", "cpu"]),
                             ("j", jax_cos.main, ["-devices", "1"])):
        for mode, args in (("test", ["-test"]),
                           ("features", ["-features", "ip2", "-label",
                                         "label"])):
            out = tmp_path / f"{tag}_{mode}"
            assert main(["-conf", solver, *args, "-model", model,
                         "-output", str(out), *extra]) == 0
        outs[tag] = (json.loads((tmp_path / f"{tag}_test" /
                                 "test_result").read_text()),
                     [json.loads(x) for x in (
                         tmp_path / f"{tag}_features" /
                         "features.json").read_text().splitlines()])
    (tr, trows), (jr, jrows) = outs["t"], outs["j"]
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, atol=1e-5)
    assert [r["SampleID"] for r in trows] == [r["SampleID"] for r in jrows]
    assert len(trows) == 24
    for a, b in zip(trows, jrows):
        np.testing.assert_allclose(a["ip2"], b["ip2"], rtol=1e-5, atol=1e-5)
        assert a["label"] == b["label"]
