"""The port's native ingest library (`caffeonspark_tpu_torch.native`)
against the JAX package's (`caffeonspark_tpu.native`) and the numpy /
cv2 paths, on the CPU.

  * `crop_mirror_u8` and `transform_batch` bit-equal to the JAX library
    and to numpy (the Transformer's host paths);
  * `decode_batch`, float32 and uint8, colour and grayscale, on JPEGs
    encoded here with cv2 from seeded arrays: bit-equal to the JAX
    library's decode, the uint8 output equal to the float output cast;
  * a corrupt image raises, naming its record; COS_NATIVE=0 gives the
    same batches (the numpy crop; cv2 decoding, as the JAX package's
    COS_NATIVE=0); without libjpeg and cv2 an encoded record is refused
    naming both; a build failure raises;
  * an LMDB of encoded Datums trains through the port's CLI on the CPU
    to the JAX CLI's snapshot and final models (rtol 1e-4), and through
    the port's mini_cluster with the JAX mini_cluster's per-step losses
    (rtol 1e-5), from one -weights;
  * `tune_decode_threads` pins the decode to one thread under a pool.

Every case needs g++ and libjpeg's header (the library builds at first
use); without them the fixture skips, as tests/test_native.py's does.
"""

import json
import os
import shutil

import numpy as np
import pytest

from caffeonspark_tpu import caffe_on_spark as jax_cos
from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu import mini_cluster as jax_mc
from caffeonspark_tpu import native as jax_native
from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.data.transformer import Transformer as JaxTransformer
from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.proto.caffe import (
    TransformationParameter as JaxTP)
from caffeonspark_tpu_torch import (caffe_on_spark, checkpoint,
                                    mini_cluster, native)
from caffeonspark_tpu_torch.data import LmdbWriter, get_source
from caffeonspark_tpu_torch.data import source as source_mod
from caffeonspark_tpu_torch.data.queue_runner import tune_decode_threads
from caffeonspark_tpu_torch.data.transformer import Transformer
from caffeonspark_tpu_torch.proto import (NetParameter, SolverParameter,
                                          TransformationParameter)
from caffeonspark_tpu_torch.proto.caffe import Datum
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None or not os.path.exists(
            "/usr/include/jpeglib.h"):
        pytest.skip("g++ or libjpeg's header missing")
    if not (native.available() and native.decode_available()):
        pytest.skip("COS_NATIVE=0 in the environment")
    if not jax_native.available():
        pytest.skip("the JAX package's native library is unavailable")
    return native


def _jpegs(n, c, h, w, seed, quality=90):
    """Smooth seeded pixels (a 4x5 grid of random values, resized) in
    BGR order, encoded with cv2: (JPEG bytes list, pixels)."""
    rng = np.random.RandomState(seed)
    px = np.stack([cv2.resize(rng.randint(0, 256, (4, 5, c)).astype(
        np.uint8), (w, h)).reshape(h, w, c) for _ in range(n)])
    out = []
    for img in px:
        ok, buf = cv2.imencode(".jpg", img[:, :, 0] if c == 1 else img,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        out.append(bytes(buf))
    return out, px


def _draws(n, h, w, crop, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, h - crop + 1, n), rng.randint(0, w - crop + 1, n),
            rng.randint(0, 2, n).astype(bool))


def test_version_and_build_dir(lib):
    assert lib.version() == 1
    report = lib.build()
    assert report["libjpeg"] and set(report["libraries"]) == {"cos_bytes",
                                                              "cos_jpeg"}
    for path in report["libraries"].values():
        assert path.parent == native.BUILD_DIR and path.exists()
    with open(os.path.join(os.path.dirname(native.SRC_DIR.parent),
                           ".gitignore")) as f:
        assert "build/torch_native/" in f.read().split()


@pytest.mark.parametrize("crop", [0, 21])
@pytest.mark.parametrize("shape", [(6, 3, 32, 29), (3, 1, 24, 24)])
def test_crop_mirror_u8_bit_equal(lib, shape, crop):
    n, c, h, w = shape
    x = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    hs, ws, flip = _draws(n, h, w, crop or min(h, w), 2)
    got = lib.crop_mirror_u8(x, hs, ws, flip, crop=crop, num_threads=3)
    want = jax_native.crop_mirror_u8(x, hs, ws, flip, crop=crop)
    np.testing.assert_array_equal(got, want)
    ref = np.stack([x[i, :, hs[i]:hs[i] + crop, ws[i]:ws[i] + crop]
                    if crop else x[i] for i in range(n)])
    ref[flip] = ref[flip, :, :, ::-1]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mean", ["none", "channel", "plane"])
def test_transform_batch_bit_equal(lib, mean):
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (5, 3, 20, 18)).astype(np.float32)
    hs, ws, flip = _draws(5, 20, 18, 15, 4)
    m = {"none": None, "channel": np.array([104., 117., 123.], np.float32),
         "plane": rng.rand(3, 15, 15).astype(np.float32) * 100}[mean]
    kw = dict(crop=15, h_off=hs, w_off=ws, mirror=flip.astype(np.uint8),
              mean=m, scale=0.5)
    got = lib.transform_batch(x, num_threads=2, **kw)
    np.testing.assert_array_equal(got, jax_native.transform_batch(x, **kw))
    ref = np.stack([x[i, :, hs[i]:hs[i] + 15, ws[i]:ws[i] + 15]
                    for i in range(5)])
    ref[flip] = ref[flip, :, :, ::-1]
    if m is not None:
        ref = ref - (m[None, :, None, None] if m.ndim == 1 else m[None])
    np.testing.assert_array_equal(got, ref * np.float32(0.5))


@pytest.mark.parametrize("c,hw", [(3, (32, 40)), (3, (24, 24)),
                                  (1, (28, 28))], ids=["rgb-resize", "rgb",
                                                       "gray"])
def test_decode_batch_bit_equal_to_jax(lib, c, hw):
    jpegs, px = _jpegs(7, c, 32, 40, seed=5)
    h, w = hw
    got = lib.decode_batch(jpegs, channels=c, out_h=h, out_w=w,
                           num_threads=3)
    want = jax_native.decode_batch(jpegs, channels=c, out_h=h, out_w=w)
    assert got.dtype == np.float32 and got.shape == (7, c, h, w)
    np.testing.assert_array_equal(got, want)
    u8 = lib.decode_batch(jpegs, channels=c, out_h=h, out_w=w,
                          out_dtype=np.uint8)
    np.testing.assert_array_equal(u8, got.astype(np.uint8))
    np.testing.assert_array_equal(
        u8, jax_native.decode_batch(jpegs, channels=c, out_h=h, out_w=w,
                                    out_dtype=np.uint8))
    if (h, w) == (32, 40):       # no resize: near the encoded pixels
        assert np.mean(np.abs(got - px.transpose(0, 3, 1, 2))) < 3


def _encoded_layer(src, c=3, hw=24, batch=4, crop=20):
    text = f"""
    name: "data" type: "MemoryData" top: "data" top: "label"
    source_class: "com.yahoo.ml.caffe.LMDB"
    memory_data_param {{ source: "{src}" batch_size: {batch}
      channels: {c} height: {hw} width: {hw} }}
    transform_param {{ crop_size: {crop} mirror: true
      mean_value: 104 scale: 0.5 }}"""
    from caffeonspark_tpu.proto import LayerParameter as JaxLayer
    from caffeonspark_tpu_torch.proto import LayerParameter
    return LayerParameter.from_text(text), JaxLayer.from_text(text)


def _encoded_records(n, c=3, hw=24, seed=6, corrupt=None):
    jpegs, _ = _jpegs(n, c, hw, hw, seed)
    if corrupt is not None:
        jpegs[corrupt] = b"\xff\xd8 not a jpeg"
    return [(f"rec{i}", float(i % 10), c, hw, hw, True, j)
            for i, j in enumerate(jpegs)]


@pytest.mark.parametrize("device_transform", [False, True])
def test_encoded_batches_equal_jax(lib, device_transform, monkeypatch):
    """next_batch on encoded records: the port's batch equals the JAX
    source's (native decode, then crop/mirror/mean/scale on the host, or
    the uint8 host stage with its aux array)."""
    if device_transform:
        monkeypatch.setenv("COS_DEVICE_TRANSFORM", "1")
    tl, jl = _encoded_layer("unused")
    ts = get_source(tl, phase_train=True, seed=3)
    js = jax_get_source(jl, phase_train=True, seed=3)
    if device_transform:
        assert ts.enable_device_transform() is not None
        assert js.enable_device_transform() is not None
    for k in range(2):
        recs = _encoded_records(4, seed=10 + k)
        got, want = ts.next_batch(recs), js.next_batch(recs)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        if device_transform:
            assert got["data"].dtype == np.uint8


def test_corrupt_image_names_its_record(lib):
    tl, _ = _encoded_layer("unused")
    ts = get_source(tl, phase_train=True, seed=3)
    with pytest.raises(ValueError, match="record 'rec2': image decode "
                       "failed"):
        ts.next_batch(_encoded_records(4, corrupt=2))
    with pytest.raises(ValueError, match="1/2 images failed to decode"):
        lib.decode_batch([b"junk", _jpegs(1, 3, 8, 8, 0)[0][0]],
                         channels=3, out_h=8, out_w=8)


def test_native_off_gives_the_same_batches(lib, monkeypatch):
    """COS_NATIVE=0: the numpy host stage equals the native one, and
    encoded records take cv2 image by image, as the JAX package does
    under COS_NATIVE=0 (the same batches)."""
    x = np.random.RandomState(8).randint(0, 256, (6, 3, 16, 16)) \
        .astype(np.uint8)
    tp = TransformationParameter.from_text("crop_size: 11 mirror: true")
    t_native = Transformer(tp, phase_train=True, seed=4)
    t_numpy = Transformer(tp, phase_train=True, seed=4)
    want_u8, want_aux = t_native.host_stage(x)
    monkeypatch.setenv("COS_NATIVE", "0")
    assert not native.available() and not native.decode_available()
    got_u8, got_aux = t_numpy.host_stage(x)
    np.testing.assert_array_equal(got_u8, want_u8)
    np.testing.assert_array_equal(got_aux, want_aux)
    tl, jl = _encoded_layer("unused")
    ts = get_source(tl, phase_train=True, seed=3)
    js = jax_get_source(jl, phase_train=True, seed=3)
    recs = _encoded_records(4, seed=12)
    got, want = ts.next_batch(recs), js.next_batch(recs)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    # and the JAX Transformer's numpy path gives the same host stage
    jt = JaxTransformer(JaxTP.from_text("crop_size: 11 mirror: true"),
                        phase_train=True, seed=4)
    np.testing.assert_array_equal(jt.host_stage(x)[0], want_u8)


def test_no_libjpeg_and_no_cv2_refuses_by_name(lib, monkeypatch):
    monkeypatch.setattr(native, "_missing_jpeg", "jpeglib.h: No such file")
    monkeypatch.setattr(native, "_libs", {})
    assert native.available() and not native.decode_available()
    with pytest.raises(native.LibjpegMissing, match="libjpeg"):
        native.decode_batch([b"x"], channels=3, out_h=4, out_w=4)
    tl, _ = _encoded_layer("unused")
    ts = get_source(tl, phase_train=True, seed=3)
    recs = _encoded_records(4, seed=13)
    got = ts.next_batch(recs)              # cv2 takes over
    assert got["data"].shape == (4, 3, 20, 20)
    monkeypatch.setattr(source_mod, "_cv2", lambda: None)
    with pytest.raises(RuntimeError, match="(?s)libjpeg.*cv2"):
        ts.next_batch(recs)
    monkeypatch.setenv("COS_NATIVE", "0")
    with pytest.raises(RuntimeError, match="COS_NATIVE=0.*cv2"):
        ts.next_batch(recs)


def test_build_failure_raises(lib, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ["-fno-such-option"])
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ cos_bytes.cpp failed"):
        native.available()
    assert not list(tmp_path.glob("*.so"))


def test_tune_decode_threads(lib):
    tl, _ = _encoded_layer("unused")
    for width, preset, want in ((2, 0, 1), (1, 0, 0), (4, 3, 3), (0, 0, 0)):
        src = get_source(tl, phase_train=True, seed=1, num_threads=preset)
        tune_decode_threads(src, width)
        assert src.num_threads == want


def _lenet_encoded(tmp_path, n=48):
    """LeNet (the JAX zoo's) on an LMDB of grayscale JPEG Datums with
    random crop 24 and mirror; a 6-step solver."""
    jpegs, _ = _jpegs(n, 1, 28, 28, seed=21)
    labels = np.random.RandomState(22).randint(0, 10, n)
    path = str(tmp_path / "lmdb")
    LmdbWriter(path).write([
        (b"%08d" % i, Datum(channels=1, height=28, width=28, data=j,
                            encoded=True, label=int(labels[i])).to_binary())
        for i, j in enumerate(jpegs)])
    npm = jax_zoo.lenet(8)
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.LMDB"
    data.memory_data_param.source = path
    data.transform_param.crop_size = 24
    data.transform_param.mirror = True
    (tmp_path / "net.prototxt").write_text(npm.to_text())
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{tmp_path / "net.prototxt"}"\nbase_lr: 0.01\n'
                      'momentum: 0.9\nlr_policy: "fixed"\nmax_iter: 6\n'
                      'random_seed: 13\ndisplay: 1\nsnapshot: 3\n')
    ts = Solver(SolverParameter.from_text("base_lr: 0.01"),
                NetParameter.from_text(npm.to_text()), device="cpu")
    init = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(init, ts.train_net, ts.train_net.init(21))
    return str(solver), init


def test_encoded_lmdb_trains_through_the_cli_like_jax(lib, tmp_path,
                                                      monkeypatch):
    """Both CLIs (-train) train LeNet on the encoded LMDB from one
    -weights file (shuffled, cropped, mirrored; decoded natively, one
    thread a call under the pool): the snapshot at 3 and the final
    models agree (rtol 1e-4, as tests/test_torch_train_data.py's CLI
    test), every logged loss is finite."""
    solver, init = _lenet_encoded(tmp_path)
    monkeypatch.setenv("COS_PIPELINE_METRICS", str(tmp_path / "t.json"))
    assert caffe_on_spark.main(["-conf", solver, "-train", "-weights", init,
                                "-output", str(tmp_path / "t"),
                                "-device", "cpu"]) == 0
    monkeypatch.delenv("COS_PIPELINE_METRICS")
    assert jax_cos.main(["-conf", solver, "-train", "-weights", init,
                         "-output", str(tmp_path / "j"), "-devices",
                         "1"]) == 0
    info = json.load(open(tmp_path / "t.json"))["info"]["train"]
    assert info["iter"] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(info["loss"]))
    for name in ("model_iter_3.caffemodel", "model.caffemodel"):
        got = checkpoint.load_caffemodel_blobs(str(tmp_path / "t" / name))
        want = jax_ckpt.load_caffemodel_blobs(str(tmp_path / "j" / name))
        assert set(got) == set(want)
        for ln in want:
            for g, w in zip(got[ln], want[ln]):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7,
                                           err_msg=ln)


def test_encoded_lmdb_losses_equal_jax_mini_cluster(lib, tmp_path):
    """Both standalone trainers on the encoded LMDB from one -weights:
    every step's loss (-metrics, display 1) to rtol 1e-5."""
    solver, init = _lenet_encoded(tmp_path)
    runs = {}
    for key, main, extra in (("t", mini_cluster.main, ["-device", "cpu"]),
                             ("j", jax_mc.main, ["-devices", "1"])):
        out = tmp_path / key
        out.mkdir()
        assert main(["-solver", solver, "-weights", init, "-output",
                     str(out), "-metrics", str(out / "m.jsonl"),
                     *extra]) == 0
        with open(out / "m.jsonl") as f:
            runs[key] = [json.loads(x) for x in f if x.strip()]
    assert [r["iter"] for r in runs["t"]] == [r["iter"] for r in runs["j"]] \
        == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose([r["loss"] for r in runs["t"]],
                               [r["loss"] for r in runs["j"]], rtol=1e-5)


@pytest.mark.parametrize("bad", ["short", "offset", "crop"])
def test_out_of_bounds_arguments_raise(lib, bad):
    """Offsets, flags and crops that would read outside the input are
    refused before any pointer reaches the library."""
    x = np.zeros((3, 1, 8, 8), np.uint8)
    hs, ws, flip = np.zeros(3, int), np.zeros(3, int), np.zeros(3, bool)
    crop = 5
    if bad == "short":
        hs = hs[:2]
    elif bad == "offset":
        ws[1] = 4
    else:
        crop = 9
    with pytest.raises(ValueError):
        lib.crop_mirror_u8(x, hs, ws, flip, crop=crop)
    with pytest.raises(ValueError):
        lib.transform_batch(x.astype(np.float32), crop=crop, h_off=hs,
                            w_off=ws, mirror=flip)
