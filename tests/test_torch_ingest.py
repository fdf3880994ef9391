"""The port's pipelined image ingest against the JAX package's, on the CPU.

  * `TransformerPool`: batches come out in feed order whatever order the
    workers finish in, the ragged epoch tail is dropped, the pool ends
    once, a failed pack is skipped (or returned as DROPPED) and a run of
    failures aborts at the limit;
  * with COS_TRANSFORM_THREADS=2 the pool packs batches bit-equal to the
    inline path (the dispatcher draws the augmentation in feed order),
    and the CLI's final .caffemodel is byte-equal between 0 and 2
    threads;
  * the device-side transform: the port's `host_stage` + torch
    `device_stage_fn` against the JAX `Transformer` at atol 1e-5, for
    the six TransformationParameter cases of the JAX package's
    test_device_transform_parity, and through the CLI;
  * `device_prefetch` in the foreground and on a stager thread;
  * per-phase drop counters: a bad validation record drops its batch,
    counted apart from training's, and the round still counts it.
Every wait on a thread has a timeout; no test asserts on timing.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from caffeonspark_tpu.data.transformer import Transformer as JaxTransformer
from caffeonspark_tpu.proto.caffe import BlobProto as JaxBlobProto
from caffeonspark_tpu.proto.caffe import BlobShape as JaxBlobShape
from caffeonspark_tpu.proto.caffe import \
    TransformationParameter as JaxTP
from caffeonspark_tpu_torch import caffe_on_spark
from caffeonspark_tpu_torch.data import LmdbWriter, get_source
from caffeonspark_tpu_torch.data import queue_runner as qr
from caffeonspark_tpu_torch.data.queue_runner import (DROPPED, FeedQueue,
                                                      TransformerPool,
                                                      device_prefetch)
from caffeonspark_tpu_torch.data.source import STOP_MARK
from caffeonspark_tpu_torch.data.transformer import (DEVICE_AUX_SUFFIX,
                                                     Transformer)
from caffeonspark_tpu_torch.metrics import PipelineMetrics
from caffeonspark_tpu_torch.proto import NetParameter
from caffeonspark_tpu_torch.proto.caffe import (Datum,
                                                TransformationParameter)
from torch_common import cap_torch_threads

cap_torch_threads()

WAIT = 30.0      # the bound of every wait on a pool thread


def drain(pool, n=None):
    """Up to n batches (all when None) with a bounded wait each."""
    out = []
    while n is None or len(out) < n:
        b = pool.take(timeout=WAIT)
        if b is None:
            break
        out.append(b)
    return out


def feed(q, items, end=True):
    for it in items:
        assert q.offer(it, timeout=WAIT)
    if end:
        assert q.offer(None, timeout=WAIT)


# ---------------------------------------------------------------------------
# TransformerPool
# ---------------------------------------------------------------------------

def test_pool_emits_in_feed_order_when_workers_finish_out_of_order():
    """Batch 0's pack waits until batch 1's has finished: the output is
    still 0, 1, 2, ..."""
    one_done = threading.Event()

    def pack(buf, draw):
        if buf[0] == 0:
            assert one_done.wait(WAIT)
        if buf[0] == 2:
            one_done.set()
        return list(buf)

    q = FeedQueue()
    pool = TransformerPool(q, 2, pack, num_threads=2).start()
    try:
        feed(q, range(12))
        assert drain(pool) == [[i, i + 1] for i in range(0, 12, 2)]
        assert pool.take(timeout=WAIT) is None     # one terminal, kept
        assert pool.take(timeout=WAIT) is None
    finally:
        pool.stop(join_timeout=WAIT)


def test_pool_drops_the_ragged_epoch_tail_and_draws_in_feed_order():
    m = PipelineMetrics()
    draws = []

    def draw_fn(n):
        draws.append(n)
        return len(draws)

    q = FeedQueue()
    pool = TransformerPool(q, 3, lambda buf, d: (list(buf), d),
                           num_threads=2, draw_fn=draw_fn,
                           metrics=m).start()
    try:
        feed(q, [0, 1, 2, 3, 4, STOP_MARK, 5, 6, 7, 8])
        got = drain(pool)
    finally:
        pool.stop(join_timeout=WAIT)
    assert got == [([0, 1, 2], 1), ([5, 6, 7], 2)]
    assert draws == [3, 3]
    assert m.get_counter("ragged_tail_records") == 2


def test_pool_skips_a_failed_pack_and_aborts_at_the_limit():
    def pack(buf, draw):
        if buf[0] in (2, 6):
            raise ValueError(f"bad record {buf[0]}")
        return buf[0]

    q = FeedQueue()
    pool = TransformerPool(q, 2, pack, num_threads=2).start()
    try:
        feed(q, range(10))
        assert drain(pool) == [0, 4, 8]
        assert pool.drops == 2
    finally:
        pool.stop(join_timeout=WAIT)
    q = FeedQueue()
    pool = TransformerPool(q, 2, pack, num_threads=1).start()
    try:
        feed(q, range(8))
        assert [pool.take(timeout=WAIT, skip_dropped=False)
                for _ in range(4)] == [0, DROPPED, 4, DROPPED]
    finally:
        pool.stop(join_timeout=WAIT)

    def always(buf, draw):
        raise ValueError("corrupt")

    q = FeedQueue()
    pool = TransformerPool(q, 1, always, num_threads=2, drop_limit=5).start()
    try:
        feed(q, range(50), end=False)
        with pytest.raises(RuntimeError, match="5 consecutive batch "
                                               "failures.*corrupt"):
            drain(pool)
    finally:
        q.stop()
        pool.stop(join_timeout=WAIT)


def test_pool_stress_more_workers_than_cores():
    """More workers than cores and a very short switch interval: every
    batch comes out once, in feed order, and every failed pack is
    counted once (a lost update in the results window or the drop
    count would break one of them)."""
    import sys
    workers = (os.cpu_count() or 2) + 2
    fails = set(range(3, 400, 7))

    def pack(buf, draw):
        if buf[0] // 2 in fails:
            raise ValueError("bad")
        return buf[0] // 2

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    q = FeedQueue()
    pool = TransformerPool(q, 2, pack, num_threads=workers,
                           drop_limit=10 ** 6).start()
    try:
        feed(q, range(800))
        got = drain(pool)
    finally:
        sys.setswitchinterval(old)
        pool.stop(join_timeout=WAIT)
    assert got == [i for i in range(400) if i not in fails]
    assert pool.drops == len(fails)
    assert not any(t.is_alive() for t in pool._threads)


def _records(n, c=3, h=12, w=12, seed=0):
    rng = np.random.RandomState(seed)
    return [(b"%08d" % i, Datum(
        channels=c, height=h, width=w,
        data=rng.randint(0, 256, c * h * w).astype(np.uint8).tobytes(),
        label=int(rng.randint(10))).to_binary()) for i in range(n)]


def _layer(src, tp="crop_size: 8 mirror: true mean_value: 100 "
                   "scale: 0.5", batch=4, test=False):
    phase = " include { phase: TEST }" if test else ""
    return NetParameter.from_text(
        'layer { name: "d" type: "MemoryData" top: "data" top: "label" '
        f'source_class: "com.yahoo.ml.caffe.LMDB"{phase} '
        f'transform_param {{ {tp} }} '
        f'memory_data_param {{ source: "{src}" batch_size: {batch} '
        'channels: 3 height: 12 width: 12 } }').layer[0]


def test_pool_packs_bit_equal_to_the_inline_path(tmp_path):
    """Two workers and the dispatcher's ordered draws give the inline
    path's batches, bit for bit, random crop and mirror included."""
    path = str(tmp_path / "db")
    LmdbWriter(path).write(_records(40, seed=1))
    lp = _layer(path)
    inline = get_source(lp, phase_train=True, seed=3)
    recs = list(inline.records())
    want = [inline.next_batch(recs[i:i + 4]) for i in range(0, 40, 4)]
    src = get_source(lp, phase_train=True, seed=3)
    q = FeedQueue()
    pool = TransformerPool(q, src.batch_size, src.pack_batch,
                           draw_fn=src.make_draw_fn(),
                           num_threads=2).start()
    try:
        feed(q, recs)
        got = drain(pool)
    finally:
        pool.stop(join_timeout=WAIT)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["data", "label"]
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_knobs_keep_the_jax_package_names_and_defaults(monkeypatch):
    for k in ("COS_TRANSFORM_THREADS", "COS_STAGE_DEPTH", "COS_STAGE_BG"):
        monkeypatch.delenv(k, raising=False)
    assert qr.transform_threads() == 2 and qr.stage_depth() == 2
    assert not qr.stage_background(torch.device("cpu"))
    assert qr.stage_background(torch.device("cuda"))
    monkeypatch.setenv("COS_TRANSFORM_THREADS", "0")
    monkeypatch.setenv("COS_STAGE_DEPTH", "5")
    monkeypatch.setenv("COS_STAGE_BG", "1")
    assert qr.transform_threads() == 0 and qr.stage_depth() == 5
    assert qr.stage_background(torch.device("cpu"))
    monkeypatch.setenv("COS_STAGE_BG", "0")
    assert not qr.stage_background(torch.device("cuda"))


# ---------------------------------------------------------------------------
# the device-side transform
# ---------------------------------------------------------------------------

def _mean_file(tmp_path, arr, name):
    p = tmp_path / name
    p.write_bytes(JaxBlobProto(shape=JaxBlobShape(dim=[1, *arr.shape]),
                               data=[float(v) for v in arr.ravel()]
                               ).to_binary())
    return str(p)


@pytest.mark.parametrize("case", range(6))
def test_device_stage_matches_the_jax_transformer(tmp_path, case):
    """host_stage + the torch device stage against the JAX Transformer's
    host transform (atol 1e-5, as the JAX package's parity test), both
    phases, for its six cases: mean_value, crop + mirror + scale, a
    full-size and a crop-size mean_file, a full-size mean with mirror
    and no crop, and nothing."""
    rs = np.random.RandomState(3)
    mean_full = rs.rand(3, 12, 12).astype(np.float32) * 20
    mean_crop = rs.rand(3, 8, 8).astype(np.float32) * 20
    full = _mean_file(tmp_path, mean_full, "full.binaryproto")
    crop = _mean_file(tmp_path, mean_crop, "crop.binaryproto")
    text = [
        "scale: 0.00390625 mean_value: 104 mean_value: 117 "
        "mean_value: 123",
        "crop_size: 8 mirror: true scale: 0.5",
        f'crop_size: 8 mirror: true mean_file: "{full}"',
        f'crop_size: 8 mean_file: "{crop}"',
        f'mean_file: "{full}" mirror: true',
        ""][case]
    x = rs.randint(0, 256, size=(6, 3, 12, 12)).astype(np.float32)
    for train in (True, False):
        want = JaxTransformer(JaxTP.from_text(text), phase_train=train,
                              seed=11)(x.copy())
        t = Transformer(TransformationParameter.from_text(text),
                        phase_train=train, seed=11)
        assert t.device_eligible(12, 12)
        u8, aux = t.host_stage(x.copy())
        assert u8.dtype == np.uint8 and aux.shape == (6, 3)
        got = t.device_stage_fn()(torch.from_numpy(u8),
                                  torch.from_numpy(aux))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        # and the port's own host transform, from the same draws
        np.testing.assert_allclose(
            Transformer(TransformationParameter.from_text(text),
                        phase_train=train, seed=11)(x.copy()),
            want, atol=1e-5, rtol=0)


def test_device_transform_source_split(tmp_path, monkeypatch):
    """COS_DEVICE_TRANSFORM=1: next_batch ships uint8 + aux, and the
    staged batch equals the host path's; a float payload is refused
    with the JAX package's error; an ineligible mean keeps the host
    path."""
    path = str(tmp_path / "db")
    LmdbWriter(path).write(_records(8, seed=2))
    lp = _layer(path)
    host = get_source(lp, phase_train=True, seed=4)
    recs = list(host.records())
    want = host.next_batch(recs[:4])
    monkeypatch.setenv("COS_DEVICE_TRANSFORM", "1")
    src = get_source(lp, phase_train=True, seed=4)
    fns = src.enable_device_transform(torch.float32)
    assert list(fns) == ["data"]
    packed = src.next_batch(recs[:4])
    assert sorted(packed) == ["data", "data" + DEVICE_AUX_SUFFIX, "label"]
    assert packed["data"].dtype == np.uint8
    staged = src.apply_device_stage(packed, torch.device("cpu"))
    assert sorted(staged) == ["data", "label"]
    np.testing.assert_allclose(staged["data"].numpy(), want["data"],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(staged["label"].numpy(), want["label"])
    bad = ("x", 1.0, 3, 12, 12, False, np.zeros((3, 12, 12), np.float32))
    with pytest.raises(ValueError, match="COS_DEVICE_TRANSFORM=1 needs "
                                         "uint8/encoded pixel payloads"):
        src.next_batch([bad] * 4)
    mean = _mean_file(tmp_path, np.zeros((3, 10, 10), np.float32), "m10")
    odd = get_source(_layer(path, f'crop_size: 8 mean_file: "{mean}"'),
                     phase_train=True)
    assert odd.enable_device_transform() is None


@pytest.mark.parametrize("background", [False, True])
def test_device_prefetch_stages_in_order(background):
    """The foreground and the stager thread stage the same batches, in
    order, through the device stage, and time each one."""
    t = Transformer(TransformationParameter(mean_value=[10.0], scale=0.5),
                    phase_train=False)
    rng = np.random.RandomState(0)
    host = []
    for _ in range(5):
        u8, aux = t.host_stage(rng.randint(0, 256, (2, 1, 3, 3))
                               .astype(np.uint8))
        host.append({"data": u8, "data" + DEVICE_AUX_SUFFIX: aux,
                     "label": np.arange(2, dtype=np.float32)})
    m = PipelineMetrics()
    gen = device_prefetch(iter(host), "cpu", depth=2,
                          device_transforms={"data": t.device_stage_fn()},
                          background=background, metrics=m)
    got = list(gen)
    assert len(got) == 5
    for g, h in zip(got, host):
        assert sorted(g) == ["data", "label"]
        np.testing.assert_array_equal(
            g["data"].numpy(), (h["data"].astype(np.float32) - 10) * 0.5)
    assert m.summary()["stages"]["stage"]["count"] == 5


def test_device_prefetch_stager_error_and_close():
    def boom():
        yield {"x": np.zeros(2, np.float32)}
        raise ValueError("upstream")

    gen = device_prefetch(boom(), "cpu", background=True)
    assert next(gen)["x"].shape == (2,)
    with pytest.raises(ValueError, match="upstream"):
        next(gen)
    endless = ({"x": np.full(2, i, np.float32)} for i in range(10 ** 6))
    gen = device_prefetch(endless, "cpu", depth=1, background=True)
    assert float(next(gen)["x"][0]) == 0.0
    gen.close()          # the stager sees the stop flag and returns


# ---------------------------------------------------------------------------
# through the CLI
# ---------------------------------------------------------------------------

TRAIN_VAL = """name: "tiny"
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  include {{ phase: TRAIN }} source_class: "com.yahoo.ml.caffe.LMDB"
  transform_param {{ crop_size: 8 mirror: true mean_value: 120
                     scale: 0.01 }}
  memory_data_param {{ batch_size: 4 channels: 3 height: 12 width: 12
                      source: "{train}" }} }}
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  include {{ phase: TEST }} source_class: "com.yahoo.ml.caffe.LMDB"
  transform_param {{ crop_size: 8 mean_value: 120 scale: 0.01 }}
  memory_data_param {{ batch_size: 4 channels: 3 height: 12 width: 12
                      source: "{test}" }} }}
layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param {{ num_output: 10 weight_filler {{ type: "xavier" }}
  }} }}
layer {{ name: "accuracy" type: "Accuracy" bottom: "ip" bottom: "label"
  top: "accuracy" include {{ phase: TEST }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }}
"""


def _cli_config(tmp_path, test_records=None, max_iter=12):
    train, test = tmp_path / "train", tmp_path / "test"
    if not train.exists():
        LmdbWriter(str(train)).write(_records(36, seed=5))
        LmdbWriter(str(test)).write(test_records or _records(16, seed=6))
    net = tmp_path / "net.prototxt"
    net.write_text(TRAIN_VAL.format(train=train, test=test))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.05\nmomentum: 0.9\n'
                      f'lr_policy: "fixed"\nmax_iter: {max_iter}\n'
                      'test_interval: 4\ntest_iter: 2\nrandom_seed: 7\n')
    return str(solver)


def _train(tmp_path, monkeypatch, name, env):
    for k in ("COS_TRANSFORM_THREADS", "COS_DEVICE_TRANSFORM",
              "COS_STAGE_BG"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / name
    monkeypatch.setenv("COS_PIPELINE_METRICS", str(out) + ".json")
    assert caffe_on_spark.main(["-conf", _cli_config(tmp_path), "-train",
                                "-output", str(out), "-device",
                                "cpu"]) == 0
    return (open(out / "model.caffemodel", "rb").read(),
            [json.loads(x) for x in open(out / "validation.json")],
            json.load(open(str(out) + ".json")))


def test_cli_models_equal_across_threads_and_the_device_transform(
        tmp_path, monkeypatch):
    """The final .caffemodel is byte-equal between 0 and 2 pool threads
    (and with the stager thread on), and with the device-side transform;
    the validation rounds are equal too."""
    ref, val, m0 = _train(tmp_path, monkeypatch, "t0",
                          {"COS_TRANSFORM_THREADS": "0"})
    assert len(val) == 3
    for name, env in (("t2", {}),
                      ("bg", {"COS_STAGE_BG": "1"}),
                      ("dx", {"COS_DEVICE_TRANSFORM": "1"}),
                      ("dx0", {"COS_DEVICE_TRANSFORM": "1",
                               "COS_TRANSFORM_THREADS": "0"})):
        model, rounds, m = _train(tmp_path, monkeypatch, name, env)
        assert model == ref, name
        assert rounds == val, name
        assert m["info"]["train"]["loss"] == m0["info"]["train"]["loss"]
        # 12 train batches and 3 rounds of 2 validation batches packed
        assert m["stages"]["pack"]["count"] == 12 + 6, name
        assert m["stages"]["stage"]["count"] == 12, name


@pytest.mark.parametrize("threads", ["0", "2"])
def test_per_phase_drop_counters(tmp_path, monkeypatch, threads):
    """A bad validation record drops its batch, packed inline or on the
    pool: counted as a validation drop (the round still counts it, no
    training top-up), not as a training drop; the run trains to the
    end."""
    monkeypatch.setenv("COS_TRANSFORM_THREADS", threads)
    good = _records(15, seed=6)
    bad = _records(1, h=9, w=9, seed=8)[0]
    recs = sorted(good + [(b"00000003x", bad[1])])
    monkeypatch.setenv("COS_PIPELINE_METRICS", str(tmp_path / "m.json"))
    solver = _cli_config(tmp_path, test_records=recs)
    assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                str(tmp_path / "out"), "-device",
                                "cpu"]) == 0
    m = json.load(open(tmp_path / "m.json"))
    # 16 records, rounds of 8: the bad one is in rounds 1 and 3
    assert m["counters"]["dropped_val_batches"] == 2
    assert "dropped_batches" not in m["counters"]
    assert m["info"]["train"]["iter"] == list(range(1, 13))
    rounds = [json.loads(x) for x in open(tmp_path / "out" /
                                          "validation.json")]
    assert len(rounds) == 3


def test_processor_drop_accounting_is_per_phase(tmp_path):
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.processor import CaffeProcessor
    conf = Config(["-conf", _cli_config(tmp_path), "-train", "-device",
                   "cpu"])
    proc = CaffeProcessor(conf)
    err = ValueError("bad")
    for _ in range(19):
        proc._note_pack_drop(err, val=True)
    proc._note_pack_drop(err)                 # a train drop between
    proc._note_pack_ok()                      # and a train success
    with pytest.raises(RuntimeError, match="20 consecutive"):
        proc._note_pack_drop(err, val=True)
    assert (proc.dropped_batches, proc.dropped_val_batches) == (1, 20)
    proc._note_pack_ok(val=True)
    proc._note_pack_drop(err, val=True)
    assert proc._consecutive_val_drops == 1
