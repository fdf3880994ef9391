"""The PyTorch port's serving path against the JAX package's.

Both packages serve the same narrow AlexNet-shaped net from the same
.caffemodel, written by the JAX package, on the same records; the
port's rows must match the JAX InferenceService's (f32: rtol 1e-4,
atol 1e-5, the convolutions' summation order; int8: see
test_int8_service_matches_jax).  Within the port, a full bucket's
serving rows equal its own fetch_rows of one direct forward byte for
byte (the counterpart of tests/test_serving.py:270), and the HTTP front
end and the CLI answer the same rows as the in-process client.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.config import Config as JaxConfig
from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import Phase as JaxPhase
from caffeonspark_tpu.serving import Client as JaxClient
from caffeonspark_tpu.serving import InferenceService as JaxService
from caffeonspark_tpu.serving import make_buckets as jax_make_buckets
from caffeonspark_tpu_torch.config import Config
from caffeonspark_tpu_torch.serving import (Client, InferenceService,
                                            MicroBatcher, QueueFullError,
                                            ServingHTTPServer, bucket_for,
                                            make_buckets)
from caffeonspark_tpu_torch.serving.forward import fetch_rows
from torch_port_helpers import CROP, jax_params_numpy, narrow_net_text
from torch_common import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LMDB = "com.yahoo.ml.caffe.LMDB"

MLP = """
name: "mlp"
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  source_class: "{cls}"
  memory_data_param {{ source: "{root}/unused" batch_size: 4 channels: 1
    height: 8 width: 8 }} }}
layer {{ name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
  inner_product_param {{ num_output: 32
    weight_filler {{ type: "gaussian" std: 0.1 }}
    bias_filler {{ type: "uniform" min: -0.5 max: 0.5 }} }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }}
layer {{ name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param {{ num_output: 40
    weight_filler {{ type: "gaussian" std: 0.1 }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip2"
  bottom: "label" top: "loss" }}
"""


def _write_model(tmp_path, net_text, seed=0, name="m"):
    """prototxts + a .caffemodel the JAX package wrote."""
    net_path = tmp_path / f"{name}_net.prototxt"
    net_path.write_text(net_text)
    solver_path = tmp_path / f"{name}_solver.prototxt"
    solver_path.write_text(f'net: "{net_path}"\nbase_lr: 0.01\n'
                           'lr_policy: "fixed"\n')
    jnet = JaxNet(JaxNetParameter.from_text(net_text),
                  JaxNetState(phase=JaxPhase.TEST))
    model = str(tmp_path / f"{name}.caffemodel")
    jax_ckpt.save_caffemodel(model, jnet, jax_params_numpy(jnet, seed))
    return str(solver_path), model


@pytest.fixture()
def alexnet_model(tmp_path):
    return _write_model(tmp_path, narrow_net_text(
        "alexnet", source_class=LMDB, source=str(tmp_path / "unused")))


def _records(n, c=3, h=CROP, w=CROP, seed=0):
    return [(f"{i:04d}", float(i % 3), c, h, w, False,
             np.random.RandomState(seed + i).randint(0, 256, (c, h, w))
             .astype(np.float32)) for i in range(n)]


def _port(solver, model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 200)
    conf = Config(["-conf", solver, "-model", model, "-features", "fc8",
                   "-device", "cpu"])
    return InferenceService(conf, **kw)


def _jax(solver, model, features="fc8"):
    conf = JaxConfig(["-conf", solver, "-model", model, "-features",
                      features])
    return JaxService(conf, max_batch=4, max_wait_ms=200)


def _serve_rows(svc, client_cls, recs):
    svc.start()
    try:
        return client_cls(svc).predict(recs)
    finally:
        svc.stop()


def _col(rows, blob):
    return np.asarray([r[blob] for r in rows], np.float32)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, json.loads(r.read().decode())


def test_service_and_http_match_jax(alexnet_model):
    """f32: the port's in-process rows match the JAX service's; the
    HTTP front end answers byte-equal rows; /healthz, /metrics and
    /v1/reload work; malformed requests get 400."""
    solver, model = alexnet_model
    recs = _records(4)
    want = _serve_rows(_jax(solver, model), JaxClient, recs)
    svc = _port(solver, model)
    svc.start()
    httpd = ServingHTTPServer(svc).start_background()
    try:
        got = Client(svc).predict(recs)
        code, out = _post(httpd.port, "/v1/predict", {"records": [
            {"id": r[0], "label": r[1], "data": r[6].ravel().tolist()}
            for r in recs]})
        assert code == 200 and out["model_version"] == 1
        assert out["rows"] == got                   # byte-equal floats
        code, health = _get(httpd.port, "/healthz")
        assert code == 200 and health["status"] == "ok"
        code, metrics = _get(httpd.port, "/metrics")
        assert metrics["counters"]["served_rows"] == 8
        assert set(metrics["kernel_launches"]) == {
            "lrn_across_channels", "lrn_across_channels_bwd",
            "bias_relu_lrn_across_channels",
            "bias_relu_lrn_across_channels_bwd", "int8_matmul",
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "flash_block_update"}
        assert metrics["buckets"] == [1, 2, 4]
        code, out = _post(httpd.port, "/v1/reload", {"model": model})
        assert code == 200 and out["model_version"] == 2
        code, out = _post(httpd.port, "/v1/predict",
                          {"records": [{"id": "x", "data": [1.0, 2.0]}]})
        assert code == 400
        code, out = _post(httpd.port, "/v1/predict", {"nothing": 1})
        assert code == 400
        code, out = _post(httpd.port, "/v1/reload", {})
        assert code == 400
    finally:
        httpd.stop()
        svc.stop()
    assert [r["SampleID"] for r in got] == [r["SampleID"] for r in want]
    np.testing.assert_allclose(_col(got, "fc8"), _col(want, "fc8"),
                               rtol=1e-4, atol=1e-5)


def test_int8_service_matches_jax(alexnet_model, monkeypatch):
    """COS_SERVE_WEIGHT_DTYPE=int8 with the bias+ReLU+LRN epilogue: both
    packages keep int8 InnerProduct weights resident (the port's HTTP
    front end answering the in-process rows exactly) and agree within
    one int8 step of the activations: the convolutions' last-bit
    differences can move an activation across a rounding boundary of
    its per-batch int8 scale, which changes that input by 1/127 of the
    layer's max, so the bound is 1e-2 of max |fc8|."""
    monkeypatch.setenv("COS_SERVE_WEIGHT_DTYPE", "int8")
    monkeypatch.setenv("COS_FUSE_BIAS_RELU_LRN", "1")
    solver, model = alexnet_model
    recs = _records(4, seed=40)
    jsvc = _jax(solver, model)
    assert jsvc.registry.current().weight_dtype == "int8"
    want = _serve_rows(jsvc, JaxClient, recs)
    svc = _port(solver, model)
    mv = svc.registry.current()
    assert mv.weight_dtype == "int8"
    # fc7 (32x32) is the narrow net's one InnerProduct weight at or above
    # quant.MIN_QUANT_ELEMS
    assert mv.params["fc7"]["weight"].dtype == torch.int8
    assert svc.registry.net.fused_bias_lrn == {"norm1": "conv1",
                                               "norm2": "conv2"}
    svc.start()
    httpd = ServingHTTPServer(svc).start_background()
    try:
        got = Client(svc).predict(recs)
        code, out = _post(httpd.port, "/v1/predict", {"records": [
            {"id": r[0], "data": r[6].ravel().tolist()} for r in recs]})
    finally:
        httpd.stop()
        svc.stop()
    assert code == 200 and out["rows"] == got
    g, w = _col(got, "fc8"), _col(want, "fc8")
    assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()


def test_int8_mlp_matches_jax_bit_for_bit(tmp_path, monkeypatch):
    """Without convolutions in front of it, the int8 path agrees with
    the JAX package exactly: both quantize with the same max-abs scale
    and round half to even, the int32 sums are exact, and the f32
    rescale is the same operation."""
    monkeypatch.setenv("COS_SERVE_WEIGHT_DTYPE", "int8")
    solver, model = _write_model(tmp_path, MLP.format(cls=LMDB,
                                                      root=tmp_path))
    rng = np.random.RandomState(3)
    recs = [(f"{i}", 0.0, 1, 8, 8, False,
             rng.randn(1, 8, 8).astype(np.float32)) for i in range(4)]
    conf = JaxConfig(["-conf", solver, "-model", model, "-features",
                      "ip2"])
    want = _serve_rows(JaxService(conf, max_batch=4, max_wait_ms=200),
                       JaxClient, recs)
    conf = Config(["-conf", solver, "-model", model, "-features", "ip2",
                   "-device", "cpu"])
    svc = InferenceService(conf, max_batch=4, max_wait_ms=200)
    assert svc.registry.current().weight_dtype == "int8"
    assert _serve_rows(svc, Client, recs) == want


def test_bf16_storage_matches_jax(alexnet_model, monkeypatch):
    """COS_SERVE_WEIGHT_DTYPE=bf16: both packages round the weights to
    bf16 (to nearest even) at publish and compute in f32, so the rows
    agree to the f32 tolerance."""
    monkeypatch.setenv("COS_SERVE_WEIGHT_DTYPE", "bf16")
    solver, model = alexnet_model
    recs = _records(2, seed=60)
    want = _serve_rows(_jax(solver, model), JaxClient, recs)
    svc = _port(solver, model)
    mv = svc.registry.current()
    assert mv.weight_dtype == "bf16"
    assert mv.params["conv2"]["weight"].dtype == torch.bfloat16
    got = _serve_rows(svc, Client, recs)
    np.testing.assert_allclose(_col(got, "fc8"), _col(want, "fc8"),
                               rtol=1e-4, atol=1e-5)


def test_solverstate_resolves_its_learned_net(alexnet_model, tmp_path):
    """-model may name a .solverstate: its learned_net resolves next to
    it, as in the JAX package."""
    from caffeonspark_tpu_torch.proto import SolverState
    solver, model = alexnet_model
    state = tmp_path / "snap_iter_10.solverstate"
    state.write_bytes(SolverState(iter=10, learned_net="/elsewhere/"
                                  + os.path.basename(model)).to_binary())
    a = _port(solver, model).registry.current().params
    b = _port(solver, str(state)).registry.current().params
    assert all(torch.equal(a[ln][bn], b[ln][bn])
               for ln in a for bn in a[ln])


@pytest.mark.parametrize("weight_dtype", ["f32", "int8"])
def test_full_bucket_rows_equal_direct_forward(alexnet_model, monkeypatch,
                                               weight_dtype):
    monkeypatch.setenv("COS_SERVE_WEIGHT_DTYPE", weight_dtype)
    solver, model = alexnet_model
    recs = _records(4, seed=20)
    svc = _port(solver, model)
    mv = svc.registry.current()
    host = svc.source.next_batch(recs)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    fwd = svc.registry.forward(svc.blob_names,
                               weight_dtype=mv.weight_dtype)
    out = (fwd(mv.params, batch) if mv.weight_dtype == "f32"
           else fwd(mv.params, mv.scales, batch))
    direct = fetch_rows(out, svc.blob_names, [r[0] for r in recs], 4, 4)
    served = _serve_rows(svc, Client, recs)
    assert served == direct
    assert svc.metrics.get_counter("flush_bucket_4") == 1


def test_drift_gate_falls_back_to_f32(alexnet_model, monkeypatch):
    monkeypatch.setenv("COS_SERVE_WEIGHT_DTYPE", "int8")
    monkeypatch.setenv("COS_SERVE_QUANT_TOL", "0")
    svc = _port(*alexnet_model)
    assert svc.registry.current().weight_dtype == "f32"
    assert svc.registry.quant_fallback.startswith("drift")


def test_cli_serve_boots_answers_and_drains(alexnet_model, tmp_path):
    """`python -m caffeonspark_tpu_torch.caffe_on_spark -serve` prints
    the JAX package's one-line boot JSON, answers /v1/predict, and exits
    0 on SIGINT after draining (metrics dumped to COS_SERVE_METRICS)."""
    solver, model = alexnet_model
    metrics_path = tmp_path / "serve_metrics.json"
    env = dict(os.environ, PYTHONPATH=REPO, COS_SERVE_MAX_BATCH="2",
               COS_SERVE_METRICS=str(metrics_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "caffeonspark_tpu_torch.caffe_on_spark",
         "-conf", solver, "-serve", "-model", model, "-features", "fc8",
         "-device", "cpu"], stdout=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))
    try:
        boot = json.loads(proc.stdout.readline())
        assert boot["serving"] is True and boot["model_version"] == 1
        assert boot["buckets"] == [1, 2]
        rec = _records(1, seed=9)[0]
        code, out = _post(boot["port"], "/v1/predict",
                          {"id": "a", "data": rec[6].ravel().tolist()})
        assert code == 200 and out["rows"][0]["SampleID"] == "a"
        assert len(out["rows"][0]["fc8"]) == 10
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    assert rc == 0
    dumped = json.loads(metrics_path.read_text())
    assert dumped["counters"]["served_rows"] == 1


@pytest.mark.parametrize("max_batch", [1, 4, 6, 64])
def test_buckets_match_jax(max_batch):
    assert make_buckets(max_batch) == jax_make_buckets(max_batch)
    b = make_buckets(max_batch)
    assert bucket_for(1, b) == 1 and bucket_for(max_batch, b) == max_batch
    with pytest.raises(ValueError):
        bucket_for(max_batch + 1, b)


def test_batcher_queue_full_and_failure_isolation():
    calls = []

    def run(records, bucket):
        calls.append((list(records), bucket))
        if records[0] == "boom":
            raise RuntimeError("boom")
        return [{"v": [float(r)]} for r in records], 7

    b = MicroBatcher(run, max_batch=2, queue_depth=2, max_wait_ms=1)
    b.submit(1)
    b.submit(2)
    with pytest.raises(QueueFullError):       # not started: queue holds
        b.submit(3)
    b.start()
    try:
        bad = b.submit("boom")
        with pytest.raises(RuntimeError, match="boom"):
            bad.wait(10.0)
        p = b.submit(5)
        assert p.wait(10.0) == {"v": [5.0]} and p.model_version == 7
    finally:
        b.stop()
