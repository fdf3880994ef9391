"""The gradient exchange of the PyTorch port (`parallel/gradsync.py`,
COS_GRAD_SYNC) against the JAX package's (`caffeonspark_tpu/parallel/
gradsync.py`) on its 8 virtual CPU devices (tests/conftest.py).

The port's dp ranks all sit on the CPU.  Parameters move as numpy from
the port's fillers; batches are numpy with a seed.  The JAX side is
jitted.  What is held, and to what tolerance:
  * the plan (`build_plan` through `GradSync.plan`) equal to JAX's field
    for field, with `comm_info`, `exposed_wire_bytes` and
    `tier_wire_bytes` over a grid and `n_messages`, in every mode and
    wire dtype at COS_GRAD_BUCKET_MB 0.5 and 25, for the tiny net,
    full-width CaffeNet, the LM, a reduced ResNet (BatchNorm's
    statistics skipped) and the LM on a dp 2 x tp 2 layout (its tp
    blocks skipped);
  * `default` and unset byte-identical (params and optimizer state, 20
    steps) at dp 1 and at dp 4 with ZeRO-1 in chunks of K = 4, the
    exchange never entered;
  * `bucket` and `hier` byte-equal to `default` in the port at dp 1, 4
    and 8 (a bucket whose numel 8 does not divide: hier's padding),
    with the backward hooks and with COS_GRAD_OVERLAP=0;
  * each mode against JAX's at dp 1, 2 and 8 over 10 steps: bucket and
    hier atol 1e-6 / rtol 1e-5 (the JAX package's own parity tolerance),
    quant in bf16 atol 2e-3 / rtol 1e-2 (its test_quant_bf16's); int8's
    first exchanged gradient within one quantum (the bucket's scale) of
    JAX's per element (the rounding streams differ); iter_size 2
    byte-equal to default at dp 1 and within 1e-6 at dp 2 (each rank's
    sum of its sub-batches, then one exchange); the modes with ZeRO-1 at
    dp 8 over 3 chunks of 4 at the same tolerances;
  * `quantize_int8` without a generator bit-equal to JAX's, and unbiased
    with one; its stream not Dropout's at the same seed;
  * `auto`, the hooks' gating, the `comm` block of both CLIs' metrics
    JSON (`-mesh 2`), the knobs acted on, invalid values refused;
  * one exchange a step, and two planted faults (the hook's sum summed
    again; rank 0's gradient only) failing the checks above.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.parallel import ParallelSolver as JaxParallelSolver
from caffeonspark_tpu.parallel import build_mesh as jax_build_mesh
from caffeonspark_tpu.parallel import gradsync as jax_gs
from caffeonspark_tpu.parallel.mesh import MeshLayout as JaxMeshLayout
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import Phase as JaxPhase
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import caffe_on_spark, config, convert, \
    mini_cluster
from caffeonspark_tpu_torch.config import Config
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.parallel import (MeshLayout, ParallelSolver,
                                             build_mesh, gradsync)
from caffeonspark_tpu_torch.parallel import comm
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.solver import Solver
from test_torch_batchnorm import _resnet_text
from test_torch_driver import init_model, write_config
from torch_common import cap_torch_threads

cap_torch_threads()

CPU = torch.device("cpu")
EXACT = dict(atol=1e-6, rtol=1e-5)      # bucket / hier against JAX
BF16 = dict(atol=2e-3, rtol=1e-2)       # quant bf16 against JAX
TOL = {"bucket": EXACT, "hier": EXACT, "quant": BF16}
KNOBS = ("COS_GRAD_SYNC", "COS_GRAD_BUCKET_MB", "COS_GRAD_OVERLAP",
         "COS_GRAD_WIRE_DTYPE")

# tests/test_gradsync.py's tiny net at a global batch of 32
NET = """
name: "tiny"
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 32 channels: 1 height: 28 width: 28 } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "fc_big" type: "InnerProduct" bottom: "conv1" top: "fc_big"
  inner_product_param { num_output: 2048
    weight_filler { type: "xavier" } } }
layer { name: "relu2" type: "ReLU" bottom: "fc_big" top: "fc_big" }
layer { name: "ip2" type: "InnerProduct" bottom: "fc_big" top: "ip2"
  inner_product_param { num_output: 10
    weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2"
  bottom: "label" top: "loss" }
"""
SOLVER = ('base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n'
          'max_iter: 200\nrandom_seed: 11\n')
# the LM of the card's phases, from its prototxt (no parameters made)
LM = dict(vocab=1000, d_model=1024, heads=16, layers=2, seq=2048, batch=4)


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _knobs(monkeypatch, mode=None, bucket_mb="0.5", wire=None,
           overlap=None):
    """The COS_GRAD_* knobs, which both packages read at Solver()."""
    for k, v in zip(KNOBS, (mode, bucket_mb, overlap, wire)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def _batch(seed, n=32):
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(n, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, n).astype(np.float32)}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port(solver_text=SOLVER, dp=1, zero=None, net_text=NET):
    """(stepper, params, state, params as numpy) of the port."""
    s = Solver(SolverParameter.from_text(solver_text),
               NetParameter.from_text(net_text), device="cpu")
    params = s.train_net.init(5)
    arrays = convert.params_to_numpy(params)
    st = s.init_state(params)
    if dp == 1:
        return s, params, st, arrays
    ps = ParallelSolver(s, build_mesh(dp=dp, devices=[CPU] * dp),
                        zero_dp=zero)
    return ps, ps.shard_params(params), ps.shard_opt_state(st), arrays


def _whole(t):
    return t.whole() if isinstance(t, comm.Shards) else t


def _state_numpy(st):
    return {f"{which}/{ln}/{bn}": _whole(t).numpy().copy()
            for which, tree in (("h", st.history), ("h2", st.history2))
            for ln, bl in tree.items() for bn, t in bl.items()}


def _port_run(steps, dp=1, solver_text=SOLVER, zero=None, k=1):
    step, p, st, arrays = _port(solver_text, dp, zero)
    batches = [_batch(3 + i) for i in range(steps)]
    if k == 1:
        for b in batches:
            step.train_step(p, st, _torch(b))
    else:
        many = step.train_step_many(k)
        for i in range(0, steps, k):
            many(p, st, {n: torch.from_numpy(np.stack([b[n] for b in
                                                       batches[i:i + k]]))
                         for n in batches[0]})
    return convert.params_to_numpy(p), _state_numpy(st), arrays, step


def _jax_solver(solver_text=SOLVER, net_text=NET):
    return JaxSolver(JaxSolverParameter.from_text(solver_text),
                     JaxNetParameter.from_text(net_text))


def _jax_params(arrays):
    return {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
            for ln, bl in arrays.items()}


def _jax_run(arrays, steps, dp, solver_text=SOLVER, zero=None, k=1):
    """The JAX ParallelSolver's steps (jitted) from the same params."""
    js = _jax_solver(solver_text)
    ps = JaxParallelSolver(js, jax_build_mesh(devices=jax.devices()[:dp],
                                              dp=dp), zero_dp=zero)
    jp = _jax_params(arrays)
    st = ps.shard_opt_state(js.init_state(jp))
    p = ps.shard_params(jp)
    batches = [_batch(3 + i) for i in range(steps)]
    if k == 1:
        step = ps.train_step()
        for i, b in enumerate(batches):
            p, st, _ = step(p, st, ps.shard_batch(
                {n: jnp.asarray(v) for n, v in b.items()}), js.step_rng(i))
    else:
        fused = ps.train_step_many(k)
        sh = ps.chunk_input_shardings()
        for i in range(0, steps, k):
            p, st, _ = fused(p, st, {n: jax.device_put(jnp.asarray(np.stack(
                [b[n] for b in batches[i:i + k]])), sh[n])
                for n in batches[0]})
    return ({ln: {bn: np.asarray(jax.device_get(a)) for bn, a in bl.items()}
             for ln, bl in p.items()}, js)


def _equal(a, b):
    return all(np.array_equal(a[ln][bn], b[ln][bn])
               for ln in b for bn in b[ln])


def _close(got, want, tol):
    for ln, bl in want.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(got[ln][bn], w, err_msg=f"{ln}/{bn}",
                                       **tol)


# -- the plan ----------------------------------------------------------------
def _plan_nets(which):
    """(port net, JAX net, port skip, JAX skip) of a plan case."""
    if which == "tiny":
        text = NET
    elif which == "caffenet":
        text = zoo.caffenet(batch_size=256).to_text()
    elif which == "resnet":
        text = _resnet_text(zoo)
    else:
        text = zoo.transformer_lm(**LM).to_text()
    net = Net(NetParameter.from_text(text), device="meta")
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=JaxPhase.TRAIN))
    if which != "lm_tp":
        return net, jnet, None, None
    layout = MeshLayout(net, build_mesh(dp=2, tp=2, devices=[CPU] * 4))
    jlayout = JaxMeshLayout(jnet, jax_build_mesh(
        dp=2, tp=2, devices=jax.devices()[:4]))

    def sharded(specs):
        return frozenset((ln, bn) for ln, bl in specs.items()
                         for bn, spec in bl.items()
                         if any(ax is not None for ax in spec))
    skip, jskip = sharded(layout.param_specs), sharded(jlayout.param_specs)
    assert skip and skip == jskip
    return net, jnet, (layout.mesh, skip), (jlayout.mesh, jskip)


@pytest.mark.parametrize("bucket_mb", [0.5, 25.0])
@pytest.mark.parametrize("which", ["tiny", "caffenet", "lm", "resnet",
                                   "lm_tp"])
def test_plan_equals_jax_field_for_field(which, bucket_mb):
    net, jnet, bind, jbind = _plan_nets(which)
    grid = [(ls, hb) for ls in (1, 2, 4) for hb in (None, 0, 1 << 20,
                                                     10 ** 9)]
    for mode in gradsync.MODES:
        for wire in (None, "bfloat16", "int8"):
            gs = gradsync.make_gradsync(net, mode=mode, bucket_mb=bucket_mb,
                                        wire_dtype=wire, overlap=True)
            jg = jax_gs.make_gradsync(jnet, mode=mode, bucket_mb=bucket_mb,
                                      wire_dtype=wire, overlap=True)
            if bind is not None:
                gs.bind_mesh(bind[0], skip_blobs=bind[1])
                jg.bind_mesh(jbind[0], skip_blobs=jbind[1])
            got, want = gs.plan, jg.plan
            what = (which, bucket_mb, mode, wire)
            assert gs.mode == jg.mode and gs.needs_rng == jg.needs_rng, what
            assert tuple(got) == tuple(want), what
            assert got.comm_info() == want.comm_info(), what
            assert got.n_messages == want.n_messages, what
            for ls, hb in grid:
                assert got.exposed_wire_bytes(ls, hb) == \
                    want.exposed_wire_bytes(ls, hb), (what, ls, hb)
                assert got.tier_wire_bytes(ls, hb) == \
                    want.tier_wire_bytes(ls, hb), (what, ls, hb)
    full = gradsync.build_plan(net, "bucket", bucket_mb=bucket_mb)
    if which == "caffenet":       # 60,965,224 params, 243.9 MB in f32
        assert full.total_bytes_wire == 243_860_896
    if which == "resnet":
        assert full.skipped and all(
            ln in net.stat_param_layers() for ln, _ in full.skipped)


# -- default: inert ----------------------------------------------------------
@pytest.mark.parametrize("case", ["dp1", "dp4_zero_k4"])
def test_default_byte_identical_to_unset(case, monkeypatch):
    dp, zero, k = (1, None, 1) if case == "dp1" else (4, True, 4)
    # neither path of the exchange may run: the step is the one before it
    monkeypatch.setattr(gradsync.GradSync, "exchange", None)
    monkeypatch.setattr(gradsync.GradSync, "attach", None)
    runs = []
    for mode in (None, "default"):
        _knobs(monkeypatch, mode)
        runs.append(_port_run(20, dp=dp, zero=zero, k=k))
    (p0, s0, _, step), (p1, s1, _, _) = runs
    assert not step.grad_sync.enabled
    assert _equal(p0, p1)
    assert all(np.array_equal(s0[k_], s1[k_]) for k_ in s0)
    if zero:
        assert isinstance(step.shard_opt_state(
            step.solver.init()[1]).history["fc_big"]["weight"], comm.Shards)


# -- bucket / hier: the same sums ---------------------------------------------
@pytest.mark.parametrize("overlap", ["1", "0"], ids=["hooks", "no_hooks"])
@pytest.mark.parametrize("dp", [1, 4, 8])
def test_bucket_hier_byte_equal_default(dp, overlap, monkeypatch):
    _knobs(monkeypatch, "default")
    ref, ref_state, _, _ = _port_run(3, dp=dp)
    for mode in ("bucket", "hier"):
        _knobs(monkeypatch, mode, overlap=overlap)
        got, state, _, step = _port_run(3, dp=dp)
        gs = step.grad_sync
        assert gs.mode == mode
        assert gs.use_hooks(1) == (overlap == "1")
        assert any(b.numel % 8 for b in gs.plan.buckets)   # hier's padding
        assert len(gs.plan.buckets) > 1
        assert _equal(got, ref), (mode, dp, overlap)
        assert all(np.array_equal(state[k], ref_state[k]) for k in state)


# -- against JAX --------------------------------------------------------------
@pytest.mark.parametrize("dp", [1, 2, 8])
@pytest.mark.parametrize("mode", ["bucket", "hier", "quant"])
def test_mode_matches_jax(mode, dp, monkeypatch):
    _knobs(monkeypatch, mode)
    got, _, arrays, step = _port_run(10, dp=dp)
    want, js = _jax_run(arrays, 10, dp)
    assert step.grad_sync.plan == js.grad_sync.plan
    _close(got, want, TOL[mode])
    if mode == "quant":
        _knobs(monkeypatch, "default")
        ref, _, _, _ = _port_run(10, dp=dp)
        assert not _equal(got, ref)          # the bf16 wire rounded


def _jax_first_grads(arrays, dp, mode, wire):
    """JAX's first exchanged gradient (the exchange on the finished
    gradient, with its rng), jitted on a dp mesh of virtual devices."""
    js = _jax_solver()
    net = js.train_net
    gs = jax_gs.make_gradsync(net, mode=mode, bucket_mb=0.5,
                              wire_dtype=wire, overlap=False)
    mesh = jax_build_mesh(devices=jax.devices()[:dp], dp=dp)
    gs.bind_mesh(mesh)
    rng = js.step_rng(0)

    def f(p, b):
        g = jax.grad(lambda q: net.loss(q, b, train=True, rng=rng)[0])(p)
        return gs.exchange(g, rng)
    rep = NamedSharding(mesh, P())
    fn = jax.jit(f, in_shardings=(rep, NamedSharding(mesh, P("dp"))),
                 out_shardings=rep)
    out = fn(_jax_params(arrays), {n: jnp.asarray(v)
                                   for n, v in _batch(3).items()})
    return {ln: {bn: np.asarray(a) for bn, a in bl.items()}
            for ln, bl in out.items()}, gs.plan


@pytest.mark.parametrize("dp", [1, 2, 8])
def test_int8_first_step_within_one_quantum_of_jax(dp, monkeypatch):
    _knobs(monkeypatch, "quant", wire="int8")
    step, p, _, arrays = _port(dp=dp)
    gs = step.grad_sync
    assert gs.needs_rng and not gs.use_hooks(1)
    _, _, g = step.loss_and_grads(p, _torch(_batch(3)))
    want, plan = _jax_first_grads(arrays, dp, "quant", "int8")
    assert plan == gs.plan
    _knobs(monkeypatch, "default")
    s0, p0, _, _ = _port(dp=dp)
    _, _, exact = s0.loss_and_grads(p0, _torch(_batch(3)))
    for bucket in gs.plan.buckets:
        scale = max(float(exact[ln][bn].abs().max())
                    for ln, bn in bucket.entries) / 127.0
        for ln, bn in bucket.entries:
            got = g[ln][bn].numpy()
            # each side rounds to one of the two neighbouring quanta
            assert np.abs(got - want[ln][bn]).max() <= scale * (1 + 1e-4)
            assert np.abs(got - exact[ln][bn].numpy()).max() <= \
                scale * (1 + 1e-4)
            q = got / scale
            assert np.abs(q - np.round(q)).max() < 1e-2   # on the grid


@pytest.mark.parametrize("dp", [1, 2])
def test_iter_size_exchanges_the_accumulated_gradient(dp, monkeypatch):
    text = SOLVER + "iter_size: 2\n"
    _knobs(monkeypatch, "default")
    ref, _, arrays, _ = _port_run(4, dp=dp, solver_text=text)
    _knobs(monkeypatch, "bucket")
    got, _, _, step = _port_run(4, dp=dp, solver_text=text)
    assert not step.grad_sync.use_hooks(2)
    if dp == 1:
        assert _equal(got, ref)
    else:       # each rank sums its sub-batches, then one exchange
        _close(got, ref, EXACT)
    want, _ = _jax_run(arrays, 4, dp, solver_text=text)
    _close(got, want, EXACT)


@pytest.mark.parametrize("mode", ["bucket", "hier", "quant"])
def test_modes_with_zero1_fused_chunks_match_jax(mode, monkeypatch):
    _knobs(monkeypatch, mode)
    got, _, arrays, step = _port_run(12, dp=8, zero=True, k=4)
    assert step.zero_on
    want, _ = _jax_run(arrays, 12, 8, zero=True, k=4)
    _close(got, want, TOL[mode])


# -- quantize_int8 ------------------------------------------------------------
def test_quantize_int8_matches_jax_and_is_unbiased():
    x = np.linspace(-0.011, 0.013, 257).astype(np.float32)
    for arr in (x, np.random.RandomState(0).randn(1000).astype(np.float32),
                np.zeros(5, np.float32)):
        q, scale = gradsync.quantize_int8(torch.from_numpy(arr))
        jq, jscale = jax_gs.quantize_int8(jnp.asarray(arr), None)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
    q, scale = gradsync.quantize_int8(torch.from_numpy(x))
    deq = gradsync.dequantize_int8(q, scale, torch.float32).numpy()
    assert np.abs(deq - x).max() <= float(scale) / 2 + 1e-9
    g = torch.Generator().manual_seed(0)
    draws = np.stack([gradsync.dequantize_int8(
        *gradsync.quantize_int8(torch.from_numpy(x), g),
        torch.float32).numpy() for _ in range(512)])
    assert np.abs(draws - x).max() <= float(scale) * (1 + 1e-6)
    assert np.abs(draws.mean(0) - x).max() < float(scale) / 6


def test_int8_rounding_stream_is_not_dropouts(monkeypatch):
    """The solver seeds Dropout and the rounding stream from the same
    random_seed + rank: their first draws must still differ, or the
    rounding noise would follow the dropout mask."""
    _knobs(monkeypatch, "quant", wire="int8")
    draws = []
    for rank in (0, 1):
        s = Solver(SolverParameter.from_text(SOLVER),
                   NetParameter.from_text(NET), rank=rank, device="cpu")
        assert s.grad_sync.needs_rng
        drop = torch.rand(4096, generator=s.generator)
        rnd = torch.rand(4096, generator=s.grad_sync.generator)
        assert not torch.equal(drop, rnd)
        assert abs(np.corrcoef(drop.numpy(), rnd.numpy())[0, 1]) < 0.1
        draws += [drop, rnd]
    assert not any(torch.equal(a, b) for i, a in enumerate(draws)
                   for b in draws[i + 1:])


def test_reduce_scatter_pads_and_sums_in_rank_order():
    mesh = build_mesh(dp=4, devices=[CPU] * 4)
    rng = np.random.RandomState(1)
    ts = [torch.from_numpy(rng.randn(1001).astype(np.float32))
          for _ in range(4)]
    blocks = comm.reduce_scatter(ts, mesh, "dp")
    assert [b.numel() for b in blocks] == [251] * 4          # 1004 / 4
    whole = comm.all_gather(blocks, 0)
    assert torch.equal(whole[:1001], comm.all_reduce(ts, mesh, "dp")[0])
    assert torch.equal(whole[1001:], torch.zeros(3))
    with pytest.raises(ValueError, match="3 tensors for 4 ranks"):
        comm.reduce_scatter(ts[:3], mesh, "dp")


# -- auto, gating, the CLIs ---------------------------------------------------
def test_auto_and_hook_gating_match_jax(monkeypatch):
    for env, iters in ((dict(mode="auto"), (1,)),
                       (dict(mode="bucket"), (1, 2)),
                       (dict(mode="quant"), (1,)),
                       (dict(mode="quant", wire="int8"), (1,)),
                       (dict(mode="bucket", overlap="0"), (1,)),
                       (dict(mode="default"), (1,))):
        _knobs(monkeypatch, **env)
        s = Solver(SolverParameter.from_text(SOLVER),
                   NetParameter.from_text(NET), device="cpu")
        js = _jax_solver()
        gs, jg = s.grad_sync, js.grad_sync
        assert (gs.mode, gs.enabled, gs.needs_rng) == \
            (jg.mode, jg.enabled, jg.needs_rng), env
        for it in iters:
            assert gs.use_hooks(it) == jg.use_hooks(it), (env, it)
        if env["mode"] == "auto":
            assert gs.mode == "default"
            for dp, want in ((1, "default"), (2, "bucket"), (8, "bucket")):
                ParallelSolver(s, build_mesh(dp=dp, devices=[CPU] * dp))
                JaxParallelSolver(js, jax_build_mesh(
                    devices=jax.devices()[:dp], dp=dp))
                assert gs.mode == jg.mode == want
                assert gs.plan.mode == jg.plan.mode == want


@pytest.mark.parametrize("cli", ["caffe_on_spark", "mini_cluster"])
def test_cli_comm_block_and_bucket_equal_default(cli, tmp_path,
                                                 monkeypatch):
    """Both CLIs under -mesh 2: the metrics JSON's `comm` block is the
    JAX plan's comm_info for the same net, and the final model under
    bucket is byte-equal to default's."""
    solver = write_config(tmp_path, max_iter=4, test_interval=0,
                          test_iter=0)
    init = init_model(tmp_path, solver)
    models, infos = {}, {}
    for mode in ("default", "bucket", "quant"):
        _knobs(monkeypatch, mode, bucket_mb="0.01")
        out = tmp_path / mode
        metrics = str(tmp_path / f"{mode}.json")
        if cli == "caffe_on_spark":
            monkeypatch.setenv("COS_PIPELINE_METRICS", metrics)
            assert caffe_on_spark.main(["-conf", solver, "-train",
                                        "-weights", init, "-output",
                                        str(out), "-device", "cpu", "-mesh",
                                        "2"]) == 0
            monkeypatch.delenv("COS_PIPELINE_METRICS")
            model = out / "model.caffemodel"
        else:
            model = tmp_path / f"{mode}.caffemodel"
            assert mini_cluster.main(["-solver", solver, "-weights", init,
                                      "-mesh", "2", "-output", str(out),
                                      "-model", str(model),
                                      "-pipeline_metrics", metrics,
                                      "-device", "cpu"]) == 0
        with open(metrics) as f:
            infos[mode] = json.load(f)["info"]["comm"]
        models[mode] = model.read_bytes()
    conf = Config(["-conf", solver, "-device", "cpu"])
    jnet = JaxNet(JaxNetParameter.from_text(conf.netParam.to_text()),
                  JaxNetState(phase=JaxPhase.TRAIN))
    for mode, info in infos.items():
        assert info == jax_gs.build_plan(jnet, mode,
                                         bucket_mb=0.01).comm_info(), mode
    assert infos["bucket"]["buckets"] > 1
    assert infos["quant"]["wire_dtype"] == "bfloat16"
    assert models["bucket"] == models["default"]
    assert models["quant"] != models["default"]


@pytest.mark.parametrize("knob", KNOBS)
def test_grad_sync_knob_acted_on(knob, monkeypatch):
    """Each knob changes the plan or the gradient (the port refused all
    four by name before it had the exchange)."""
    def first(**env):
        _knobs(monkeypatch, **env)
        step, p, _, _ = _port(dp=2)
        calls = []
        real = gradsync._BucketHook.backward
        monkeypatch.setattr(gradsync._BucketHook, "backward", staticmethod(
            lambda ctx, *cts: calls.append(1) or real(ctx, *cts)))
        _, _, g = step.loss_and_grads(p, _torch(_batch(3)))
        monkeypatch.setattr(gradsync._BucketHook, "backward",
                            staticmethod(real))
        return step.grad_sync, g, len(calls)

    def same(a, b):
        return all(torch.equal(a[ln][bn], b[ln][bn]) for ln in a
                   for bn in a[ln])
    if knob == "COS_GRAD_SYNC":
        gs0, g0, _ = first(mode=None)
        gs1, g1, _ = first(mode="quant")
        assert (gs0.plan.mode, gs1.plan.mode) == ("default", "quant")
        assert not same(g0, g1)
    elif knob == "COS_GRAD_BUCKET_MB":
        gs0, _, n0 = first(mode="bucket", bucket_mb=None)
        gs1, _, n1 = first(mode="bucket", bucket_mb="0.5")
        assert (gs0.plan.bucket_mb, gs0.plan.n_buckets, n0) == (25.0, 1, 1)
        assert gs1.plan.n_buckets == n1 == 3
    elif knob == "COS_GRAD_OVERLAP":
        _, g0, n0 = first(mode="bucket")
        _, g1, n1 = first(mode="bucket", overlap="0")
        assert (n0, n1) == (3, 0) and same(g0, g1)
    else:
        gs0, g0, _ = first(mode="quant")
        gs1, g1, _ = first(mode="quant", wire="int8")
        assert (gs0.plan.wire_dtype, gs1.plan.wire_dtype) == ("bfloat16",
                                                              "int8")
        assert gs1.plan.total_bytes_wire == \
            gs1.plan.total_numel + 4 * gs1.plan.n_buckets
        assert not same(g0, g1)


@pytest.mark.parametrize("knob,value", [("COS_GRAD_SYNC", "ring"),
                                        ("COS_GRAD_WIRE_DTYPE", "fp8"),
                                        ("COS_GRAD_BUCKET_MB", "big")])
def test_invalid_knob_values_refused(knob, value, tmp_path, monkeypatch):
    solver = write_config(tmp_path, max_iter=2)
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match=knob if knob != "COS_GRAD_BUCKET_MB"
                       else "could not convert"):
        Config(["-conf", solver, "-train", "-device", "cpu"]).validate()
    with pytest.raises(ValueError):
        caffe_on_spark.main(["-conf", solver, "-train", "-device", "cpu",
                             "-output", str(tmp_path / "o")])
    with pytest.raises(ValueError):
        mini_cluster.main(["-solver", solver, "-device", "cpu", "-output",
                           str(tmp_path / "m")])
    assert not os.path.exists(tmp_path / "o")
    assert not os.path.exists(tmp_path / "m")
    assert "COS_SYNC_MODE" in config.LATER_KNOBS
    assert not set(KNOBS) & set(config.LATER_KNOBS)


# -- once a step, and planted faults ------------------------------------------
@pytest.mark.parametrize("iter_size,overlap", [(1, "1"), (1, "0"), (2, "1")])
def test_one_exchange_a_step(iter_size, overlap, monkeypatch):
    _knobs(monkeypatch, "hier", overlap=overlap)
    text = SOLVER + f"iter_size: {iter_size}\n"
    step, p, st, _ = _port(text, dp=4)
    calls = []
    real = gradsync.GradSync._transform_flat
    monkeypatch.setattr(gradsync.GradSync, "_transform_flat",
                        lambda self, flats, gen: calls.append(len(flats))
                        or real(self, flats, gen))
    for i in range(2):
        step.train_step(p, st, _torch(_batch(3 + i)))
    n = step.grad_sync.plan.n_buckets
    assert calls == [4] * (2 * n)        # every bucket once a step, 4 ranks


def _double_sum(monkeypatch):
    """The fault the dp step must not have: the hooks' reduced gradient
    summed over the ranks again by the per-blob path."""
    monkeypatch.setattr(gradsync.GradSync, "bucketed",
                        lambda self: frozenset())


def _rank0_only(monkeypatch):
    monkeypatch.setattr(gradsync.comm, "all_reduce",
                        lambda ts, mesh, axis: [ts[0]] * len(ts))


@pytest.mark.parametrize("plant", [_double_sum, _rank0_only],
                         ids=["double_sum", "rank0_only"])
def test_planted_exchange_fault_rejected(plant, monkeypatch):
    _knobs(monkeypatch, "default")
    ref, _, arrays, _ = _port_run(3, dp=4)
    want, _ = _jax_run(arrays, 3, 4)
    _knobs(monkeypatch, "bucket")
    got, _, _, _ = _port_run(3, dp=4)
    assert _equal(got, ref)
    _close(got, want, EXACT)
    plant(monkeypatch)
    bad, _, _, _ = _port_run(3, dp=4)
    assert not _equal(bad, ref)
    with pytest.raises(AssertionError):
        _close(bad, want, EXACT)
