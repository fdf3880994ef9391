"""Data and tensor parallelism of the PyTorch port (`parallel/dp.py`,
`parallel/mesh.py`, `Net.forward_ranks`) against the JAX package's
`ParallelSolver` on its 8 virtual CPU devices (tests/conftest.py).

The port's ranks all sit on the CPU; the JAX package's are virtual
devices.  Parameters move as numpy, from the port's fillers; the batch
is numpy with a seed.  Each comparison holds the JAX package's own
tolerances of tests/test_parallel.py (loss rel 2e-4, weights rtol 2e-3
/ atol 2e-5):
  * dp 2, 4 and 8 on test_parallel.py's tiny net, and the port's dp N
    against its own dp 1 on the same global batch;
  * `tp_param_specs`, `zero_state_specs` and `MeshLayout.describe`
    equal to JAX's, axis names per blob;
  * ZeRO-1 trajectories and each rank's state bytes, and ZeRO-1 with a
    bf16 state;
  * dp 2 × tp 4;
  * a BatchNorm net at dp 2 with its running statistics, and with
    Dropout the port's dp 2 against its dp 1 (one global mask);
  * the transformer LM at dp 2 × tp 2 through the flash route (the JAX
    side's Pallas kernels in interpret mode) and at dp 2 × sp 2 through
    the ring, with the kernels' calls counted per (B/dp, H/tp) block and
    per dp row (the wrappers replaced by counting ones, as
    test_torch_ring.py's launch pattern does);
  * the refusals: a batch dp does not divide (by layer), a layer that
    reduces over the batch, ep and pp.
The JAX side is jitted; the shapes are small.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.parallel import ParallelSolver as JaxParallelSolver
from caffeonspark_tpu.parallel import build_mesh as jax_build_mesh
from caffeonspark_tpu.parallel import tp_param_specs as jax_tp_param_specs
from caffeonspark_tpu.parallel.dp import \
    zero_state_specs as jax_zero_state_specs
from caffeonspark_tpu.parallel.mesh import MeshLayout as JaxMeshLayout
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.ops import kernels as K
from caffeonspark_tpu_torch.parallel import (MeshLayout, ParallelSolver,
                                             build_mesh, tp_param_specs,
                                             zero_state_specs)
from caffeonspark_tpu_torch.parallel.comm import Shards, all_gather, \
    all_reduce
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

CPU = torch.device("cpu")
LOSS_REL = 2e-4
W_RTOL, W_ATOL = 2e-3, 2e-5

# tests/test_parallel.py's tiny net at a global batch of 32
NET = """
name: "tiny"
layer {
  name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 32 channels: 1 height: 28 width: 28 }
}
layer {
  name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "xavier" } }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer {
  name: "fc_big" type: "InnerProduct" bottom: "conv1" top: "fc_big"
  inner_product_param { num_output: 2048 weight_filler { type: "xavier" } }
}
layer { name: "relu2" type: "ReLU" bottom: "fc_big" top: "fc_big" }
layer {
  name: "ip2" type: "InnerProduct" bottom: "fc_big" top: "ip2"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } }
}
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss" }
"""

SOLVER = ('base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n'
          'max_iter: 20\nrandom_seed: 11\n')
ADAM = ("base_lr: 0.01 momentum: 0.9 lr_policy: 'fixed' type: 'ADAM' "
        "random_seed: 5")


def _image_batch(n=32, seed=3):
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(n, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, n).astype(np.float32)}


def _port(net_text, solver_text, mesh_kw=None, zero=None, seed=5):
    """The port's stepper (a Solver, or a ParallelSolver over CPU ranks),
    params and state, and the params as numpy."""
    s = Solver(SolverParameter.from_text(solver_text),
               NetParameter.from_text(net_text), device="cpu")
    params = s.train_net.init(seed)
    arrays = convert.params_to_numpy(params)
    st = s.init_state(params)
    n = int(np.prod(list((mesh_kw or {}).values()) or [1]))
    if n == 1:
        return s, params, st, arrays
    ps = ParallelSolver(s, build_mesh(devices=[CPU] * n, **mesh_kw),
                        zero_dp=zero)
    return ps, ps.shard_params(params), ps.shard_opt_state(st), arrays


def _port_run(net_text, solver_text, batches, mesh_kw=None, zero=None):
    step, p, st, arrays = _port(net_text, solver_text, mesh_kw, zero)
    losses = [float(step.train_step(p, st, {k: torch.from_numpy(v)
                                            for k, v in b.items()})[0])
              for b in batches]
    return losses, convert.params_to_numpy(p), step, st, arrays


def _jax_run(net_text, solver_text, arrays, batches, mesh_kw, zero=None):
    """The JAX ParallelSolver's steps (jitted) from the same params."""
    js = JaxSolver(JaxSolverParameter.from_text(solver_text),
                   JaxNetParameter.from_text(net_text))
    n = int(np.prod(list(mesh_kw.values())))
    ps = JaxParallelSolver(js, jax_build_mesh(devices=jax.devices()[:n],
                                              **mesh_kw), zero_dp=zero)
    jp = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
          for ln, bl in arrays.items()}
    st = ps.shard_opt_state(js.init_state(jp))
    p = ps.shard_params(jp)
    step = ps.train_step()
    losses = []
    for i, b in enumerate(batches):
        p, st, out = step(p, st, ps.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}), js.step_rng(i))
        losses.append(float(out["loss"]))
    return losses, {ln: {bn: np.asarray(jax.device_get(a))
                         for bn, a in bl.items()} for ln, bl in p.items()}


def _weights_close(got, want, rtol=W_RTOL, atol=W_ATOL):
    for ln, bl in want.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(got[ln][bn], w, rtol=rtol, atol=atol,
                                       err_msg=f"{ln}/{bn}")


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_dp_matches_jax_and_dp1(dp):
    """dp N of the port against the JAX package's dp N, and against the
    port's own dp 1 on the same global batch of 32, over 3 steps."""
    batches = [_image_batch(seed=3 + i) for i in range(3)]
    got, gp, _, _, arrays = _port_run(NET, SOLVER, batches, {"dp": dp})
    want, wp = _jax_run(NET, SOLVER, arrays, batches, {"dp": dp})
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _weights_close(gp, wp)
    one, p1, _, _, _ = _port_run(NET, SOLVER, batches)
    np.testing.assert_allclose(got, one, rtol=1e-5)
    _weights_close(gp, p1, rtol=1e-5, atol=1e-7)


def _lstm_text():
    return zoo.lstm_lm(vocab=40, d_model=256, seq=4, batch_size=2).to_text()


@pytest.mark.parametrize("which", ["tiny", "lm", "lstm"])
def test_specs_equal_jax(which):
    """tp_param_specs, zero_state_specs at dp 2, 4 and 8, and the
    layout's description, blob by blob equal to the JAX package's (its
    PartitionSpecs as tuples): an InnerProduct of 2048 outputs, an LM
    whose logits and table are 2048 wide, an LSTM whose gates are 1024
    wide."""
    text = {"tiny": NET,
            "lm": zoo.transformer_lm(vocab=2048, d_model=2048, heads=2,
                                     layers=1, seq=8, batch=8).to_text(),
            "lstm": _lstm_text()}[which]
    net = Net(NetParameter.from_text(text), device="meta")
    jnet = JaxNet(JaxNetParameter.from_text(text))
    got = tp_param_specs(net)
    want = jax_tp_param_specs(jnet)
    assert got == {ln: {bn: tuple(p) for bn, p in bl.items()}
                   for ln, bl in want.items()}
    assert any(spec for bl in got.values() for spec in bl.values())
    shapes = {ln: {bn: shp for bn, shp, _ in specs}
              for ln, specs in net.param_layout.items()}
    for dp in (2, 4, 8):
        z = zero_state_specs(got, shapes, dp)
        zj = jax_zero_state_specs(want, shapes, dp)
        assert z == {ln: {bn: tuple(p) for bn, p in bl.items()}
                     for ln, bl in zj.items()}, dp
    mesh = build_mesh(dp=2, tp=4, devices=[CPU] * 8)
    assert MeshLayout(net, mesh).describe() == JaxMeshLayout(
        jnet, jax_build_mesh(dp=2, tp=4)).describe()


def test_zero1_matches_jax_and_splits_the_state():
    """ZeRO-1 at dp 4: the momentum of fc_big (2048, 1152) and ip2's
    weight split into 4 tensors, one per rank, ip2's bias whole (below
    16384 elements); the trajectory against the JAX package's ZeRO-1
    and the port's plain dp 4; each rank holds a quarter of the split
    blobs' bytes."""
    batches = [_image_batch(seed=7 + i) for i in range(3)]
    got, gp, ps, st, arrays = _port_run(NET, SOLVER, batches, {"dp": 4},
                                        zero=True)
    assert ps.zero_on
    h = st.history["fc_big"]["weight"]
    assert isinstance(h, Shards) and h.dim == 0 and len(h) == 4
    assert [tuple(x.shape) for x in h] == [(512, 1152)] * 4
    assert not isinstance(st.history["ip2"]["bias"], Shards)
    assert ps.state_specs["fc_big"]["weight"] == ("dp", None)
    assert ps.param_specs["fc_big"]["weight"] == ()
    want, wp = _jax_run(NET, SOLVER, arrays, batches, {"dp": 4}, zero=True)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _weights_close(gp, wp)
    plain, pp, _, _, _ = _port_run(NET, SOLVER, batches, {"dp": 4})
    np.testing.assert_allclose(got, plain, rtol=1e-6)
    _weights_close(gp, pp, rtol=1e-6, atol=1e-8)
    per_rank = ps.state_bytes(st)
    whole = sum(t.numel() * 4 for bl in arrays.values() for t in
                (torch.from_numpy(a) for a in bl.values())) * 2
    assert len(set(per_rank)) == 1
    split = 2 * 4 * sum(int(np.prod(a.shape)) for ln, bl in arrays.items()
                        for bn, a in bl.items()
                        if "dp" in ps.state_specs[ln][bn])
    assert per_rank[0] == whole - split + split // 4


def test_zero1_composes_with_bf16_state(monkeypatch):
    """COS_STATE_DTYPE=bfloat16 and COS_ZERO=1 together: the momentum is
    bf16 and split over dp, one step runs finite and stays close to the
    f32 state's step."""
    monkeypatch.setenv("COS_STATE_DTYPE", "bfloat16")
    monkeypatch.setenv("COS_ZERO", "1")
    batch = [_image_batch(seed=2)]
    losses, gp, ps, st, _ = _port_run(NET, SOLVER, batch + batch,
                                      {"dp": 8})
    assert ps.zero_on
    m = st.history["fc_big"]["weight"]
    assert isinstance(m, Shards) and len(m) == 8
    assert all(x.dtype == torch.bfloat16 for x in m)
    assert np.isfinite(losses).all()
    monkeypatch.delenv("COS_STATE_DTYPE")
    ref, rp, _, _, _ = _port_run(NET, SOLVER, batch + batch, {"dp": 8})
    np.testing.assert_allclose(losses, ref, rtol=1e-3)


def test_dp2_tp4_matches_jax():
    """dp 2 × tp 4: fc_big's weight (2048, 1152) and bias split into 4
    column blocks on every dp rank; losses and weights against the JAX
    package's dp 2 × tp 4."""
    batches = [_image_batch(seed=11 + i) for i in range(2)]
    got, gp, ps, _, arrays = _port_run(NET, SOLVER, batches,
                                       {"dp": 2, "tp": 4})
    assert ps.param_specs["fc_big"]["weight"] == ("tp", None)
    assert ps.param_specs["conv1"]["weight"] == ()
    want, wp = _jax_run(NET, SOLVER, arrays, batches, {"dp": 2, "tp": 4})
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _weights_close(gp, wp)


BN_NET = """
name: "bn"
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 3 height: 12 width: 12 } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3
    weight_filler { type: "xavier" } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" }
layer { name: "scale1" type: "Scale" bottom: "conv1" top: "conv1"
  scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "fc1" type: "InnerProduct" bottom: "conv1" top: "fc1"
  inner_product_param { num_output: 16 weight_filler { type: "xavier" } } }
{dropout}
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2" bottom: "label"
  top: "loss" loss_param { ignore_label: 4 } }
"""
DROPOUT = ('layer { name: "drop1" type: "Dropout" bottom: "fc1" '
           'top: "fc1" dropout_param { dropout_ratio: 0.5 } }')


def _bn_batches(n, seed=4):
    rng = np.random.RandomState(seed)
    return [{"data": (rng.rand(8, 3, 12, 12) * 2 - 0.5).astype(np.float32),
             "label": rng.randint(0, 5, 8).astype(np.float32)}
            for _ in range(n)]


def test_batchnorm_net_dp2_matches_jax():
    """BatchNorm at dp 2 normalises by the whole batch's statistics (not
    each rank's): losses, weights and the running statistics against the
    JAX package's dp 2, with SoftmaxWithLoss's ignore_label counted over
    both ranks."""
    text = BN_NET.replace("{dropout}", "")
    batches = _bn_batches(3)
    got, gp, _, _, arrays = _port_run(text, SOLVER, batches, {"dp": 2})
    want, wp = _jax_run(text, SOLVER, arrays, batches, {"dp": 2})
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _weights_close(gp, wp)
    assert float(np.abs(gp["bn1"]["variance"]).max()) > 0
    one, p1, _, _, _ = _port_run(text, SOLVER, batches)
    np.testing.assert_allclose(got, one, rtol=1e-5)
    _weights_close(gp, p1, rtol=1e-5, atol=1e-7)


def test_batchnorm_dropout_net_dp2_draws_dp1_mask():
    """With Dropout the port's dp 2 draws the global mask once and slices
    it: its first step's reduced gradients equal dp 1's up to the order
    of the sums, and three steps stay on dp 1's trajectory."""
    text = BN_NET.replace("{dropout}", DROPOUT)
    batches = _bn_batches(3, seed=8)
    s1, p1, st1, _ = _port(text, SOLVER)
    ps, p2, st2, _ = _port(text, SOLVER, {"dp": 2})
    inputs = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    l1, _, g1 = s1.loss_and_grads(p1, inputs)
    l2, _, g2 = ps.loss_and_grads(p2, inputs)
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    # of the largest gradient: conv1's bias, ahead of BatchNorm, has
    # gradients of rounding noise only
    scale = max(float(g.abs().max()) for bl in g1.values()
                for g in bl.values())
    for ln, bl in g1.items():
        for bn, g in bl.items():
            assert float((g2[ln][bn] - g).abs().max()) <= 1e-5 * scale, \
                (ln, bn)
    got = [float(ps.train_step(p2, st2, {k: torch.from_numpy(v)
                                         for k, v in b.items()})[0])
           for b in batches]
    want = [float(s1.train_step(p1, st1, {k: torch.from_numpy(v)
                                          for k, v in b.items()})[0])
            for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for bn in ("mean", "variance", "count"):
        np.testing.assert_allclose(p2["bn1"][bn].numpy(),
                                   p1["bn1"][bn].numpy(), rtol=1e-5,
                                   atol=1e-7)


LM = dict(vocab=12, d_model=32, heads=2, layers=1, seq=128, batch=4)


def _lm_batches(n):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        seqs = rng.randint(0, 10, (LM["seq"], LM["batch"])).astype(
            np.float32)
        out.append({"input_sentence": seqs,
                    "target_sentence": (seqs + 1) % 10})
    return out


def _counting(monkeypatch, names):
    """Replace the kernel wrappers `names` of ops.kernels by ones that
    record their first operand's shape (the shape inference's calls on
    meta tensors aside)."""
    calls = {n: [] for n in names}
    for n in names:
        real = getattr(K, n)

        def spy(*a, _real=real, _n=n, **kw):
            if a[0].device.type != "meta":
                calls[_n].append(tuple(a[0].shape))
            return _real(*a, **kw)
        monkeypatch.setattr(K, n, spy)
    return calls


def test_lm_dp2_tp2_flash_matches_jax(monkeypatch):
    """The LM at dp 2 × tp 2: K6, K7 and K8 run once per (B/dp, H/tp)
    block, 4 times a layer a step at (B/2 · H/2, T, D); losses and the
    logits' weights against the JAX package's dp 2 × tp 2 with its
    Pallas kernels in interpret mode (shard_map over batch and heads)."""
    text = zoo.transformer_lm(**LM).to_text()
    batches = _lm_batches(2)
    calls = _counting(monkeypatch, ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv"))
    got, gp, _, _, arrays = _port_run(text, ADAM, batches,
                                      {"dp": 2, "tp": 2})
    hd = LM["d_model"] // LM["heads"]
    block = (LM["batch"] // 2 * LM["heads"] // 2, LM["seq"], hd)
    for n, c in calls.items():
        assert c == [block] * (4 * LM["layers"] * len(batches)), n
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    want, wp = _jax_run(text, ADAM, arrays, batches, {"dp": 2, "tp": 2})
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    np.testing.assert_allclose(gp["logits"]["weight"],
                               wp["logits"]["weight"], rtol=W_RTOL,
                               atol=W_ATOL)


def test_lm_dp2_sp2_ring_matches_jax(monkeypatch):
    """The LM at dp 2 × sp 2: the ring runs once per dp row, so K9 folds
    3 causal hops a row (6 a layer a step) at (B/2 · H, T/2, D), and K7/K8
    run 3 pairs a row; losses and weights against the JAX package's
    dp 2 × sp 2 and the port's dp 1."""
    text = zoo.transformer_lm(**LM).to_text()
    batches = _lm_batches(2)
    calls = _counting(monkeypatch, ("flash_block_update",
                                    "flash_bwd_block"))
    got, gp, _, _, arrays = _port_run(text, ADAM, batches,
                                      {"dp": 2, "sp": 2})
    hd = LM["d_model"] // LM["heads"]
    assert calls["flash_block_update"] == [
        (LM["batch"] // 2 * LM["heads"], LM["seq"] // 2, hd)] * (
        6 * LM["layers"] * len(batches))
    assert len(calls["flash_bwd_block"]) == 6 * len(batches)
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    want, wp = _jax_run(text, ADAM, arrays, batches, {"dp": 2, "sp": 2})
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _weights_close(gp, wp)
    one, p1, _, _, _ = _port_run(text, ADAM, batches)
    np.testing.assert_allclose(got, one, rtol=1e-5)


def test_collectives_sum_and_join_in_rank_order():
    """all_reduce hands every rank the rank-ordered sum; all_gather joins
    blocks along a dimension; Shards.whole is the all_gather."""
    mesh = build_mesh(dp=4, devices=[CPU] * 4)
    xs = [torch.full((2, 3), float(i)) for i in range(4)]
    out = all_reduce(xs, mesh, "dp")
    assert len(out) == 4 and all(torch.equal(o, torch.full((2, 3), 6.0))
                                 for o in out)
    assert torch.equal(all_gather(xs, 1), torch.cat(xs, 1))
    assert torch.equal(Shards(xs, 0).whole(), torch.cat(xs, 0))
    with pytest.raises(ValueError, match="3 tensors for 4 ranks"):
        all_reduce(xs[:3], mesh, "dp")


@pytest.mark.parametrize("case", ["batch", "reduction", "ep", "pp"])
def test_refused_by_name(case):
    """A batch dp does not divide is refused naming its layer; a layer
    that reduces over the batch (no cross-rank form) naming it; ep and
    pp naming ROADMAP Queue 1 item 8."""
    if case in ("ep", "pp"):
        with pytest.raises(ValueError, match="Queue 1 item 8"):
            build_mesh(devices=[CPU] * 4, dp=2, **{case: 2})
        return
    text = NET
    if case == "batch":
        text = NET.replace("batch_size: 32", "batch_size: 6")
        match = "layer 'data': batch 6 .* dp axis \\(4 ranks\\)"
    else:
        text = NET.replace(
            'layer { name: "loss"',
            'layer { name: "total" type: "Reduction" bottom: "ip2" '
            'top: "total" reduction_param { axis: 0 } }\nlayer { '
            'name: "loss"')
        match = "layer 'total' \\(Reduction\\) reduces over the batch"
    s = Solver(SolverParameter.from_text(SOLVER),
               NetParameter.from_text(text), device="cpu")
    with pytest.raises(ValueError, match=match):
        ParallelSolver(s, build_mesh(dp=4, devices=[CPU] * 4))
