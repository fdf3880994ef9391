"""BatchNorm, Scale and Concat in the PyTorch port against the JAX
package, alone and in reduced ResNet and GoogLeNet nets.

Same prototxt in both packages, params and inputs from numpy with a
seed.  Tolerances:

  * each layer case: tops and BatchNorm's new running statistics within
    1e-6 relative (plus 1e-6 of the blob's largest element), the
    gradients of a weighted sum of the tops within 1e-5 of their
    largest element (reductions sum in other orders);
  * a reduced ResNet built from the zoo's own `_res_block` (the stem, a
    projecting block and an identity block at 32 px, B 2, 10 classes)
    over 3 SGD steps (He et al. 2016: momentum 0.9, weight_decay 1e-4)
    against the JAX solver: each step's loss 1e-5 relative, each param
    blob and running statistic within 5e-5 of its largest element (the
    worst measured is 1.5e-5: a bias after BatchNorm takes its gradient
    as a difference of batch sums, and the variance is E[x^2] - E[x]^2,
    and both lift the last-bit differences of the convolutions'
    summation orders), with iter_size 1 and 2 (the statistics threaded
    through the sub-batches' forwards);
  * mixed precision (bf16 compute), one step: BatchNorm's params and
    input stay f32, the loss within one bf16 ulp (2^-7 relative), the
    statistics within 2^-7 of their largest element, and each blob's
    update within 5e-2 of its largest element, or within 3 times the
    JAX mixed update's own distance from the JAX f32 update where that
    is larger: against JAX's jitted step, whose fusions keep some bf16
    intermediates in f32, a port computing in f32 would pass these
    limits too.  What tells mixed arithmetic from f32 is the comparison
    with JAX's mixed net evaluated op by op: the first forward's
    statistics within 1e-5 of their largest element and every
    convolution's weight gradient within 5e-2 (measured: 1.8e-6 and
    9.4e-3), limits that the port's f32 net, run as a control in the
    same test, exceeds (3.4e-3 and 0.23);
  * `train_step_many(4)` against 4 x `train_step`: byte-equal;
  * the TEST forward (global statistics, the -test path's
    `eval_step_fn`) against the JAX TEST net;
  * a reduced GoogLeNet (the stem with both LRNs, inception_3a, one
    auxiliary tower; 64 px, narrow widths) over 3 steps of the
    quick_solver shape against the JAX solver (loss 1e-5, params 1e-5 of
    max).  The JAX LRN runs as its own CPU tests run it (the layer's
    plain path); Dropout is taken out of both nets, since the two
    frameworks draw their masks from different generators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import Phase as JaxPhase
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.serving import quant as jax_quant
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.ops import layers as L
from caffeonspark_tpu_torch.proto import (NetParameter, NetState, Phase,
                                          SolverParameter)
from caffeonspark_tpu_torch.serving import quant
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()


def _input(name, *dims):
    return (f'layer {{ name: "{name}" type: "Input" top: "{name}" '
            f'input_param {{ shape {{ {" ".join(f"dim: {d}" for d in dims)}'
            ' } } }\n')


def _bn(extra=""):
    return (_input("x", 3, 4, 5, 6)
            + 'layer { name: "bn" type: "BatchNorm" bottom: "x" top: "y" '
            f'batch_norm_param {{ {extra} }} }}')


def _scale(extra, shape=(3, 4, 5, 6), bottoms=("x",), second=None):
    text = _input("x", *shape)
    if second is not None:
        text += _input("s", *second)
    bots = " ".join(f'bottom: "{b}"' for b in bottoms)
    return (text + f'layer {{ name: "sc" type: "Scale" {bots} top: "y" '
            f'scale_param {{ {extra} }} }}')


def _concat(extra, shapes):
    text = "".join(_input(f"x{i}", *s) for i, s in enumerate(shapes))
    bots = " ".join(f'bottom: "x{i}"' for i in range(len(shapes)))
    return (text + f'layer {{ name: "cat" type: "Concat" {bots} top: "y" '
            f'concat_param {{ {extra} }} }}')


GAUSS = 'filler { type: "gaussian" std: 0.5 }'
BIAS = 'bias_filler { type: "gaussian" std: 0.3 }'
# case: (prototxt, train, count) — count None keeps a random count
CASES = {
    "bn-train": (_bn(), True, None),
    "bn-test": (_bn(), False, None),
    "bn-test-count0": (_bn(), False, 0.0),
    "bn-train-global": (_bn("use_global_stats: true"), True, None),
    "bn-test-batch": (_bn("use_global_stats: false"), False, None),
    "bn-train-maf-eps": (_bn("moving_average_fraction: 0.9 eps: 0.01"),
                         True, None),
    "bn-2d": (_input("x", 6, 5) + 'layer { name: "bn" type: "BatchNorm" '
              'bottom: "x" top: "y" }', True, None),
    "scale-bias": (_scale(f"bias_term: true {GAUSS} {BIAS}"), True, None),
    "scale-nobias": (_scale(GAUSS), True, None),
    "scale-axis-1": (_scale(f"axis: -1 {GAUSS}"), True, None),
    "scale-num_axes0": (_scale(f"num_axes: 0 bias_term: true {GAUSS} "
                               f"{BIAS}"), True, None),
    "scale-num_axes-1": (_scale(f"num_axes: -1 {GAUSS}"), True, None),
    "scale-axis2-num_axes2": (_scale(f"axis: 2 num_axes: 2 {GAUSS}"),
                              True, None),
    "scale-two-bottoms": (_scale("axis: 1", bottoms=("x", "s"),
                                 second=(4, 5)), True, None),
    "scale-two-bottoms-bias": (_scale(f"axis: 0 bias_term: true {BIAS}",
                                      bottoms=("x", "s"),
                                      second=(3, 4, 5)), True, None),
    "concat-axis1": (_concat("", [(2, 3, 4, 4), (2, 5, 4, 4),
                                  (2, 1, 4, 4)]), True, None),
    "concat-axis0": (_concat("axis: 0", [(2, 3, 4), (3, 3, 4)]),
                     True, None),
    "concat-axis-1": (_concat("axis: -1", [(2, 3), (2, 4)]), True, None),
    "concat_dim": (_concat("concat_dim: 2", [(2, 3, 1, 4),
                                             (2, 3, 2, 4)]), True, None),
}


def _nets(text, phase=Phase.TRAIN, dtype=None):
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=int(phase)))
    tnet = Net(NetParameter.from_text(text), NetState(phase=phase),
               device="cpu", compute_dtype=dtype)
    return jnet, tnet


def _rand_params(net, rng, count=None):
    out = {}
    for ln, specs in net.param_layout.items():
        out[ln] = {}
        for bn, shape, _ in specs:
            a = np.asarray(rng.randn(*shape), np.float32)
            if bn == "variance":
                a = np.abs(a) * 3 + 0.5
            elif bn == "count":
                a = np.full(shape, 2.5 if count is None else count,
                            np.float32)
            out[ln][bn] = a
    return out


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    """Tops, new running statistics and gradients of one layer."""
    text, train, count = CASES[case]
    jnet, tnet = _nets(text)
    rng = np.random.RandomState(7)
    arrays = _rand_params(tnet, rng, count)
    inputs = {n: (rng.randn(*s) * 2 + 0.5).astype(np.float32)
              for n, s, _ in tnet.input_specs}
    weights = {t: rng.randn(*tnet.blob_shapes[t]).astype(np.float32)
               for t in tnet.output_blobs if t not in inputs}

    def jloss(p, x):
        blobs, st = jnet.apply(p, x, train=train, rng=jax.random.key(0))
        return (sum(jnp.sum(blobs[t] * w) for t, w in weights.items()),
                (blobs, st))

    (_, (jblobs, jstate)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
         for ln, bl in arrays.items()},
        {n: jnp.asarray(a) for n, a in inputs.items()})

    tp = {ln: {bn: t.requires_grad_(True) for bn, t in bl.items()}
          for ln, bl in convert.params_from_numpy(tnet, arrays).items()}
    tx = {n: torch.from_numpy(a).requires_grad_(True)
          for n, a in inputs.items()}
    state = {}
    blobs = tnet(tp, tx, train=train, state_out=state)
    total = sum(torch.sum(blobs[t] * torch.from_numpy(w))
                for t, w in weights.items())
    leaves = [t for bl in tp.values() for t in bl.values()] + list(
        tx.values())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)

    for t in weights:
        _close(blobs[t].detach(), jblobs[t], 1e-6, f"top {t}")
    assert sorted(state) == sorted(k for k in jstate
                                   if k in tnet.param_layout)
    for ln, vals in state.items():
        assert all(not v.requires_grad for v in vals)
        for v, jv in zip(vals, jstate[ln]):
            _close(v, jv, 1e-6, f"state {ln}")
    jflat = [jgp[ln][bn] for ln, bl in tp.items() for bn in bl] + [
        jgx[n] for n in tx]
    for g, jg, what in zip(grads, jflat,
                           [f"{ln}/{bn}" for ln, bl in tp.items()
                            for bn in bl] + list(tx)):
        if g is None:
            assert not np.any(np.asarray(jg)), what
        else:
            _close(g, jg, 1e-5, f"grad {what}")


# ---------------------------------------------------------------------------
# reduced ResNet from the zoo's own blocks
# ---------------------------------------------------------------------------

def _resnet_text(z, batch=2, px=32, classes=10):
    """The stem, a projecting bottleneck and an identity one."""
    t = f"""
name: "ResNetReduced"
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param {{ batch_size: {batch} channels: 3
    height: {px} width: {px} }} }}
"""
    t += z._CONV_BN.format(name="conv1", bottom="data", n=8, k=7,
                           extra="pad: 3 stride: 2")
    t += """
layer { name: "conv1_relu" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
"""
    t = z._res_block(t, "res2a", "pool1", 4, 16, 1, project=True)
    t = z._res_block(t, "res2b", "res2a", 4, 16, 1, project=False)
    t += f"""
layer {{ name: "pool5" type: "Pooling" bottom: "res2b" top: "pool5"
  pooling_param {{ pool: AVE global_pooling: true }} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "pool5" top: "fc"
  inner_product_param {{ num_output: {classes}
    weight_filler {{ type: "xavier" }} bias_filler {{ type: "constant" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }}
layer {{ name: "accuracy" type: "Accuracy" bottom: "fc" bottom: "label"
  top: "accuracy" include {{ phase: TEST }} }}
"""
    return t


RESNET_SOLVER = ("base_lr: 0.1 momentum: 0.9 weight_decay: 0.0001 "
                 "lr_policy: \"fixed\" max_iter: 12 ")


def _solvers(net_text, solver_text, dtype=None):
    jsolver = JaxSolver(JaxSolverParameter.from_text(solver_text),
                        JaxNetParameter.from_text(net_text),
                        compute_dtype=(jnp.bfloat16 if dtype else None))
    tsolver = Solver(SolverParameter.from_text(solver_text),
                     NetParameter.from_text(net_text), device="cpu",
                     compute_dtype=dtype)
    return jsolver, tsolver


def _batches(n, batch, px, seed=6, classes=10):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 3, px, px).astype(np.float32) * 2 - 0.5,
             rng.randint(0, classes, batch).astype(np.float32))
            for _ in range(n)]


def _run_both(net_text, solver_text, batches, dtype=None, seed=5):
    """The same steps in both packages from one init; returns
    (JAX params, port params, JAX losses, port losses, solvers)."""
    jsolver, tsolver = _solvers(net_text, solver_text, dtype)
    arrays = convert.params_to_numpy(tsolver.train_net.init(seed))
    jp = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
          for ln, bl in arrays.items()}
    jst = jsolver.init_state(jp)
    jstep = jax.jit(jsolver.train_step_fn())
    tp = convert.params_from_numpy(tsolver.train_net, arrays)
    tst = tsolver.init_state(tp)
    jl, tl = [], []
    for it, (data, label) in enumerate(batches):
        jp, jst, jout = jstep(jp, jst, {"data": jnp.asarray(data),
                                        "label": jnp.asarray(label)},
                              jsolver.step_rng(it))
        _, out = tsolver.train_step(tp, tst, {
            "data": torch.from_numpy(data),
            "label": torch.from_numpy(label)})
        jl.append(float(jout["loss"]))
        tl.append(float(out["loss"]))
    return jp, tp, jl, tl, (jsolver, tsolver, jst, tst)


def _stats_and_weights(net, tp, jp, w_tol, s_tol):
    stats = set(net.stat_param_layers())
    assert stats                       # the net has BatchNorm layers
    for ln, bl in tp.items():
        for bn, w in bl.items():
            _close(w.float(), np.asarray(jp[ln][bn], np.float32),
                   s_tol if ln in stats else w_tol, f"{ln}/{bn}")
    moved = [ln for ln in stats
             if float(tp[ln]["count"][0]) > 0
             and float(tp[ln]["variance"].abs().max()) > 0]
    assert sorted(moved) == sorted(stats)


@pytest.mark.parametrize("iter_size", [1, 2])
def test_reduced_resnet_three_steps_match_jax(iter_size):
    text = _resnet_text(zoo, batch=4)
    assert text == _resnet_text(jax_zoo, batch=4)
    jp, tp, jl, tl, (_, tsolver, _, tst) = _run_both(
        text, RESNET_SOLVER + f"iter_size: {iter_size}",
        _batches(3, 4, 32))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tst.iter == 3
    _stats_and_weights(tsolver.train_net, tp, jp, 5e-5, 5e-5)
    # each forward counts once: count = sum maf^k over the forwards
    n = 3 * iter_size
    want = sum(0.999 ** k for k in range(n))
    np.testing.assert_allclose(float(tp["bn_conv1"]["count"][0]), want,
                               rtol=1e-6)


def test_reduced_resnet_mixed_keeps_stats_f32(monkeypatch):
    text = _resnet_text(zoo)
    batches = _batches(1, 2, 32)
    jp, tp, jl, tl, (jsolver, tsolver, _, _) = _run_both(
        text, RESNET_SOLVER, batches, dtype=torch.bfloat16)
    jp32 = _run_both(text, RESNET_SOLVER, batches)[0]
    net = tsolver.train_net
    assert net.compute_dtype == torch.bfloat16
    stats = set(net.stat_param_layers())
    for ln in stats:
        assert all(t.dtype == torch.float32 for t in tp[ln].values())
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -7)
    init = convert.params_to_numpy(net.init(5))
    for ln, bl in tp.items():
        for bn, w in bl.items():
            got, want = w.float().numpy(), np.asarray(jp[ln][bn])
            if ln in stats:
                _close(got, want, 2.0 ** -7, f"{ln}/{bn}")
                continue
            upd, jupd = got - init[ln][bn], want - init[ln][bn]
            spread = np.max(np.abs(jupd - (np.asarray(jp32[ln][bn])
                                           - init[ln][bn])))
            tol = max(5e-2 * np.max(np.abs(jupd)), 3 * spread)
            assert np.max(np.abs(upd - jupd)) <= tol, f"{ln}/{bn}"
    # each BatchNorm gets its input and params in f32 and computes in
    # f32; the Scale after it computes in bf16
    seen = []
    op = L.get_op("BatchNorm")
    real = op.apply

    def spy(ctx, lp, params, bottoms):
        tops = real(ctx, lp, params, bottoms)
        seen.append([t.dtype for t in bottoms + params + tops])
        return tops

    monkeypatch.setattr(op, "apply", spy)
    scale_dtypes = []
    sop = L.get_op("Scale")
    sreal = sop.apply
    monkeypatch.setattr(sop, "apply", lambda ctx, lp, p, b: scale_dtypes
                        .append(b[0].dtype) or sreal(ctx, lp, p, b))
    tsolver.loss_and_grads(tp, {"data": torch.from_numpy(batches[0][0]),
                                "label": torch.from_numpy(batches[0][1])})
    assert len(seen) == len(net.stat_param_layers())
    assert all(d == torch.float32 for row in seen for d in row)
    assert scale_dtypes and set(scale_dtypes) == {torch.bfloat16}
    monkeypatch.undo()
    # the arithmetic itself, against JAX's mixed forward and gradient
    # evaluated op by op; the port's f32 net is the control that these
    # limits must reject
    stats_err, grad_err, loss_err = _mixed_readings(
        text, batches[0], torch.bfloat16, jsolver)
    assert stats_err <= MIXED_STATS_TOL, stats_err
    assert grad_err <= MIXED_CONV_GRAD_TOL, grad_err
    assert loss_err <= 2.0 ** -7, loss_err
    stats_ctl, grad_ctl, _ = _mixed_readings(text, batches[0], None, jsolver)
    assert stats_ctl > MIXED_STATS_TOL, stats_ctl
    assert grad_ctl > MIXED_CONV_GRAD_TOL, grad_ctl


# Limits of the op-by-op comparison, each between the mixed port's
# largest reading and the f32 control's (measured on the CPU: statistics
# 1.8e-6 against 3.4e-3 of their largest element, convolution weight
# gradients 9.4e-3 against 0.23)
MIXED_STATS_TOL = 1e-5
MIXED_CONV_GRAD_TOL = 5e-2


def _mixed_readings(text, batch, dtype, jsolver):
    """(statistics error, convolution-weight gradient error, loss
    error) of one port forward and gradient, with `dtype` compute, from
    the init of `_run_both`, against the JAX mixed net's `loss` and its
    gradient evaluated op by op: each error the largest over the blobs,
    relative to the blob's largest element.  Op by op fixes where bf16
    rounds; under jit XLA fuses elementwise chains and keeps their
    intermediates in f32, which moves the statistics by 1e-3 and the
    gradients by up to 0.5 of their largest element, as far as f32
    compute does."""
    _, tsolver = _solvers(text, RESNET_SOLVER, dtype)
    net = tsolver.train_net
    arrays = convert.params_to_numpy(net.init(5))
    data, label = batch

    def jloss(p):
        total, (_, st) = jsolver.train_net.loss(
            p, {"data": jnp.asarray(data), "label": jnp.asarray(label)},
            train=True, rng=jax.random.key(0))
        return total, st

    (jl, jst), jg = jax.value_and_grad(jloss, has_aux=True)(
        {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
         for ln, bl in arrays.items()})
    leaves = {ln: {bn: t.requires_grad_(True) for bn, t in bl.items()}
              for ln, bl in convert.params_from_numpy(net, arrays).items()}
    state = {}
    loss, _ = net.loss(leaves, {"data": torch.from_numpy(data),
                                "label": torch.from_numpy(label)},
                       train=True, state_out=state)
    convs = [lp.name for lp in net.compute_layers
             if lp.type == "Convolution"]
    grads = torch.autograd.grad(loss, [leaves[ln]["weight"]
                                       for ln in convs])

    def rel(got, want):
        want = np.asarray(want, np.float64)
        return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                     / np.max(np.abs(want)))

    stats_err = max(rel(v.float(), jv) for ln, vals in state.items()
                    for v, jv in zip(vals, jst[ln])
                    if np.any(np.asarray(jv)))
    grad_err = max(rel(g.float(), jg[ln]["weight"])
                   for ln, g in zip(convs, grads))
    loss_err = abs(float(loss.detach()) - float(jl)) / float(jl)
    return stats_err, grad_err, loss_err


@pytest.mark.parametrize("iter_size", [1, 2])
def test_loss_and_grads_leaves_params_untouched(iter_size):
    """Gradients alone write nothing, the statistics included; the
    step merges them after its update."""
    text = _resnet_text(zoo, batch=4)
    _, tsolver = _solvers(text, RESNET_SOLVER + f"iter_size: {iter_size}")
    params = tsolver.train_net.init(5)
    before = convert.params_to_numpy(params)
    (data, label), = _batches(1, 4, 32)
    batch = {"data": torch.from_numpy(data),
             "label": torch.from_numpy(label)}
    tsolver.loss_and_grads(params, batch)
    _same = convert.params_to_numpy(params)
    for ln, bl in before.items():
        for bn, a in bl.items():
            assert np.array_equal(_same[ln][bn], a), f"{ln}/{bn}"
    *_, state = tsolver.loss_grads_and_state(params, batch)
    assert sorted(state) == sorted(tsolver.train_net.stat_param_layers())
    st = tsolver.init_state(params)
    tsolver.train_step(params, st, batch)
    for ln, values in state.items():
        for (bn, _, _), v in zip(tsolver.train_net.param_layout[ln],
                                 values):
            assert torch.equal(params[ln][bn], v), f"{ln}/{bn}"


def test_train_step_many_equals_single_steps_with_batchnorm():
    text = _resnet_text(zoo)
    _, tsolver = _solvers(text, RESNET_SOLVER)
    p1, st1 = tsolver.init()
    p4 = convert.params_from_numpy(tsolver.train_net,
                                   convert.params_to_numpy(p1))
    st4 = tsolver.init_state(p4)
    batches = _batches(4, 2, 32)
    gen = tsolver.generator.get_state()
    for data, label in batches:
        tsolver.train_step(p1, st1, {"data": torch.from_numpy(data),
                                     "label": torch.from_numpy(label)})
    tsolver.generator.set_state(gen)
    stacked = {"data": torch.from_numpy(np.stack([b[0] for b in batches])),
               "label": torch.from_numpy(np.stack([b[1] for b in batches]))}
    losses, _ = tsolver.train_step_many(4)(p4, st4, stacked)
    assert losses.shape == (4,) and st4.iter == st1.iter == 4
    for ln, bl in p1.items():
        for bn, t in bl.items():
            assert torch.equal(t, p4[ln][bn]), f"{ln}/{bn}"


def test_test_forward_uses_global_stats_like_jax():
    text = _resnet_text(zoo)
    jp, tp, _, _, (jsolver, tsolver, _, _) = _run_both(
        text, RESNET_SOLVER, _batches(2, 2, 32))
    data, label = _batches(1, 2, 32, seed=9)[0]
    out = tsolver.eval_step_fn()(tp, {"data": torch.from_numpy(data),
                                      "label": torch.from_numpy(label)})
    jblobs, jstate = jsolver.test_net.apply(
        jp, {"data": jnp.asarray(data), "label": jnp.asarray(label)},
        train=False)
    assert jstate == {}
    for name in ("loss", "accuracy"):
        _close(out[name], jblobs[name], 1e-5, name)
    # the TRAIN forward (batch statistics) gives another loss
    train_blobs = tsolver.train_net(tp, {"data": torch.from_numpy(data),
                                         "label": torch.from_numpy(label)},
                                    train=True, state_out={})
    assert abs(float(train_blobs["loss"]) - float(out["loss"])) > 1e-4


def test_quant_spec_never_compresses_a_stat_layer():
    """serving/quant.py mirrors JAX quant.py:116: BatchNorm's blobs stay
    f32 in every weight dtype (ResNet-50, TEST phase)."""
    text = zoo.resnet50(batch_size=1).to_text()
    tnet = Net(NetParameter.from_text(text), NetState(phase=Phase.TEST),
               device="meta")
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=JaxPhase.TEST))
    bns = set(tnet.stat_param_layers())
    assert len(bns) == 53
    for wd in ("int8", "bf16"):
        spec = quant.quant_spec(tnet, wd)
        assert not bns & set(spec)
        assert spec == jax_quant.quant_spec(jnet, wd)


# ---------------------------------------------------------------------------
# reduced GoogLeNet
# ---------------------------------------------------------------------------

def _googlenet_text(z, batch=2, px=64, classes=10):
    """The bvlc_googlenet stem (both LRNs), inception_3a and the first
    auxiliary tower at narrow widths, Dropout taken out."""
    t = f"""
name: "GoogLeNetReduced"
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param {{ batch_size: {batch} channels: 3
    height: {px} width: {px} }} }}
"""
    t += z._CONV.format(name="conv1/7x7_s2", bottom="data", n=8, k=7,
                        extra="pad: 3 stride: 2", std=0.01, bias=0.2)
    t += """
layer { name: "pool1_3x3_s2" type: "Pooling" bottom: "conv1/7x7_s2"
  top: "pool1" pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "pool1_norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
"""
    t += z._CONV.format(name="conv2/3x3_reduce", bottom="norm1", n=8, k=1,
                        extra="", std=0.09, bias=0.2)
    t += z._CONV.format(name="conv2/3x3", bottom="conv2/3x3_reduce",
                        n=16, k=3, extra="pad: 1", std=0.03, bias=0.2)
    t += """
layer { name: "conv2_norm2" type: "LRN" bottom: "conv2/3x3" top: "norm2"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool2_3x3_s2" type: "Pooling" bottom: "norm2"
  top: "pool2" pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
"""
    t = z._inception(t, "inception_3a", "pool2", 4, 4, 8, 2, 4, 4)
    t += z._googlenet_aux_head(1, "inception_3a/output", classes)
    t += f"""
layer {{ name: "pool5" type: "Pooling" bottom: "inception_3a/output"
  top: "pool5" pooling_param {{ pool: AVE global_pooling: true }} }}
layer {{ name: "loss3/classifier" type: "InnerProduct" bottom: "pool5"
  top: "loss3/classifier"
  inner_product_param {{ num_output: {classes}
    weight_filler {{ type: "xavier" }} bias_filler {{ type: "constant" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "loss3/classifier"
  bottom: "label" top: "loss" }}
"""
    npm = z.parse_net_prototxt(t)
    npm.layer = [lp for lp in npm.layer if lp.type != "Dropout"]
    return npm.to_text()


GOOGLENET_SOLVER = ('base_lr: 0.01 lr_policy: "poly" power: 0.5 '
                    'momentum: 0.9 weight_decay: 0.0002 max_iter: 8 ')


def test_reduced_googlenet_three_steps_match_jax():
    text = _googlenet_text(zoo)
    assert text == _googlenet_text(jax_zoo)
    jp, tp, jl, tl, (_, tsolver, _, _) = _run_both(
        text, GOOGLENET_SOLVER, _batches(3, 2, 64))
    net = tsolver.train_net
    assert "loss1/loss" in net.loss_weights          # the aux tower
    assert net.loss_weights["loss1/loss"] == pytest.approx(0.3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for ln, bl in tp.items():
        for bn, w in bl.items():
            _close(w, np.asarray(jp[ln][bn]), 1e-5, f"{ln}/{bn}")


def test_googlenet_peephole_fuses_norm2_only(monkeypatch):
    """COS_FUSE_BIAS_RELU_LRN=1 puts conv2/3x3's bias and relu into
    norm2's kernel (K3/K4); norm1 follows a pooling and stays K1/K2."""
    monkeypatch.setenv("COS_FUSE_BIAS_RELU_LRN", "1")
    net = Net(NetParameter.from_text(zoo.googlenet(batch_size=2)
                                     .to_text()), device="meta")
    assert net.fused_bias_lrn == {"conv2_norm2": "conv2/3x3"}
    assert net.fused_relu_lrn == frozenset({"conv2_norm2"})
    assert net.blob_shapes["norm1"] == (2, 64, 56, 56)
    assert net.blob_shapes["norm2"] == (2, 192, 56, 56)
