"""The recurrent layers (LSTM, RNN) and the zoo's `lstm_lm` in the
PyTorch port against the JAX package.

Same prototxt in both packages, params and inputs from numpy with a
seed, params crossing by `convert.params_from_numpy`.  Tolerances:

  * each layer case (LSTM with and without a static input and with
    `expose_hidden`, RNN): tops within 1e-6 relative (plus 1e-6 of the
    blob's largest element), the gradients of a weighted sum of the
    tops, with respect to every param and bottom (cont included), within
    1e-5 of their largest element;
  * a restart at cont 0 equals a fresh run from that step, and
    `expose_hidden` in two chunks equals the full run (1e-6 of the
    largest element: the same products in the same order, up to the
    summation order of the batched input projection);
  * `lstm_lm` (vocab 20, d_model 32, seq 8, batch 4) under LRCN's
    solver (SGD, momentum 0.9, clip_gradients 10) for 3 steps against
    the JAX solver: each loss 1e-5 relative, each param blob within
    1e-5 of its largest element;
  * mixed (bf16 compute, f32 params) and bfloat16 (bf16 params and
    compute): one forward and gradient against the JAX net of the same
    dtypes evaluated op by op (`jax.disable_jit`, so that each op rounds
    to bf16 where the port's does; under jit XLA's fusions keep the
    scan's elementwise chains in f32).  Two of the reference's ops are
    replaced in the test by their f32 evaluation rounded once to bf16:
    JAX's CPU backend expands a bf16 `logistic` as 1 / (1 + exp(-x))
    with a bf16 rounding after each of the four ops, and `log_softmax`
    likewise, where PyTorch rounds once; those two roundings alone part
    a third of the LSTM's outputs by one ulp.  Limits: the LSTM's and
    the classifier's tops within MIXED_TOP_TOL of their largest element
    (measured: equal to the bit), the loss within one bf16 ulp (2^-7,
    measured equal), every gradient within MIXED_GRAD_TOL of its
    largest element (measured 6.8e-3: the backward rounds in other
    places than JAX's transposed ops).  The port's f32 net, run as the
    control in the same test, must exceed the tops' limit (measured
    6.2e-3), so the test tells bf16 arithmetic from f32;
  * a `.caffemodel` of `lstm_lm` crosses both ways byte-equal;
  * `train_step_many(4)` equals 4 `train_step` calls to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu import checkpoint as jax_checkpoint
from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import checkpoint, convert
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.ops import layers as L
from caffeonspark_tpu_torch.proto import (LayerParameter, NetParameter,
                                          NetState, Phase, SolverParameter)
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

UNIFORM = 'weight_filler { type: "uniform" min: -0.3 max: 0.3 }'
BIAS = 'bias_filler { type: "uniform" min: -0.2 max: 0.2 }'
T, B, D, N, DS = 6, 3, 5, 4, 7


def _input(name, *dims):
    return (f'layer {{ name: "{name}" type: "Input" top: "{name}" '
            f'input_param {{ shape {{ {" ".join(f"dim: {d}" for d in dims)}'
            ' } } }\n')


def _recurrent(typ, static=False, expose=False, x_shape=(T, B, D)):
    text = _input("x", *x_shape) + _input("cont", T, B)
    bots = ["x", "cont"]
    tops = ["y"]
    if static:
        text += _input("s", B, DS)
        bots.append("s")
    if expose:
        text += _input("h0", 1, B, N) + _input("c0", B, N)
        bots += ["h0", "c0"]
        tops += ["hT", "cT"]
    flag = "expose_hidden: true " if expose else ""
    return text + (
        f'layer {{ name: "rec" type: "{typ}" '
        + " ".join(f'bottom: "{b}"' for b in bots) + " "
        + " ".join(f'top: "{t}"' for t in tops)
        + f" recurrent_param {{ num_output: {N} {flag}{UNIFORM} {BIAS} }} }}")


CASES = {
    "lstm": _recurrent("LSTM"),
    "lstm-static": _recurrent("LSTM", static=True),
    "lstm-expose": _recurrent("LSTM", expose=True),
    "lstm-static-expose": _recurrent("LSTM", static=True, expose=True),
    "lstm-4d-input": _recurrent("LSTM", x_shape=(T, B, 2, 3)),
    "rnn": _recurrent("RNN"),
}


def _cont(rng, t=T, b=B):
    """0 at each sequence start (step 0 and a few restarts), else 1."""
    c = (rng.rand(t, b) > 0.2).astype(np.float32)
    c[0] = 0.0
    return c


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recurrent_layer_matches_jax(case):
    text = CASES[case]
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=int(Phase.TRAIN)))
    tnet = Net(NetParameter.from_text(text), NetState(phase=Phase.TRAIN),
               device="cpu")
    rng = np.random.RandomState(3)
    arrays = {ln: {bn: rng.uniform(-0.4, 0.4, s).astype(np.float32)
                   for bn, s, _ in specs}
              for ln, specs in tnet.param_layout.items()}
    inputs = {n: (_cont(rng) if n == "cont"
                  else rng.randn(*s).astype(np.float32))
              for n, s, _ in tnet.input_specs}
    weights = {t: rng.randn(*tnet.blob_shapes[t]).astype(np.float32)
               for t in tnet.output_blobs}

    def jloss(p, x):
        blobs, _ = jnet.apply(p, x, train=True)
        return (sum(jnp.sum(blobs[t] * w) for t, w in weights.items()),
                blobs)

    (_, jblobs), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
         for ln, bl in arrays.items()},
        {n: jnp.asarray(a) for n, a in inputs.items()})
    tp = {ln: {bn: t.requires_grad_(True) for bn, t in bl.items()}
          for ln, bl in convert.params_from_numpy(tnet, arrays).items()}
    tx = {n: torch.from_numpy(a).requires_grad_(True)
          for n, a in inputs.items()}
    blobs = tnet(tp, tx, train=True)
    total = sum(torch.sum(blobs[t] * torch.from_numpy(w))
                for t, w in weights.items())
    leaves = [t for bl in tp.values() for t in bl.values()] + list(
        tx.values())
    grads = torch.autograd.grad(total, leaves)
    for t in weights:
        assert tuple(blobs[t].shape) == tuple(jblobs[t].shape), t
        _close(blobs[t].detach(), jblobs[t], 1e-6, f"top {t}")
    jflat = [jgp[ln][bn] for ln, bl in tp.items() for bn in bl] + [
        jgx[n] for n in tx]
    names = [f"{ln}/{bn}" for ln, bl in tp.items() for bn in bl] + list(tx)
    for g, jg, what in zip(grads, jflat, names):
        _close(g, jg, 1e-5, f"grad {what}")
    # an integer cont (an INT_ARRAY top) is cast to the compute dtype
    with torch.no_grad():
        blobs_i = tnet(tp, {**tx, "cont": tx["cont"].detach().to(
            torch.int64)}, train=True)
    for t in weights:
        assert torch.equal(blobs_i[t], blobs[t].detach()), t


def _lstm_op(expose=False):
    flag = "expose_hidden: true " if expose else ""
    tops = 'top: "h" top: "hT" top: "cT"' if expose else 'top: "h"'
    bots = 'bottom: "x" bottom: "cont"' + (
        ' bottom: "h0" bottom: "c0"' if expose else "")
    lp = LayerParameter.from_text(
        f'name: "l" type: "LSTM" {bots} {tops} recurrent_param {{ '
        f'num_output: 4 {flag}{UNIFORM} }}')
    return L.get_op("LSTM"), lp


def _lstm_params(seed=0):
    rng = np.random.RandomState(seed)
    _, lp = _lstm_op()
    return [torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(np.float32))
            for _, s, _ in L._lstm_params(lp, [(8, 2, 3), (8, 2)])]


def test_lstm_restart_at_cont_zero_equals_a_fresh_run():
    op, lp = _lstm_op()
    params = _lstm_params()
    x = torch.from_numpy(np.random.RandomState(1).randn(6, 2, 3)
                         .astype(np.float32))
    cont = torch.ones(6, 2)
    cont[0] = 0.0
    cont[3] = 0.0
    h = op.apply(L.Ctx(), lp, params, [x, cont])[0]
    assert tuple(h.shape) == (6, 2, 4)
    fresh = torch.ones(3, 2)
    fresh[0] = 0.0
    h2 = op.apply(L.Ctx(), lp, params, [x[3:], fresh])[0]
    _close(h[3:], h2, 1e-6, "restart")


def test_lstm_expose_hidden_in_two_chunks_equals_the_full_run():
    op, lp = _lstm_op()
    op_e, lp_e = _lstm_op(expose=True)
    params = _lstm_params(5)
    x = torch.from_numpy(np.random.RandomState(6).randn(8, 2, 3)
                         .astype(np.float32))
    cont = torch.ones(8, 2)
    cont[0] = 0.0
    full = op.apply(L.Ctx(), lp, params, [x, cont])[0]
    z = torch.zeros(1, 2, 4)
    h1, ht, ct = op_e.apply(L.Ctx(), lp_e, params, [x[:4], cont[:4], z, z])
    assert tuple(ht.shape) == tuple(ct.shape) == (1, 2, 4)
    # cont 1 at the chunk boundary carries the state in
    h2, _, _ = op_e.apply(L.Ctx(), lp_e, params,
                          [x[4:], torch.ones(4, 2), ht, ct])
    _close(torch.cat([h1, h2]), full, 1e-6, "chunks")


# ---------------------------------------------------------------------------
# lstm_lm: the solver, the dtypes, the caffemodel, K=4
# ---------------------------------------------------------------------------

LM = dict(vocab=20, d_model=32, seq=8, batch_size=4)
# LRCN's solver (Caffe's examples/coco_caption/lrcn_solver.prototxt),
# max_iter cut
LRCN_SOLVER = ("base_lr: 0.01 momentum: 0.9 weight_decay: 0 "
               "lr_policy: \"step\" gamma: 0.5 stepsize: 20000 "
               "clip_gradients: 10 max_iter: 8 random_seed: 1 ")


def _lm_text():
    text = zoo.lstm_lm(**LM).to_text()
    assert text == jax_zoo.lstm_lm(**LM).to_text()
    return text


def _lm_batches(n, seed=4):
    """Caption-shaped batches: START then words, cont 0 then 1 over the
    caption and 0 past it, the target the words then END, -1 past it."""
    rng = np.random.RandomState(seed)
    t, b, v = LM["seq"], LM["batch_size"], LM["vocab"]
    out = []
    for _ in range(n):
        inp = np.zeros((t, b), np.float32)
        cont = np.zeros((t, b), np.float32)
        tgt = np.full((t, b), -1.0, np.float32)
        for j in range(b):
            k = rng.randint(2, t)
            words = rng.randint(2, v, k - 1)
            inp[1:k, j] = words
            cont[1:k, j] = 1.0
            tgt[:k - 1, j] = words
            tgt[k - 1, j] = 0.0
        out.append({"input_sentence": inp, "cont_sentence": cont,
                    "target_sentence": tgt})
    return out


def _lm_arrays(seed=2):
    tnet = Net(NetParameter.from_text(_lm_text()),
               NetState(phase=Phase.TRAIN), device="cpu")
    return tnet, convert.params_to_numpy(tnet.init(seed))


def test_lstm_lm_sgd_steps_match_the_jax_solver():
    text = _lm_text()
    _, arrays = _lm_arrays()
    js = JaxSolver(JaxSolverParameter.from_text(LRCN_SOLVER),
                   JaxNetParameter.from_text(text))
    ts = Solver(SolverParameter.from_text(LRCN_SOLVER),
                NetParameter.from_text(text), device="cpu")
    assert ts.train_net.num_params() == (20 * 32 + 4 * 32 * 32 * 2 + 4 * 32
                                         + 20 * 32 + 20)
    jp = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
          for ln, bl in arrays.items()}
    jst = js.init_state(jp)
    jstep = jax.jit(js.train_step_fn())
    tp = convert.params_from_numpy(ts.train_net, arrays)
    tst = ts.init_state(tp)
    jl, tl = [], []
    for it, batch in enumerate(_lm_batches(3)):
        jp, jst, jout = jstep(jp, jst, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              js.step_rng(it))
        _, out = ts.train_step(tp, tst, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        jl.append(float(jout["loss"]))
        tl.append(float(out["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert abs(tl[0] - np.log(20)) < 0.1
    for ln, bl in tp.items():
        for bn, w in bl.items():
            _close(w, jp[ln][bn], 1e-5, f"{ln}/{bn}")


# Limits of the op-by-op comparison (measured on the CPU: the tops equal
# to the bit, f32 control 6.2e-3; gradients 6.8e-3)
MIXED_TOP_TOL = 1e-3
MIXED_LOSS_TOL = 2.0 ** -7
MIXED_GRAD_TOL = 2e-2


def _rounded_once(fn):
    """`fn` evaluated in f32 and rounded once to its input's dtype."""
    def once(x, *args, **kw):
        return fn(x.astype(jnp.float32), *args, **kw).astype(x.dtype)
    return once


def _bf16_readings(dtype, port_dtype, monkeypatch):
    """(loss error, tops error, worst gradient error) of one forward and
    gradient of the port's lstm_lm with `port_dtype` ("float32",
    "mixed", "bfloat16"), from the params of `_lm_arrays`, against the
    JAX net of `dtype` ("mixed" or "bfloat16") evaluated op by op: the
    loss relative, each top (lstm1, predict) and gradient relative to
    its blob's largest element."""
    text = _lm_text()
    _, arrays = _lm_arrays()
    batch = _lm_batches(1, seed=9)[0]
    jdt = dict(mixed=(jnp.float32, jnp.bfloat16),
               bfloat16=(jnp.bfloat16, None))[dtype]
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=int(Phase.TRAIN)), dtype=jdt[0],
                  compute_dtype=jdt[1])

    def jloss(p):
        total, (blobs, _) = jnet.loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
            rng=jax.random.key(0))
        return total, blobs

    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jax.nn, "sigmoid", _rounded_once(jax.nn.sigmoid))
        m.setattr(jax.nn, "log_softmax", _rounded_once(jax.nn.log_softmax))
        (jl, jblobs), jg = jax.value_and_grad(jloss, has_aux=True)(
            {ln: {bn: jnp.asarray(a, jdt[0]) for bn, a in bl.items()}
             for ln, bl in arrays.items()})
    tdt = dict(float32=(torch.float32, None),
               mixed=(torch.float32, torch.bfloat16),
               bfloat16=(torch.bfloat16, None))[port_dtype]
    tnet = Net(NetParameter.from_text(text), NetState(phase=Phase.TRAIN),
               device="cpu", dtype=tdt[0], compute_dtype=tdt[1])
    tp = {ln: {bn: t.to(tdt[0]).requires_grad_(True)
               for bn, t in bl.items()}
          for ln, bl in convert.params_from_numpy(tnet, arrays).items()}
    loss, blobs = tnet.loss(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    names = [(ln, bn) for ln, bl in tp.items() for bn in bl]
    grads = torch.autograd.grad(loss, [tp[ln][bn] for ln, bn in names])

    def rel(got, want):
        want = np.asarray(want, np.float64)
        return float(np.max(np.abs(got.detach().double().numpy() - want))
                     / np.max(np.abs(want)))

    loss_err = abs(float(loss.detach()) - float(jl)) / abs(float(jl))
    top_err = max(rel(blobs[t], jblobs[t]) for t in ("lstm1", "predict"))
    grad_err = max(rel(g, jg[ln][bn]) for (ln, bn), g in zip(names, grads))
    return loss_err, top_err, grad_err


@pytest.mark.parametrize("dtype", ["mixed", "bfloat16"])
def test_lstm_lm_bf16_arithmetic_matches_jax_op_by_op(dtype, monkeypatch):
    loss_err, top_err, grad_err = _bf16_readings(dtype, dtype, monkeypatch)
    assert loss_err <= MIXED_LOSS_TOL, loss_err
    assert top_err <= MIXED_TOP_TOL, top_err
    assert grad_err <= MIXED_GRAD_TOL, grad_err
    # the control: the f32 port against the same bf16 reference
    _, top_ctl, _ = _bf16_readings(dtype, "float32", monkeypatch)
    assert top_ctl > MIXED_TOP_TOL, top_ctl


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_lstm_lm_caffemodel_crosses_byte_equal(direction, tmp_path):
    text = _lm_text()
    tnet, arrays = _lm_arrays(seed=8)
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=int(Phase.TRAIN)))
    jparams = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
               for ln, bl in arrays.items()}
    first, second = tmp_path / "a.caffemodel", tmp_path / "b.caffemodel"
    if direction == "jax_to_port":
        jax_checkpoint.save_caffemodel(str(first), jnet, jparams)
        params = checkpoint.copy_layers(tnet, tnet.init(99), str(first))
        checkpoint.save_caffemodel(str(second), tnet, params)
    else:
        checkpoint.save_caffemodel(
            str(first), tnet, convert.params_from_numpy(tnet, arrays))
        jp = jax_checkpoint.copy_layers(jnet, jnet.init(jax.random.key(1)),
                                        str(first))
        jax_checkpoint.save_caffemodel(str(second), jnet, jp)
    assert first.read_bytes() == second.read_bytes()
    blobs = checkpoint.load_caffemodel_blobs(str(second))
    assert [b.shape for b in blobs["lstm1"]] == [(128, 32), (128,),
                                                 (128, 32)]


def test_lstm_lm_train_step_many_equals_single_steps():
    text = _lm_text()
    batches = _lm_batches(4, seed=12)
    a = Solver(SolverParameter.from_text(LRCN_SOLVER),
               NetParameter.from_text(text), device="cpu")
    pa, sa = a.init()
    want = [a.train_step(pa, sa, {k: torch.from_numpy(v)
                                  for k, v in b.items()})[0]
            for b in batches]
    b_ = Solver(SolverParameter.from_text(LRCN_SOLVER),
                NetParameter.from_text(text), device="cpu")
    pb, sb = b_.init()
    losses, _ = b_.train_step_many(4)(pb, sb, {
        k: torch.from_numpy(np.stack([b[k] for b in batches]))
        for k in batches[0]})
    assert torch.equal(losses, torch.stack(want))
    for ln in pa:
        for bn in pa[ln]:
            assert torch.equal(pa[ln][bn], pb[ln][bn]), (ln, bn)
