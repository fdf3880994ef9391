"""bf16 compute in the PyTorch port against the JAX package.

Same prototxt in both packages, params and inputs from numpy with a
seed.  A bf16 operation rounds its result to 8 significant bits, and
the two frameworks round at different points (XLA's CPU backend keeps
some intermediates of a bf16 chain in f32, PyTorch rounds each op), so
a top in bf16 is held to BF16_RTOL = 2^-6 (two bf16 ulps) of its value
plus BF16_ATOL of its largest element; the cases in f32 as in
test_torch_net.py.

  * each ported layer type in a net with `compute_dtype=bfloat16`
    (mixed precision): the tops' dtypes equal the JAX package's, their
    values and the params' f32 gradients within the bf16 tolerance;
    LRN against the Pallas kernel in interpret mode, which computes in
    f32 inside as the TPU kernel does (the JAX package's XLA fallback
    on the CPU computes in bf16);
  * the index departure: Embed ids and SoftmaxWithLoss / Accuracy
    labels above 256 keep their value in the port and are rounded by
    bf16 in the JAX package; up to 256 the packages agree;
  * the solver's update rule on the same params, gradients and history
    (bf16 params; f32 params under COS_STATE_DTYPE=bfloat16) for each
    solver type: SGD and Nesterov bit-equal to JAX (the promotions
    match op for op), the others within one bf16 ulp; one whole step
    of each type under bf16 params;
  * checkpoint: bf16 params written as f32, restored in the net's dtype;
    a COS_STATE_DTYPE=bfloat16 resume keeps bf16 history.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.ops.pallas_kernels import \
    lrn_across_channels as jax_lrn
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import Phase as JaxPhase
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import checkpoint
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.ops import kernels as K
from caffeonspark_tpu_torch.proto import (NetParameter, NetState, Phase,
                                          SolverParameter)
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

BF16_RTOL, BF16_ATOL = 2.0 ** -6, 2.0 ** -8
BF16 = torch.bfloat16


def _input(name, *dims):
    return (f'layer {{ name: "{name}" type: "Input" top: "{name}" '
            f'input_param {{ shape {{ {" ".join(f"dim: {d}" for d in dims)}'
            ' } } }\n')


GAUSS = 'weight_filler { type: "gaussian" std: 0.2 }'
LAYERS = {
    "Convolution": (_input("x", 2, 3, 9, 9)
                    + 'layer { name: "l" type: "Convolution" bottom: "x" '
                    'top: "y" convolution_param { num_output: 4 '
                    f'kernel_size: 3 stride: 2 pad: 1 {GAUSS} bias_filler '
                    '{ type: "constant" value: 0.1 } } }'),
    "InnerProduct": (_input("x", 4, 12)
                     + 'layer { name: "l" type: "InnerProduct" bottom: "x" '
                     f'top: "y" inner_product_param {{ num_output: 5 {GAUSS}'
                     ' bias_filler { type: "constant" value: 0.1 } } }'),
    "Embed": (_input("ids", 4, 6)
              + 'layer { name: "l" type: "Embed" bottom: "ids" top: "y" '
              f'embed_param {{ input_dim: 200 num_output: 8 {GAUSS} }} }}'),
    "Pooling MAX": (_input("x", 2, 3, 7, 7)
                    + 'layer { name: "l" type: "Pooling" bottom: "x" '
                    'top: "y" pooling_param { pool: MAX kernel_size: 3 '
                    'stride: 2 } }'),
    "Pooling AVE": (_input("x", 2, 3, 7, 7)
                    + 'layer { name: "l" type: "Pooling" bottom: "x" '
                    'top: "y" pooling_param { pool: AVE kernel_size: 3 '
                    'stride: 2 pad: 1 } }'),
    "ReLU": (_input("x", 4, 10)
             + 'layer { name: "l" type: "ReLU" bottom: "x" top: "y" '
             'relu_param { negative_slope: 0.1 } }'),
    "Dropout": (_input("x", 4, 10)
                + 'layer { name: "l" type: "Dropout" bottom: "x" top: "y" '
                'dropout_param { dropout_ratio: 0.3 } }'),
    "Eltwise SUM": (_input("a", 4, 10) + _input("b", 4, 10)
                    + 'layer { name: "l" type: "Eltwise" bottom: "a" '
                    'bottom: "b" top: "y" eltwise_param { operation: SUM '
                    'coeff: 0.5 coeff: -1.5 } }'),
    "Eltwise PROD": (_input("a", 4, 10) + _input("b", 4, 10)
                     + 'layer { name: "l" type: "Eltwise" bottom: "a" '
                     'bottom: "b" top: "y" eltwise_param { operation: PROD '
                     '} }'),
    "Eltwise MAX": (_input("a", 4, 10) + _input("b", 4, 10)
                    + 'layer { name: "l" type: "Eltwise" bottom: "a" '
                    'bottom: "b" top: "y" eltwise_param { operation: MAX '
                    '} }'),
    "Flatten": (_input("x", 2, 3, 4, 5)
                + 'layer { name: "l" type: "Flatten" bottom: "x" top: "y" }'),
    "Split": (_input("x", 4, 10)
              + 'layer { name: "l" type: "Split" bottom: "x" top: "y" '
              'top: "z" }'),
    "MultiHeadAttention": (_input("x", 128, 2, 16)
                           + 'layer { name: "l" type: "MultiHeadAttention" '
                           'bottom: "x" top: "y" attention_param { '
                           'num_heads: 2 head_dim: 8 causal: true '
                           f'{GAUSS} }} }}'),
    "Softmax": (_input("x", 4, 10)
                + 'layer { name: "l" type: "Softmax" bottom: "x" top: "y" }'),
    "SoftmaxWithLoss": (_input("x", 4, 10) + _input("label", 4)
                        + 'layer { name: "l" type: "SoftmaxWithLoss" '
                        'bottom: "x" bottom: "label" top: "y" }'),
    "Accuracy": (_input("x", 8, 10) + _input("label", 8)
                 + 'layer { name: "l" type: "Accuracy" bottom: "x" '
                 'bottom: "label" top: "y" accuracy_param { top_k: 2 } }'),
}
INDEX_RANGE = {"ids": 200, "label": 10}


def _inputs(net, seed):
    rng = np.random.RandomState(seed)
    return {name: (rng.randint(0, INDEX_RANGE[name], shape).astype(
                       np.float32) if name in INDEX_RANGE
                   else rng.randn(*shape).astype(np.float32))
            for name, shape, _ in net.input_specs}


def _close(got: torch.Tensor, want, what, rtol=BF16_RTOL, atol=BF16_ATOL):
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.detach().float().numpy()
    np.testing.assert_allclose(
        g, w, rtol=rtol, atol=atol * max(float(np.abs(w).max()), 1e-30),
        err_msg=what)


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_in_bf16_matches_jax_compute_dtype(case, monkeypatch):
    """Each ported layer type under compute_dtype=bfloat16: each top's
    dtype is the JAX package's, its value within the bf16 tolerance,
    and the f32 params' gradients of sum(top · cotangent) too."""
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")   # JAX MHA: its kernel
    text = LAYERS[case]
    tnet = Net(NetParameter.from_text(text), NetState(phase=Phase.TEST),
               device="cpu", compute_dtype=BF16)
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=JaxPhase.TEST),
                  compute_dtype=jnp.bfloat16)
    params = {ln: {bn: t.detach().clone().requires_grad_(True)
                   for bn, t in bl.items()}
              for ln, bl in tnet.init(3).items()}
    jp = {ln: {bn: jnp.array(np.array(t.detach().numpy()))
               for bn, t in bl.items()} for ln, bl in params.items()}
    x = _inputs(tnet, 5)
    tops = [t for lp in tnet.compute_layers for t in lp.top]
    rng = np.random.RandomState(7)

    def jax_fwd(p):
        blobs, _ = jnet.apply(p, {k: jnp.asarray(v) for k, v in x.items()},
                              train=False)
        return blobs

    jblobs = jax.jit(jax_fwd)(jp)
    tblobs = tnet(params, {k: torch.from_numpy(v) for k, v in x.items()})
    cot = {}
    for name in tops:
        assert str(tblobs[name].dtype).replace("torch.", "") \
            == jnp.dtype(jblobs[name].dtype).name, name
        assert tblobs[name].dtype == BF16, name
        _close(tblobs[name], jblobs[name], f"{case} top {name}")
        cot[name] = np.asarray(rng.randn(*tblobs[name].shape), np.float32)
    if not params:
        return

    def jax_obj(p):
        b = jax_fwd(p)
        return sum(jnp.sum(b[n].astype(jnp.float32) * cot[n]) for n in tops)

    jg = jax.jit(jax.grad(jax_obj))(jp)
    obj = sum(torch.sum(tblobs[n].float() * torch.from_numpy(cot[n]))
              for n in tops)
    leaves = [params[ln][bn] for ln in params for bn in params[ln]]
    grads = torch.autograd.grad(obj, leaves)
    for (ln, bn), g in zip([(ln, bn) for ln in params for bn in params[ln]],
                           grads):
        assert g.dtype == torch.float32        # through the cast, in f32
        _close(g, jg[ln][bn], f"{case} grad {ln}/{bn}", atol=2.0 ** -6)


def test_dropout_at_train_keeps_bf16():
    """Dropout at TRAIN under compute_dtype=bfloat16: the top is bf16 in
    both packages (the random streams differ), every kept element is
    x / keep rounded to bf16 once, with keep itself taken in bf16 as
    JAX's weak typing takes it, and the rest 0, in both."""
    text = LAYERS["Dropout"]
    x = np.random.RandomState(6).randn(64, 10).astype(np.float32)
    text = text.replace("dim: 4 dim: 10", "dim: 64 dim: 10")
    tnet = Net(NetParameter.from_text(text), NetState(phase=Phase.TRAIN),
               device="cpu", compute_dtype=BF16)
    got = tnet({}, {"x": torch.from_numpy(x)}, train=True,
               generator=torch.Generator().manual_seed(0))["y"]
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=JaxPhase.TRAIN),
                  compute_dtype=jnp.bfloat16)
    want = jnet.apply({}, {"x": jnp.asarray(x)}, train=True,
                      rng=jax.random.key(0))[0]["y"]
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    # keep = 0.7 is weakly typed beside bf16: bf16(0.7) = 0.69921875
    scaled = (torch.from_numpy(x).to(BF16).float() / 0.69921875).to(
        BF16).float().numpy()
    for top in (got.float().numpy(),
                np.asarray(want.astype(jnp.float32))):
        kept = top != 0
        assert 0.5 < kept.mean() < 0.9
        np.testing.assert_array_equal(top[kept], scaled[kept])


@pytest.mark.parametrize("relu", [False, True])
def test_lrn_in_bf16_matches_the_pallas_kernel(relu):
    """The LRN layer in a bf16 net (K1's plain version here: bf16 I/O,
    f32 math) against the Pallas kernel in interpret mode on the same
    bf16 input (bf16 I/O, f32 math inside, as on the TPU): one bf16
    rounding of the same f32 value, so one ulp."""
    text = (_input("x", 2, 16, 5, 5)
            + 'layer { name: "l" type: "LRN" bottom: "x" top: "y" '
            'lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 k: 2 } }')
    net = Net(NetParameter.from_text(text), NetState(phase=Phase.TEST),
              device="cpu", compute_dtype=BF16)
    x = np.random.RandomState(2).randn(2, 16, 5, 5).astype(np.float32) * 3
    xb = torch.from_numpy(x).to(BF16)
    if relu:
        got = K.lrn_across_channels(xb, 5, 0.5, 0.75, 2.0, fuse_relu=True)
    else:
        got = net({}, {"x": torch.from_numpy(x)})["y"]
    assert got.dtype == BF16
    want = jax.jit(lambda v: jax_lrn(v, 5, 0.5, 0.75, 2.0, interpret=True,
                                     fuse_relu=relu))(
        jnp.asarray(x).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    _close(got, want, "lrn", rtol=2.0 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# index bottoms: the one departure from the reference
# ---------------------------------------------------------------------------

EMBED_NET = (_input("ids", 1, 4) + 'layer { name: "l" type: "Embed" '
             'bottom: "ids" top: "y" embed_param { input_dim: 1000 '
             'num_output: 4 bias_term: false weight_filler { type: '
             '"gaussian" std: 1 } } }')
LOSS_NET = (_input("x", 4, 1000) + _input("label", 4)
            + 'layer { name: "l" type: "SoftmaxWithLoss" bottom: "x" '
            'bottom: "label" top: "y" }')


@pytest.mark.parametrize("ids,agree", [([3, 100, 255, 256], True),
                                       ([3, 257, 511, 999], False)])
def test_index_bottoms_keep_their_value(ids, agree):
    """Mixed precision with Embed ids / SoftmaxWithLoss labels in
    0-1000: the port reads every id's own row and label, the JAX package
    rounds them through bf16 (257 -> 256, 511 -> 512, 999 -> 1000, past
    the table).  At ids up to 256 the two agree."""
    tnet = Net(NetParameter.from_text(EMBED_NET), NetState(phase=Phase.TEST),
               device="cpu", compute_dtype=BF16)
    assert tnet.index_inputs == frozenset({"ids"})
    table = tnet.init(0)["l"]["weight"]
    x = np.asarray([ids], np.float32)
    got = tnet(tnet.init(0), {"ids": torch.from_numpy(x)})["y"][0]
    want_rows = table[torch.tensor(ids)].to(BF16)
    assert torch.equal(got, want_rows)          # every id its own row
    jnet = JaxNet(JaxNetParameter.from_text(EMBED_NET),
                  JaxNetState(phase=JaxPhase.TEST),
                  compute_dtype=jnp.bfloat16)
    jt = {"l": {"weight": jnp.asarray(table.numpy())}}
    jgot = np.asarray(jnet.apply(jt, {"ids": jnp.asarray(x)})[0]["y"][0]
                      .astype(jnp.float32))
    assert np.array_equal(jgot, got.float().numpy()) == agree
    if not agree:
        rounded = [int(v) for v in np.asarray(
            jnp.asarray(ids, jnp.float32).astype(jnp.bfloat16)
            .astype(jnp.float32))]
        assert rounded == [3, 256, 512, 1000]
        for i, r in enumerate(rounded):
            if r < 1000:     # the JAX package's row is the rounded id's
                assert np.array_equal(
                    jgot[i], table[r].to(BF16).float().numpy())

    lnet = Net(NetParameter.from_text(LOSS_NET), NetState(phase=Phase.TEST),
               device="cpu", compute_dtype=BF16)
    assert lnet.index_inputs == frozenset({"label"})
    scores = np.random.RandomState(1).randn(4, 1000).astype(np.float32)
    lbl = np.asarray(ids, np.float32)
    tl = lnet({}, {"x": torch.from_numpy(scores),
                   "label": torch.from_numpy(lbl)})["y"]
    sb = torch.from_numpy(scores).to(BF16)
    want = -torch.log_softmax(sb, 1)[torch.arange(4),
                                     torch.tensor(ids)].sum() / 4
    assert float(tl) == pytest.approx(float(want), rel=2.0 ** -7)
    jl = JaxNet(JaxNetParameter.from_text(LOSS_NET),
                JaxNetState(phase=JaxPhase.TEST), compute_dtype=jnp.bfloat16)
    jloss = float(jl.apply({}, {"x": jnp.asarray(scores),
                                "label": jnp.asarray(lbl)})[0]["y"]
                  .astype(jnp.float32))
    assert (abs(jloss - float(tl)) <= 2.0 ** -6 * abs(float(tl))) == agree


# ---------------------------------------------------------------------------
# the solver: dtypes and the promotion rule
# ---------------------------------------------------------------------------

NET = (_input("data", 8, 12) + _input("label", 8)
       + 'layer { name: "ip1" type: "InnerProduct" bottom: "data" '
       'top: "ip1" inner_product_param { num_output: 16 '
       'weight_filler { type: "xavier" } bias_filler { type: "constant" '
       'value: 0.1 } } }\n'
       'layer { name: "relu" type: "ReLU" bottom: "ip1" top: "ip1" }\n'
       'layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2" '
       'param { lr_mult: 1 } param { lr_mult: 2 decay_mult: 0 } '
       'inner_product_param { num_output: 10 weight_filler { type: '
       '"xavier" } } }\n'
       'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" '
       'bottom: "label" top: "loss" }')
SOLVER = ('base_lr: 0.05 momentum: 0.9 momentum2: 0.999 delta: 1e-6 '
          'rms_decay: 0.95 weight_decay: 0.0005 lr_policy: "fixed" '
          'max_iter: 10 random_seed: 1 type: "{}"')
TYPES = ("SGD", "Nesterov", "AdaGrad", "RMSProp", "AdaDelta", "Adam")


def _solvers(stype, dtype, state_env, monkeypatch):
    if state_env:
        monkeypatch.setenv("COS_STATE_DTYPE", "bfloat16")
    text = SOLVER.format(stype)
    ts = Solver(SolverParameter.from_text(text), NetParameter.from_text(NET),
                dtype=dtype, device="cpu")
    js = JaxSolver(JaxSolverParameter.from_text(text),
                   JaxNetParameter.from_text(NET),
                   dtype=jnp.bfloat16 if dtype == BF16 else jnp.float32)
    return ts, js


def _to_jax(tree):
    """A copy (a CPU jax array may alias the numpy buffer of a tensor
    that the port then updates in place)."""
    return {ln: {bn: jnp.array(np.array(t.float().numpy())).astype(
        jnp.bfloat16 if t.dtype == BF16 else jnp.float32)
        for bn, t in bl.items()} for ln, bl in tree.items()}


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16 if x.dtype == BF16
                               else torch.int32).numpy().tobytes()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32).tobytes()


@pytest.mark.parametrize("state_env", [False, True],
                         ids=["bf16-params", "COS_STATE_DTYPE"])
@pytest.mark.parametrize("stype", TYPES)
def test_update_rule_mirrors_jax_promotion(stype, state_env, monkeypatch):
    """`apply_update` against the JAX package's `_apply_update` on the
    same params, gradients and (nonzero) history, lr f32: bf16 params
    (-dtype bfloat16) or f32 params with COS_STATE_DTYPE=bfloat16 (bf16
    history for SGD / Nesterov; ignored for the second-moment types).
    The JAX side compiles with XLA's excess precision off
    (`xla_allow_excess_precision`), so that each bf16 op rounds as the
    program says.  Each blob and history keeps its dtype.  With bf16
    params every solver type is bit-equal to JAX.  With f32 params XLA's
    CPU backend still contracts a multiply-add into one FMA (one
    rounding where the program has two), so those hold to 2^-20 of the
    blob's largest element and the bf16 history to one bf16 ulp."""
    dtype = torch.float32 if state_env else BF16
    ts, js = _solvers(stype, dtype, state_env, monkeypatch)
    want_state = (BF16 if state_env and stype in ("SGD", "Nesterov")
                  else None)
    assert ts.state_dtype == want_state
    rng = np.random.RandomState(11)
    params, state = ts.init()
    hdt = want_state or dtype
    for tree in (state.history, state.history2):
        for bl in tree.values():
            for bn in bl:
                bl[bn] = torch.from_numpy(
                    np.abs(rng.randn(*bl[bn].shape)).astype(np.float32)
                    * 1e-2).to(hdt)
    grads = {ln: {bn: torch.from_numpy(
        rng.randn(*t.shape).astype(np.float32) * 0.3).to(dtype)
        for bn, t in bl.items()} for ln, bl in params.items()}
    state.iter = 3
    jp, jg = _to_jax(params), _to_jax(grads)
    from caffeonspark_tpu.solver import OptState as JaxOptState
    jst = JaxOptState(iter=jnp.asarray(3, jnp.int32),
                      history=_to_jax(state.history),
                      history2=_to_jax(state.history2))
    lr = jnp.asarray(0.05, jnp.float32)
    np2, nst = jax.jit(js._apply_update).lower(jp, jg, jst, lr).compile(
        compiler_options={"xla_allow_excess_precision": False})(
            jp, jg, jst, lr)
    ts.apply_update(params, grads, state, torch.tensor(0.05))
    exact = dtype == BF16
    for ln, bl in params.items():
        for bn, w in bl.items():
            assert w.dtype == dtype
            pairs = [(w, np2[ln][bn], "param"),
                     (state.history[ln][bn], nst.history[ln][bn],
                      "history")]
            if stype in ("AdaDelta", "Adam"):
                pairs.append((state.history2[ln][bn],
                              nst.history2[ln][bn], "history2"))
            for got, want, what in pairs:
                assert got.dtype == hdt or what == "param"
                if exact:
                    assert _bytes(got) == _bytes(want), f"{ln}/{bn} {what}"
                elif got.dtype == BF16:
                    _close(got, want, f"{stype} {ln}/{bn} {what}",
                           rtol=2.0 ** -7, atol=0)
                else:
                    _close(got, want, f"{stype} {ln}/{bn} {what}",
                           rtol=2.0 ** -20, atol=2.0 ** -20)


@pytest.mark.parametrize("stype", TYPES)
def test_bf16_solver_step_matches_jax(stype, monkeypatch):
    """One whole step (forward, backward, update) of each solver type
    with bf16 params and compute (-dtype bfloat16) from the same params
    and batch: loss within one bf16 ulp, params within two of their
    largest element (the gradients round at other points)."""
    ts, js = _solvers(stype, BF16, False, monkeypatch)
    params, state = ts.init()
    jp = _to_jax(params)
    jst = js.init_state(jp)
    rng = np.random.RandomState(4)
    x = rng.rand(8, 12).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)
    loss, _ = ts.train_step(params, state,
                            {"data": torch.from_numpy(x).to(BF16),
                             "label": torch.from_numpy(y)})
    jp, jst, out = jax.jit(js.train_step_fn())(
        jp, jst, {"data": jnp.asarray(x).astype(jnp.bfloat16),
                  "label": jnp.asarray(y).astype(jnp.bfloat16)},
        js.step_rng(0))
    assert float(loss) == pytest.approx(float(out["loss"]), rel=2.0 ** -7)
    for ln, bl in params.items():
        for bn, w in bl.items():
            assert w.dtype == BF16 and state.history[ln][bn].dtype == BF16
            _close(w, jp[ln][bn], f"{stype} {ln}/{bn}", rtol=0,
                   atol=2.0 ** -6)


def test_state_dtype_knob_is_checked(monkeypatch):
    monkeypatch.setenv("COS_STATE_DTYPE", "int8")
    with pytest.raises(ValueError, match="COS_STATE_DTYPE"):
        Solver(SolverParameter.from_text(SOLVER.format("SGD")),
               NetParameter.from_text(NET), device="cpu")


def test_solver_pins_bf16_reduction_off():
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    Solver(SolverParameter.from_text(SOLVER.format("SGD")),
           NetParameter.from_text(NET), device="cpu")
    assert not \
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_bf16_snapshot_roundtrip_and_bf16_state_resume(tmp_path,
                                                       monkeypatch):
    """bf16 params go to the .caffemodel as f32 (the exact widening) and
    come back in the net's dtype, bit-equal; a COS_STATE_DTYPE=bfloat16
    resume of an f32 net keeps its momentum in bf16, bit-equal."""
    ts = Solver(SolverParameter.from_text(SOLVER.format("SGD")),
                NetParameter.from_text(NET), dtype=BF16, device="cpu")
    params, state = ts.init()
    state.history["ip1"]["weight"].normal_()
    m, s = checkpoint.snapshot(ts.train_net, params, state,
                               str(tmp_path / "b"))
    blobs = checkpoint.load_caffemodel_blobs(m)
    assert blobs["ip1"][0].dtype == np.float32
    assert np.array_equal(blobs["ip1"][0],
                          params["ip1"]["weight"].float().numpy())
    p2, st2 = checkpoint.restore(ts.train_net, *ts.init(), s)
    for ln, bl in params.items():
        for bn, w in bl.items():
            assert p2[ln][bn].dtype == BF16 and torch.equal(p2[ln][bn], w)
            assert torch.equal(st2.history[ln][bn], state.history[ln][bn])

    monkeypatch.setenv("COS_STATE_DTYPE", "bfloat16")
    fs = Solver(SolverParameter.from_text(SOLVER.format("SGD")),
                NetParameter.from_text(NET), device="cpu")
    fp, fst = fs.init()
    for bl in fst.history.values():
        for t in bl.values():
            assert t.dtype == BF16
            t.normal_()
    fst.iter = 4
    _, s = checkpoint.snapshot(fs.train_net, fp, fst, str(tmp_path / "f"))
    p3, st3 = checkpoint.restore(fs.train_net, *fs.init(), s)
    assert st3.iter == 4
    for ln, bl in fst.history.items():
        for bn, h in bl.items():
            assert st3.history[ln][bn].dtype == BF16
            assert torch.equal(st3.history[ln][bn], h)
            assert p3[ln][bn].dtype == torch.float32
