"""The port at head widths above 256 against the JAX package: the flash
kernels' plain versions (K6, K7, K8) and K9's at D 320 and 512, the
MultiHeadAttention layer with `head_dim: 512`, one solver step of the
zoo's transformer_lm whose head is 512 wide, and the launch check of the
wide kernels.

On the card K6-K9 run their wide kernels above D 256 (the `_wide` entry
points of csrc/flash_attn.cu); on the CPU the wrappers run the plain
versions these tests hold against the JAX side, which runs its Pallas
flash kernels in interpret mode (jitted, as tests/test_torch_ring.py
runs them).  tests/test_torch_cuda.py and chip_smoke.py hold the wide
kernels against the same plain versions on the card.

Tolerances are those of tests/test_torch_attention.py and
tests/test_torch_head256.py: forward FWD_TOL 2e-5 (rtol and atol),
gradients GRAD_RTOL 2e-4 / GRAD_ATOL 1e-5, K9's carry rtol 1e-5 (atol
1e-6 of the largest finite element, as tests/test_torch_ring.py), weight
gradients of the layer to 1e-5 of their largest element; the LM step's
loss to rtol 1e-5 and each gradient to 1e-4 of its largest element.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.ops import pallas_kernels as PK
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.ops import kernels as K
from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
CARRY_RTOL, CARRY_ATOL_OF_MAX = 1e-5, 1e-6
WIDE_DS = [320, 512]


def _rand(shape, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _close_of_max(got, want, frac, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= frac * float(np.abs(want).max()), (msg, err)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _pallas_fwd(causal):
    return jax.jit(lambda q, k, v: PK._flash_fwd_call(
        q, k, v, 1.0 / math.sqrt(q.shape[-1]), causal, 128, 128, True))


@functools.lru_cache(maxsize=None)
def _pallas_bwd(causal):
    return jax.jit(functools.partial(PK.flash_bwd_block, causal=causal,
                                     block_q=128, block_k=128,
                                     interpret=True))


# ---------------------------------------------------------------------------
# K6 / K7 / K8 plain versions at D 320 and 512
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", WIDE_DS)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_plain_matches_pallas_wide(causal, d):
    """flash_attention_plain's O and lse (and the routed wrapper's, which
    takes it for a CPU tensor) against `_flash_fwd_call` in interpret
    mode at a head width the wide kernels take."""
    bh, t = 2, 128
    q, k, v = _rand((bh, t, d), d)
    o_j, lse_j = _pallas_fwd(causal)(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    o_t, lse_t = K.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    _close(o_t, o_j, FWD_TOL, FWD_TOL, "O")
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL, "lse")
    before = dict(K.launch_counts)
    o_w, lse_w = K.flash_attention_fwd(_t(q), _t(k), _t(v), causal)
    assert K.launch_counts == before            # the plain version ran
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)


@pytest.mark.parametrize("d", WIDE_DS)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_block_plain_matches_pallas_wide(causal, d):
    """K7 + K8's plain versions (and the routed `flash_bwd_block`)
    against the Pallas `flash_bwd_block` in interpret mode on the same
    lse and delta, at D 320 and 512."""
    bh, t = 2, 128
    q, k, v, do = _rand((bh, t, d), d + 1, n=4)
    o, lse = _pallas_fwd(causal)(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    delta = np.sum(do * np.asarray(o), axis=-1)
    want = _pallas_bwd(causal)(*(jnp.asarray(a) for a in
                                 (q, k, v, do, np.asarray(lse), delta)))
    args = [_t(a) for a in (q, k, v, do, np.asarray(lse), delta)]
    plain = K.flash_bwd_block_plain(*args, causal=causal)
    routed = K.flash_bwd_block(*args, causal=causal)
    for name, w, p, r in zip(("dq", "dk", "dv"), want, plain, routed):
        _close(p, w, GRAD_RTOL, GRAD_ATOL, name)
        assert torch.equal(p, r), name


# ---------------------------------------------------------------------------
# K9's plain version at D 320 and 512
# ---------------------------------------------------------------------------

K9_BH, K9_T = 2, 128


def _carry(kind, d, seed):
    """The ring's first carry (-inf, 0, 0), or one from earlier hops with
    rows 0 and 5 left at -1e30 by a hop whose keys they could not see."""
    shape = (K9_BH, K9_T)
    if kind == "first":
        return (np.full(shape, -np.inf, np.float32),
                np.zeros(shape, np.float32),
                np.zeros(shape + (d,), np.float32))
    rng = np.random.RandomState(seed)
    m = (rng.randn(*shape) * 0.5 + 2.0).astype(np.float32)
    l = rng.uniform(1.0, 5.0, shape).astype(np.float32)
    acc = rng.randn(*shape, d).astype(np.float32)
    m[:, [0, 5]] = -1e30
    l[:, [0, 5]] = 0.0
    acc[:, [0, 5]] = 0.0
    return m, l, acc


@functools.lru_cache(maxsize=None)
def _pallas_hop():
    return jax.jit(functools.partial(
        PK.flash_block_update, causal=True, block_q=K9_T, block_k=K9_T,
        interpret=True))


@pytest.mark.parametrize("carry", ["first", "mid"])
@pytest.mark.parametrize("q_off,k_off", [(K9_T, K9_T), (3 * K9_T, 0)],
                         ids=["diagonal", "full"])
@pytest.mark.parametrize("d", WIDE_DS)
def test_flash_block_update_plain_matches_pallas_wide(d, q_off, k_off,
                                                      carry):
    """K9's plain version (through its wrapper) against the Pallas
    `flash_block_update` in interpret mode on a diagonal and a fully
    visible causal hop at D 320 and 512: the same (m', l', acc')."""
    rng = np.random.RandomState(d + q_off)
    q, k, v = (rng.randn(K9_BH, K9_T, d).astype(np.float32)
               for _ in range(3))
    c = _carry(carry, d, d)
    want = _pallas_hop()(*(jnp.asarray(x) for x in (q, k, v) + c), q_off,
                         k_off)
    before = dict(K.launch_counts)
    got = K.flash_block_update(*(torch.from_numpy(x) for x in (q, k, v) + c),
                               q_off, k_off, True)
    assert K.launch_counts == before             # the plain version ran
    for name, g, w in zip(("m", "l", "acc"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        w = np.asarray(w)
        scale = float(np.abs(w[np.isfinite(w)]).max(initial=0.0))
        _close(g.numpy(), w, CARRY_RTOL,
               CARRY_ATOL_OF_MAX * min(scale, 1e29), name)


# ---------------------------------------------------------------------------
# the wide kernels' launch check and routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [257, 320, 512, 1000, 1024])
def test_wide_launch_check_takes_any_head_dim(d):
    """`_check_flash_wide` takes D 257..1024 (it has no limit on D), and
    the flash wrappers route every D above FLASH_MAX_D to the `_wide`
    entry points with it, D up to 256 to the padded-width ones."""
    x = torch.zeros(2, 8, d)
    stats = torch.zeros(2, 8)
    K._check_flash_wide("f", x, x, x, x, stats=(stats, stats))
    with pytest.raises(ValueError, match=f"head dim {d} > 256"):
        K._check_flash("f", x, x, x, x, stats=(stats, stats))
    assert K._flash_route(x, "cos_flash_fwd") == ("cos_flash_fwd_wide",
                                                  K._check_flash_wide)
    narrow = torch.zeros(2, 8, 256)
    assert K._flash_route(narrow, "cos_flash_block_update") == (
        "cos_flash_block_update", K._check_flash)


@pytest.mark.parametrize("case", [
    "shape", "dtype", "device", "contiguous", "stats", "rank", "half"])
def test_wide_launch_check_refuses_mismatched_operands(case):
    """The wide check keeps every operand rule of the padded-width one:
    one shape, dtype and device, contiguous, f32 row statistics, a
    non-empty (B*H, T, D) in f32 or bf16."""
    x = torch.zeros(2, 8, 320)
    stats = torch.zeros(2, 8)
    args, kw, msg = {
        "shape": ((x, torch.zeros(2, 8, 512)), {}, "does not match"),
        "dtype": ((x, x.bfloat16()), {}, "does not match"),
        "device": ((x, torch.zeros(2, 8, 320, device="meta")), {},
                   "does not match"),
        "contiguous": ((x, torch.zeros(2, 320, 8).transpose(1, 2)), {},
                       "contiguous"),
        "stats": ((x,), {"stats": (stats.bfloat16(),)}, "row statistics"),
        "rank": ((torch.zeros(2, 8, 320, 1),), {}, "non-empty"),
        "half": ((x.half(),), {}, "dtype"),
    }[case]
    with pytest.raises(ValueError, match=msg):
        K._check_flash_wide("f", *args, **kw)


# ---------------------------------------------------------------------------
# the layer and the LM step
# ---------------------------------------------------------------------------

MHA_NET = """
name: "mha"
layer {{ name: "in" type: "Input" top: "x"
  input_param {{ shape {{ dim: {t} dim: {b} dim: {dm} }} }} }}
layer {{ name: "attn" type: "MultiHeadAttention" bottom: "x" top: "attn"
  attention_param {{ num_heads: {h} head_dim: {hd} causal: {causal} }} }}
"""


@pytest.mark.parametrize("causal", [True, False])
def test_multihead_attention_matches_jax_through_pallas_head512(
        causal, monkeypatch):
    """The MultiHeadAttention layer with head_dim 512 at T=128 against
    the JAX `_mha` through its Pallas flash kernels in interpret mode
    (COS_FLASH_INTERPRET=1): the output, and the gradients of
    sum(sin(out)) with respect to W_qkv, W_o (1e-5 of their largest
    element) and the input."""
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    t, b, h, hd, dm = 128, 1, 1, 512, 16
    text = MHA_NET.format(t=t, b=b, dm=dm, h=h, hd=hd,
                          causal=str(causal).lower())
    jnet = JaxNet(JaxNetParameter.from_text(text))
    tnet = Net(NetParameter.from_text(text), device="cpu")
    rng = np.random.RandomState(3)
    arrays = {ln: {bn: (rng.randn(*shape) * 0.05).astype(np.float32)
                   for bn, shape, _ in specs}
              for ln, specs in tnet.param_layout.items()}
    assert 3 * h * hd in arrays["attn"]["W_qkv"].shape
    x = np.random.RandomState(4).randn(t, b, dm).astype(np.float32)

    @jax.jit
    def grads_j(p, x):
        def loss_j(p, x):
            blobs, _ = jnet.apply(p, {"x": x}, train=True)
            return jnp.sum(jnp.sin(blobs["attn"])), blobs["attn"]
        return jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(p, x)
    (_, out_j), (gp_j, gx_j) = grads_j(
        {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
         for ln, bl in arrays.items()}, jnp.asarray(x))

    tp = convert.params_from_numpy(tnet, arrays)
    leaves = [tp["attn"]["W_qkv"].requires_grad_(True),
              tp["attn"]["W_o"].requires_grad_(True)]
    xt = _t(x).requires_grad_(True)
    out_t = tnet(tp, {"x": xt})["attn"]
    torch.sin(out_t).sum().backward()
    _close(out_t.detach(), out_j, FWD_TOL, FWD_TOL, "out")
    _close_of_max(leaves[0].grad, gp_j["attn"]["W_qkv"], 1e-5, "W_qkv")
    _close_of_max(leaves[1].grad, gp_j["attn"]["W_o"], 1e-5, "W_o")
    _close(xt.grad, gx_j, GRAD_RTOL, GRAD_ATOL, "x")


LM = dict(vocab=16, d_model=512, heads=1, layers=1, seq=128, batch=2)
ADAM = ('type: "Adam" base_lr: 0.001 momentum: 0.9 momentum2: 0.999 '
        'delta: 1e-8 lr_policy: "fixed" random_seed: 1')


def test_lm_solver_step_matches_jax_head512(monkeypatch):
    """One solver step of transformer_lm(d_model 512, 1 head: head_dim
    512, vocab 16, T 128, batch 2): loss (rtol 1e-5) and every gradient
    (1e-4 of its largest element) of the port against the JAX solver
    (Pallas flash kernels in interpret mode) on the same params and
    batch."""
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    npm = zoo.transformer_lm(**LM)
    assert "head_dim: 512" in npm.to_text()
    text = npm.to_text()
    jsolver = JaxSolver(JaxSolverParameter.from_text(ADAM),
                        JaxNetParameter.from_text(text))
    tsolver = Solver(SolverParameter.from_text(ADAM),
                     NetParameter.from_text(text), device="cpu")
    net = tsolver.train_net
    arrays = convert.params_to_numpy(net.init(7))
    rng = np.random.RandomState(8)
    batch = {k: rng.randint(0, LM["vocab"], (LM["seq"], LM["batch"]))
             .astype(np.float32)
             for k in ("input_sentence", "target_sentence")}
    jp = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
          for ln, bl in arrays.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jsolver.train_net.loss(p, b), has_aux=True))(jp, jbatch)
    tp = convert.params_from_numpy(net, arrays)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, _, tgrads = tsolver.loss_and_grads(tp, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert abs(float(tloss) - np.log(LM["vocab"])) < 0.5
    for ln, bl in tgrads.items():
        for bn, g in bl.items():
            want = np.asarray(jgrads[ln][bn])
            err = float(np.abs(g.numpy() - want).max())
            assert err <= 1e-4 * float(np.abs(want).max()), (ln, bn, err)
