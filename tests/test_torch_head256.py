"""The port at head_dim 256 against the JAX package: the flash kernels'
plain versions (K6, K7, K8) at D 256 and at a ragged D of 200, the
MultiHeadAttention layer with `head_dim: 256`, and one solver step of
the zoo's transformer_lm whose heads are 256 wide.

The CUDA kernels take any D up to 256 on the card (D in 129..256 runs
the kernels' 256-wide tiles, zero-padded); on the CPU the wrappers run
the plain versions these tests hold against the JAX side, which runs its
Pallas flash kernels in interpret mode (as tests/test_pallas.py runs
them).  tests/test_torch_cuda.py and chip_smoke.py hold the kernels
against the same plain versions on the card.

Tolerances are those of tests/test_torch_attention.py: forward rtol/atol
2e-5, gradients rtol 2e-4 / atol 1e-5, weight gradients of the layer to
1e-5 of their largest element; the LM step's loss to rtol 1e-5 and each
gradient to 1e-4 of its largest element, as tests/test_torch_lm_train.py
holds the 16-wide heads.
"""

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


# ---------------------------------------------------------------------------
# K6 / K7 / K8 plain versions at D 256 and 200
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_plain_matches_pallas_wide_heads(causal, d):
    """flash_attention_plain's O and lse against `_flash_fwd_call` in
    interpret mode at a head width the kernels pad to 256."""
    bh, t = 3, 256
    q, k, v = _rand((bh, t, d), d)
    o_j, lse_j = PK._flash_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 1.0 / math.sqrt(d),
                                    causal, 128, 128, True)
    o_t, lse_t = K.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    _close(o_t, o_j, FWD_TOL, FWD_TOL, "O")
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL, "lse")
    o_w, lse_w = K.flash_attention_fwd(_t(q), _t(k), _t(v), causal)
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)


@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_block_plain_matches_pallas_wide_heads(causal, d):
    """K7 + K8's plain versions (and the routed `flash_bwd_block`)
    against the Pallas `flash_bwd_block` in interpret mode on the same
    lse and delta, at D 256 and 200."""
    bh, t = 2, 256
    q, k, v, do = _rand((bh, t, d), d + 1, n=4)
    o, lse = PK._flash_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 1.0 / math.sqrt(d), causal,
                                128, 128, True)
    delta = np.sum(do * np.asarray(o), axis=-1)
    want = PK.flash_bwd_block(*(jnp.asarray(a) for a in
                                (q, k, v, do, np.asarray(lse), delta)),
                              causal=causal, block_q=128, block_k=128,
                              interpret=True)
    args = [_t(a) for a in (q, k, v, do, np.asarray(lse), delta)]
    plain = K.flash_bwd_block_plain(*args, causal=causal)
    routed = K.flash_bwd_block(*args, causal=causal)
    for name, w, p, r in zip(("dq", "dk", "dv"), want, plain, routed):
        _close(p, w, GRAD_RTOL, GRAD_ATOL, name)
        assert torch.equal(p, r), name


def test_flash_wrappers_take_head_dim_256_and_refuse_257():
    """The padded-width kernels' launch check (`_check_flash`) takes D up
    to 256 (their widest padded width) and refuses 257 by name, for every
    flash wrapper; the wrappers send D > 256 to the wide kernels and
    their own check (tests/test_torch_wide_heads.py)."""
    x = torch.zeros(2, 8, 256)
    stats = torch.zeros(2, 8)
    K._check_flash("f", x, x, x, x, stats=(stats, stats))
    wide = torch.zeros(2, 8, 257)
    with pytest.raises(ValueError, match="head dim 257 > 256"):
        K._check_flash("flash_attention_fwd", wide, wide, wide)
    with pytest.raises(ValueError, match="head dim 257 > 256"):
        K._check_flash("flash_block_update", wide,
                       stats=(stats, stats))


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
def test_multihead_attention_matches_jax_through_pallas_head256(
        causal, monkeypatch):
    """The MultiHeadAttention layer with head_dim 256 at T=128 against
    the JAX `_mha` through its Pallas flash kernels in interpret mode
    (COS_FLASH_INTERPRET=1): the output, and the gradients of
    sum(sin(out)) with respect to W_qkv, W_o (1e-5 of their largest
    element) and the input."""
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    t, b, h, hd, dm = 128, 2, 2, 256, 24
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

    def loss_j(p, x):
        blobs, _ = jnet.apply(p, {"x": x}, train=True)
        return jnp.sum(jnp.sin(blobs["attn"])), blobs["attn"]
    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
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


LM = dict(vocab=16, d_model=512, heads=2, layers=1, seq=128, batch=2)
ADAM = ('type: "Adam" base_lr: 0.001 momentum: 0.9 momentum2: 0.999 '
        'delta: 1e-8 lr_policy: "fixed" random_seed: 1')


def test_lm_solver_step_matches_jax_head256(monkeypatch):
    """One Adam step of transformer_lm(d_model 512, 2 heads: head_dim
    256, vocab 16, T 128, batch 2): loss (rtol 1e-5) and every gradient
    (1e-4 of its largest element) of the port against the JAX solver
    (Pallas flash kernels in interpret mode) on the same params and
    batch, then the updated params (rtol 1e-4, atol 1e-6)."""
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    npm = zoo.transformer_lm(**LM)
    assert "head_dim: 256" in npm.to_text()
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
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jsolver.train_net.loss(p, jbatch), has_aux=True)(jp)
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

    jp2, _, jout = jsolver.train_step_fn()(jp, jsolver.init_state(jp),
                                           jbatch, jsolver.step_rng(0))
    loss, _ = tsolver.train_step(tp, tsolver.init_state(tp), tbatch)
    np.testing.assert_allclose(float(loss), float(jout["loss"]), rtol=1e-5)
    for ln, bl in tp.items():
        for bn, w in bl.items():
            np.testing.assert_allclose(w.numpy(), np.asarray(jp2[ln][bn]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{ln}/{bn}")
