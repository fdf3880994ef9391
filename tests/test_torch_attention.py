"""The PyTorch port's attention path against the JAX package: the flash
kernels' plain versions (K6, K7, K8) and their autograd Function, the
MultiHeadAttention, Embed and Eltwise layers, and CoSData's input specs.

On the CPU the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode (as tests/test_pallas.py runs
them), or its einsum reference `parallel.sp.attention`.  Inputs and
parameters are made with numpy from a seed and move as numpy.

Tolerances (tests/test_pallas.py:210, 236): forward rtol/atol 2e-5;
gradients rtol 2e-4 / atol 1e-5 (exp, log and the sums' order differ
across frameworks).  bf16 outputs: one bf16 ulp (rtol 2^-7), since both
sides compute in f32 from the same bf16 inputs and round once.  The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
(marker `cuda`) and chip_smoke.py hold them against these plain
versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.ops import pallas_kernels as PK
from caffeonspark_tpu.parallel import sp as jax_sp
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.net import Net, data_layer_input_specs
from caffeonspark_tpu_torch.ops import kernels as K
from caffeonspark_tpu_torch.parallel import sp
from caffeonspark_tpu_torch.proto import NetParameter
from torch_common import cap_torch_threads

cap_torch_threads()

FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
BF16_RTOL = 2.0 ** -7


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _close_of_max(got, want, frac, msg=""):
    """max |got - want| within `frac` of max |want|: for a weight
    gradient, a sum over every position whose largest terms set the
    rounding of its small elements."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= frac * float(np.abs(want).max()), (msg, err)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# K6: the forward and its log-sum-exp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block", [(256, 128), (64, 64), (384, 128)])
def test_flash_fwd_plain_matches_pallas(causal, t, block):
    """flash_attention_plain's O and lse against `_flash_fwd_call` in
    interpret mode, and the autograd Function's forward (which runs the
    plain version on the CPU) against the same O."""
    b, h, d = 2, 3, 32
    q, k, v = (a.reshape(b * h, t, d) for a in _qkv((b, h, t, d), t))
    o_j, lse_j = PK._flash_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 1.0 / math.sqrt(d),
                                    causal, block, block, True)
    o_t, lse_t = K.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    _close(o_t, o_j, FWD_TOL, FWD_TOL, "O")
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL, "lse")
    o_f = K.flash_attention(*(_t(a).reshape(b, h, t, d) for a in (q, k, v)),
                            causal)
    assert torch.equal(o_f.reshape(b * h, t, d), o_t)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_sp_reference_at_ragged_t(causal):
    """At a T no TPU block divides (40), the port's flash plain version
    and its `parallel.sp.attention` against the JAX package's einsum
    reference (whose causal mask is -inf, not -1e30)."""
    b, h, t, d = 2, 2, 40, 24
    q, k, v = _qkv((b, h, t, d), 7)
    want = jax_sp.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal)
    got = K.flash_attention(_t(q), _t(k), _t(v), causal)
    _close(got, want, FWD_TOL, FWD_TOL, "flash plain")
    _close(sp.attention(_t(q), _t(k), _t(v), causal=causal), want,
           FWD_TOL, FWD_TOL, "sp.attention")
    # the offsets shift the causal diagonal as in the JAX reference
    want_off = jax_sp.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_offset=8,
                                k_offset=3)
    _close(sp.attention(_t(q), _t(k), _t(v), causal=True, q_offset=8,
                        k_offset=3), want_off, FWD_TOL, FWD_TOL, "offsets")


# ---------------------------------------------------------------------------
# K7 / K8: the backward block and the autograd Function
# ---------------------------------------------------------------------------

def _bwd_inputs(bh, t, d, seed, causal):
    q, k, v = _qkv((bh, t, d), seed)
    do = np.random.RandomState(seed + 1).randn(bh, t, d).astype(np.float32)
    o, lse = PK._flash_fwd_call(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 1.0 / math.sqrt(d), causal,
                                128, 128, True)
    delta = np.sum(do * np.asarray(o), axis=-1)
    return q, k, v, do, np.asarray(lse), delta


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_block_plain_matches_pallas(causal):
    """flash_bwd_block_plain and the port's flash_bwd_block (K7 + K8's
    plain versions on the CPU) against the Pallas `flash_bwd_block` in
    interpret mode on the same lse and delta."""
    q, k, v, do, lse, delta = _bwd_inputs(4, 256, 32, 3, causal)
    want = PK.flash_bwd_block(*(jnp.asarray(a) for a in
                                (q, k, v, do, lse, delta)),
                              causal=causal, block_q=128, block_k=128,
                              interpret=True)
    args = [_t(a) for a in (q, k, v, do, lse, delta)]
    plain = K.flash_bwd_block_plain(*args, causal=causal)
    routed = K.flash_bwd_block(*args, causal=causal)
    for name, w, p, r in zip(("dq", "dk", "dv"), want, plain, routed):
        _close(p, w, GRAD_RTOL, GRAD_ATOL, name)
        assert torch.equal(p, r), name


@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_grads_match_jax_grad(causal):
    """Gradients of sum(sin(attention)) through the port's FlashAttention
    against jax.grad through the Pallas flash kernels (interpret), the
    loss of tests/test_pallas.py:215-236."""
    b, h, t, d = 2, 2, 256, 16
    q, k, v = _qkv((b, h, t, d), 1)

    def loss_j(q, k, v):
        return jnp.sum(jnp.sin(PK.flash_attention(q, k, v, causal, 128, 128,
                                                  True)))
    want = jax.grad(loss_j, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    xs = [_t(a).requires_grad_(True) for a in (q, k, v)]
    torch.sin(K.flash_attention(*xs, causal)).sum().backward()
    for name, x, w in zip("qkv", xs, want):
        _close(x.grad, w, GRAD_RTOL, GRAD_ATOL, f"d{name}")


def test_flash_bf16_inputs():
    """bf16 q, k, v (tests/test_pallas.py:254): O in bf16 within one
    bf16 ulp of the Pallas kernel's and within bf16 resolution of the
    f32 reference; the lse, and the gradients with out_dtype=float32
    (what the ring backward asks for), at f32 tolerance, since both
    sides start from the same rounded inputs."""
    b, h, t, d = 1, 2, 128, 32
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in _qkv((b * h, t, d), 2))
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    o_j, lse_j = PK._flash_fwd_call(qj, kj, vj, 1.0 / math.sqrt(d), True,
                                    128, 128, True)
    qt, kt, vt = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    o_t, lse_t = K.flash_attention_fwd(qt, kt, vt, True)
    assert o_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    _close(o_t.float(), np.asarray(o_j, np.float32), BF16_RTOL, 1e-6, "O")
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL, "lse")
    ref = jax_sp.attention(*(jnp.asarray(a)[None] for a in (q, k, v)),
                           causal=True)[0]
    _close(o_t.float(), ref, 2e-2, 2e-2, "O vs f32 reference")

    do = np.random.RandomState(5).randn(b * h, t, d).astype(np.float32)
    doj = jnp.asarray(do, jnp.bfloat16)
    delta = np.sum(np.asarray(doj, np.float32) * np.asarray(o_j, np.float32),
                   axis=-1)
    want = PK.flash_bwd_block(qj, kj, vj, doj, lse_j, jnp.asarray(delta),
                              causal=True, block_q=128, block_k=128,
                              interpret=True, out_dtype=jnp.float32)
    got = K.flash_bwd_block(qt, kt, vt, _t(do).to(torch.bfloat16),
                            _t(lse_j), _t(delta), causal=True,
                            out_dtype=torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, GRAD_RTOL, GRAD_ATOL, name)


def test_flash_wrappers_validate_what_the_kernels_take():
    """The padded-width kernels' launch check (`_check_flash`: shapes,
    dtypes, contiguity, D <= 256, f32 row statistics) refuses what those
    kernels do not take (D > 256 goes to the wide kernels' check)."""
    x = torch.zeros(2, 8, 16)
    stats = torch.zeros(2, 8)
    K._check_flash("f", x, x, x, x, stats=(stats, stats))
    bad = [((torch.zeros(2, 8, 16, 1),), {}, "non-empty"),
           ((torch.zeros(2, 8, 16, dtype=torch.float16),), {}, "dtype"),
           ((torch.zeros(2, 8, 257),), {}, "head dim"),
           ((x, torch.zeros(2, 9, 16)), {}, "does not match"),
           ((x, torch.zeros(2, 16, 8).transpose(1, 2)), {}, "contiguous"),
           ((x,), {"stats": (torch.zeros(2, 8, dtype=torch.bfloat16),)},
            "row statistics")]
    for args, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            K._check_flash("f", *args, **kw)
    with pytest.raises(ValueError, match="out_dtype"):
        K._flash_out_dtype("f", x, torch.float64)


# ---------------------------------------------------------------------------
# layers against the JAX package's
# ---------------------------------------------------------------------------

MHA_NET = """
name: "mha"
layer {{ name: "in" type: "Input" top: "x"
  input_param {{ shape {{ dim: {t} dim: {b} dim: {dm} }} }} }}
layer {{ name: "attn" type: "MultiHeadAttention" bottom: "x" top: "attn"
  attention_param {{ num_heads: {h} head_dim: {hd} causal: {causal} }} }}
"""


def _both_nets(text):
    jnet = JaxNet(JaxNetParameter.from_text(text))
    tnet = Net(NetParameter.from_text(text), device="cpu")
    return jnet, tnet


def _rand_layout_params(layout, seed, scale=0.2):
    rng = np.random.RandomState(seed)
    return {ln: {bn: (rng.randn(*shape) * scale).astype(np.float32)
                 for bn, shape, _ in specs}
            for ln, specs in layout.items()}


@pytest.mark.parametrize("causal", [True, False])
def test_multihead_attention_matches_jax_through_pallas(causal,
                                                        monkeypatch):
    """The port's MultiHeadAttention layer against the JAX `_mha` at
    T=128, the JAX side through its Pallas flash kernels in interpret
    mode (COS_FLASH_INTERPRET=1): the output, and the gradients of
    sum(sin(out)) with respect to W_qkv, W_o (to 1e-5 of their largest
    element: each sums T·B products) and the input."""
    monkeypatch.setenv("COS_FLASH_INTERPRET", "1")
    t, b, h, hd = 128, 2, 2, 16
    text = MHA_NET.format(t=t, b=b, dm=24, h=h, hd=hd,
                          causal=str(causal).lower())
    jnet, tnet = _both_nets(text)
    assert {ln: [(n, s) for n, s, _ in sp_]
            for ln, sp_ in tnet.param_layout.items()} == {
        ln: [(n, tuple(s)) for n, s, _ in sp_]
        for ln, sp_ in jnet.param_layout.items()}
    arrays = _rand_layout_params(tnet.param_layout, 3)
    x = np.random.RandomState(4).randn(t, b, 24).astype(np.float32)

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


EMBED_NET = """
name: "embed_eltwise"
layer { name: "in" type: "Input" top: "ids" top: "y"
  input_param { shape { dim: 6 dim: 3 } shape { dim: 6 dim: 3 dim: 5 } } }
layer { name: "embed" type: "Embed" bottom: "ids" top: "e"
  embed_param { input_dim: 11 num_output: 5 bias_term: %s
    weight_filler { type: "uniform" min: -0.5 max: 0.5 } } }
layer { name: "sum" type: "Eltwise" bottom: "e" bottom: "y" top: "s"
  eltwise_param { operation: SUM coeff: 0.5 coeff: -2.0 } }
layer { name: "sum1" type: "Eltwise" bottom: "e" bottom: "y" top: "s1" }
layer { name: "prod" type: "Eltwise" bottom: "e" bottom: "y" bottom: "s"
  top: "p" eltwise_param { operation: PROD } }
layer { name: "max" type: "Eltwise" bottom: "e" bottom: "y" top: "m"
  eltwise_param { operation: MAX } }
"""


@pytest.mark.parametrize("bias", ["false", "true"])
def test_embed_and_eltwise_match_jax(bias):
    """Embed (float token ids cast to int, optional bias) and Eltwise
    SUM (with and without coeff), PROD and MAX: every blob, and the
    gradients of a loss over all of them with respect to the Embed
    blobs and y."""
    jnet, tnet = _both_nets(EMBED_NET % bias)
    arrays = _rand_layout_params(tnet.param_layout, 5)
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 11, (6, 3)).astype(np.float32)
    y = rng.randn(6, 3, 5).astype(np.float32)
    names = ("e", "s", "s1", "p", "m")

    def loss_j(p, y):
        blobs, _ = jnet.apply(p, {"ids": jnp.asarray(ids), "y": y},
                              train=True)
        return sum(jnp.sum(jnp.sin(blobs[n])) for n in names), blobs
    (_, blobs_j), (gp_j, gy_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
        {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
         for ln, bl in arrays.items()}, jnp.asarray(y))

    tp = convert.params_from_numpy(tnet, arrays)
    for w in tp["embed"].values():
        w.requires_grad_(True)
    yt = _t(y).requires_grad_(True)
    blobs_t = tnet(tp, {"ids": _t(ids), "y": yt})
    sum(torch.sin(blobs_t[n]).sum() for n in names).backward()
    for n in names:
        _close(blobs_t[n].detach(), blobs_j[n], 1e-6, 1e-6, n)
    for bn, w in tp["embed"].items():
        _close(w.grad, gp_j["embed"][bn], 1e-5, 1e-6, bn)
    _close(yt.grad, gy_j, 1e-5, 1e-6, "y")


def test_eltwise_sum_refuses_a_coeff_count_mismatch():
    text = (EMBED_NET % "false").replace("coeff: -2.0 ", "")
    with pytest.raises(ValueError, match="coeffs"):
        Net(NetParameter.from_text(text), device="cpu")


COS_TOPS = """
name: "cos"
layer { name: "data" type: "CoSData" top: "seq" top: "vec" top: "img"
  top: "lbl" top: "s" top: "cube"
  cos_data_param { batch_size: 5 source: "rows.json"
    dataframe_format: "json"
    top { name: "seq" type: INT_ARRAY channels: 7 sample_num_axes: 1
          transpose: true }
    top { name: "vec" type: FLOAT_ARRAY channels: 9 sample_num_axes: 1 }
    top { name: "img" type: ENCODED_IMAGE channels: 3 height: 20 width: 30
          out_height: 16 transform_param { crop_size: 12 } }
    top { name: "lbl" type: INT sample_num_axes: 0 }
    top { name: "s" type: STRING sample_num_axes: 0 }
    top { name: "cube" type: FLOAT channels: 2 height: 3 width: 4 } } }
"""


def test_cos_data_input_specs_match_jax():
    """CoSData tops: time-major (T, B) transposed arrays, (B, C) arrays,
    cropped image tops, scalars and (B, C, H, W) by sample_num_axes,
    with the 'int'/'data' kind and ':T' mark of the JAX package."""
    from caffeonspark_tpu.net import data_layer_input_specs as jax_specs
    tl = NetParameter.from_text(COS_TOPS).layer[0]
    jl = JaxNetParameter.from_text(COS_TOPS).layer[0]
    got = data_layer_input_specs(tl)
    assert got == [(n, tuple(s), k) for n, s, k in jax_specs(jl)]
    assert got[0] == ("seq", (7, 5), "int:T")
