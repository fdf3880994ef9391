"""The PyTorch port's backward pass against the JAX package: the LRN
backward kernels' plain versions (K2, K4) and their autograd Functions,
Dropout at TRAIN, and one step's gradients of narrow CaffeNet/AlexNet.

On the CPU the Functions run the plain versions; they are held against
`jax.grad` through the Pallas kernels in interpret mode (the custom VJPs
whose backward is `_lrn_bwd_kernel` / `_lrn_bwd_kernel_bias`, as
tests/test_pallas.py runs them) and against autograd through the port's
own `lrn_plain`.  Inputs come from seeded numpy.

Tolerances: K2/K4 rtol 3e-4 / atol 3e-5 (tests/test_pallas.py:60; exp,
log and the division round differently across frameworks).  Net
gradients: the loss to rtol 1e-5, every parameter's gradient to 1e-4 of
its largest magnitude (convolutions sum in other orders on each side).
The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
(marker `cuda`) and chip_smoke.py hold them against the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.ops import pallas_kernels as PK
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import Phase as JaxPhase
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.ops import kernels as K
from caffeonspark_tpu_torch.ops import layers as L
from caffeonspark_tpu_torch.proto import NetState, Phase
from torch_port_helpers import BATCH, CROP, narrow_net_text, torch_net_param
from torch_common import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 3e-4, 3e-5
ALPHA, BETA, KK = 0.05, 0.75, 1.0
SHAPES = [(2, 8, 4, 4), (1, 12, 9, 11), (2, 8, 5, 7)]


def _x(shape, seed, scale=3.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) \
        * scale


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lrn_backward_matches_pallas_vjp(shape, relu):
    """K2's plain version and LRNAcrossChannels' backward against
    jax.grad through the Pallas kernel (interpret mode), and against
    autograd through lrn_plain."""
    x = _x(shape, sum(shape))
    dy = _x(shape, 1 + sum(shape), scale=1.0)
    ls = 5

    def f(xj):
        return jnp.sum(PK.lrn_across_channels(xj, ls, ALPHA, BETA, KK, True,
                                              relu) * jnp.asarray(dy))
    want = np.asarray(jax.grad(f)(jnp.asarray(x)))

    plain = K.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(dy), ls,
                            ALPHA, BETA, KK, relu)
    _close(plain.numpy(), want)

    xt = torch.from_numpy(x).requires_grad_(True)
    y = K.LRNAcrossChannels.apply(xt, ls, ALPHA, BETA, KK, relu)
    y.backward(torch.from_numpy(dy))
    _close(xt.grad.numpy(), want)

    xa = torch.from_numpy(x).requires_grad_(True)
    (ga,) = torch.autograd.grad(
        K.lrn_plain(xa, ls, ALPHA, BETA, KK, relu), xa, torch.from_numpy(dy))
    _close(xt.grad.numpy(), ga.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_bias_relu_lrn_backward_matches_pallas_vjp(shape):
    """K4's plain version (dx, d_bias) and BiasReluLRNAcrossChannels: dx
    and d_bias against jax.grad through the fused Pallas kernel
    (interpret mode)."""
    x = _x(shape, 7 + sum(shape), scale=2.0)
    b = np.random.RandomState(8).randn(shape[1]).astype(np.float32)
    dy = _x(shape, 9 + sum(shape), scale=1.0)
    ls = 5

    def f(xj, bj):
        return jnp.sum(PK.bias_relu_lrn_across_channels(
            xj, bj, ls, ALPHA, BETA, KK, True) * jnp.asarray(dy))
    wx, wb = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))

    plain, plain_db = K.bias_relu_lrn_bwd_plain(torch.from_numpy(x),
                                                torch.from_numpy(b),
                                                torch.from_numpy(dy), ls,
                                                ALPHA, BETA, KK)
    _close(plain.numpy(), wx)
    _close(plain_db.numpy(), wb)

    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = K.BiasReluLRNAcrossChannels.apply(xt, bt, ls, ALPHA, BETA, KK)
    y.backward(torch.from_numpy(dy))
    _close(xt.grad.numpy(), wx)
    _close(bt.grad.numpy(), wb)

    xa = torch.from_numpy(x).requires_grad_(True)
    ba = torch.from_numpy(b).requires_grad_(True)
    gx, gb = torch.autograd.grad(
        K.lrn_plain(xa, ls, ALPHA, BETA, KK, bias=ba), (xa, ba),
        torch.from_numpy(dy))
    _close(xt.grad.numpy(), gx.numpy())
    _close(bt.grad.numpy(), gb.numpy())


def test_backward_wrappers_route_by_device_and_count_only_launches():
    """CPU tensors take the plain backward and count nothing; the
    Functions accept a non-contiguous upstream gradient."""
    K.reset_launch_counts()
    x = torch.from_numpy(_x((2, 6, 3, 5), 3)).requires_grad_(True)
    y = K.LRNAcrossChannels.apply(x, 5, ALPHA, BETA, KK, True)
    dy = torch.from_numpy(_x((2, 6, 5, 3), 4)).transpose(2, 3)
    assert not dy.is_contiguous()
    y.backward(dy)
    _close(x.grad.numpy(), K.lrn_bwd_plain(
        x.detach(), dy.contiguous(), 5, ALPHA, BETA, KK, True).numpy(),
        rtol=0, atol=0)
    assert all(v == 0 for v in K.launch_counts.values())
    assert set(K.launch_counts) >= {"lrn_across_channels_bwd",
                                    "bias_relu_lrn_across_channels_bwd"}


# ---------------------------------------------------------------------------
# Dropout at TRAIN
# ---------------------------------------------------------------------------

def _dropout_layer(ratio):
    npm = torch_net_param(
        'layer { name: "d" type: "Dropout" bottom: "x" top: "x" '
        f'dropout_param {{ dropout_ratio: {ratio} }} }}')
    return npm.layer[0]


def test_dropout_train_keep_share_scale_and_repeatable_mask():
    lp = _dropout_layer(0.3)
    x = torch.from_numpy(np.random.RandomState(0).rand(200, 500)
                         .astype(np.float32) + 0.5)
    op = L.get_op("Dropout")

    def run(seed):
        ctx = L.Ctx(train=True,
                    generator=torch.Generator().manual_seed(seed))
        ctx.layer_name = "d"
        return op.apply(ctx, lp, [], [x])[0]

    y = run(5)
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - 0.7) < 0.01, share
    np.testing.assert_array_equal(y[kept].numpy(),
                                  (x / 0.7)[kept].numpy())
    assert torch.equal(run(5), y)                 # same seed, same mask
    assert not torch.equal(run(6) != 0, kept)     # another seed differs
    test_ctx = L.Ctx()
    assert op.apply(test_ctx, lp, [], [x])[0] is x    # TEST: identity
    with pytest.raises(ValueError, match="generator"):
        op.apply(L.Ctx(train=True), lp, [], [x])


# ---------------------------------------------------------------------------
# one step's gradients of narrow CaffeNet / AlexNet
# ---------------------------------------------------------------------------

def _no_dropout(text: str) -> str:
    return text.replace("dropout_ratio: 0.5", "dropout_ratio: 0.0")


@pytest.mark.parametrize("name,fuse", [("caffenet", ""),
                                       ("caffenet", "COS_FUSE_RELU_LRN"),
                                       ("alexnet", ""),
                                       ("alexnet", "COS_FUSE_BIAS_RELU_LRN")])
def test_one_step_gradients_match_jax(name, fuse, monkeypatch):
    """jax.value_and_grad(net.loss) against the port's loss and
    torch.autograd.grad on the same params and batch, with the LRN
    peepholes off and on (dropout off: the two random streams differ)."""
    if fuse:
        monkeypatch.setenv(fuse, "1")
    text = _no_dropout(narrow_net_text(name))
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=JaxPhase.TRAIN))
    net = Net(torch_net_param(text), NetState(phase=Phase.TRAIN),
              device="cpu")
    assert net.fused_bias_lrn == jnet.fused_bias_lrn
    assert net.fused_relu_lrn == jnet.fused_relu_lrn
    assert net.loss_weights == jnet.loss_weights == {"loss": 1.0}
    arrays = convert.params_to_numpy(net.init(3))
    rng = np.random.RandomState(4)
    data = (rng.rand(BATCH, 3, CROP, CROP).astype(np.float32) - 0.5) * 100
    label = rng.randint(0, 10, BATCH).astype(np.float32)

    feed = {"data": jnp.asarray(data), "label": jnp.asarray(label)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet.loss(p, feed, train=True, rng=jax.random.key(0))[0]
    ))({ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
        for ln, bl in arrays.items()})

    params = convert.params_from_numpy(net, arrays)
    leaves = {ln: {bn: t.requires_grad_(True) for bn, t in bl.items()}
              for ln, bl in params.items()}
    loss, _ = net.loss(leaves, {"data": torch.from_numpy(data),
                                "label": torch.from_numpy(label)},
                       train=True, generator=torch.Generator())
    names = [(ln, bn) for ln, bl in leaves.items() for bn in bl]
    grads = torch.autograd.grad(loss, [leaves[ln][bn] for ln, bn in names])

    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for (ln, bn), g in zip(names, grads):
        want = np.asarray(jgrads[ln][bn])
        got = g.numpy()
        assert np.isfinite(got).all(), f"{ln}/{bn}: non-finite gradient"
        tol = 1e-4 * max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= tol, (ln, bn)
