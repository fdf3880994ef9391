"""K4 (`bias_relu_lrn_across_channels_bwd`, dx and d_bias of
lrn(relu(x + bias))) on the CPU: its plain version and the
BiasReluLRNAcrossChannels Function in bf16 against the JAX package's
custom VJP (the fused Pallas kernel in interpret mode), the kernel's
launch plan (`k4_plan`), and the routing of a CPU tensor.

Inputs come from seeded numpy.  bf16 tolerances: dx within one bf16 ulp
(2^-7 relative) of JAX's, since both round the same f32 math once (exp
and log differ in their last f32 bits across frameworks); d_bias within
one ulp of its own dtype plus the sum of the dx differences, and, with
an f32 bias, to 1e-5 relative: JAX sums dx.astype(f32) of the dx already
cast to bf16, and so must the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.ops import pallas_kernels as PK
from caffeonspark_tpu_torch.ops import kernels as K
from torch_common import cap_torch_threads

cap_torch_threads()

ALPHA, BETA, KK = 0.05, 0.75, 1.0
SHAPES = [(2, 8, 5, 7), (1, 12, 9, 11), (2, 16, 6, 7)]
BF16_ULP = 2.0 ** -7
NAME = "bias_relu_lrn_across_channels_bwd"


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    b = rng.randn(shape[1]).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, b, dy


def _jax_vjp(x, b, dy, ls, bias_dtype):
    """(dx, d_bias) of the JAX custom VJP in bf16, as float32 numpy."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    bj = jnp.asarray(b).astype(bias_dtype)
    _, vjp = jax.vjp(lambda xv, bv: PK.bias_relu_lrn_across_channels(
        xv, bv, ls, ALPHA, BETA, KK, True), xj, bj)
    dx, db = vjp(jnp.asarray(dy).astype(jnp.bfloat16))
    assert dx.dtype == jnp.bfloat16 and db.dtype == bias_dtype
    return (np.asarray(dx.astype(jnp.float32)),
            np.asarray(db.astype(jnp.float32)))


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("bias_bf16", [False, True])
@pytest.mark.parametrize("ls", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_dx_and_db_match_pallas_vjp(shape, ls, bias_bf16):
    """The plain version's and the Function's (dx, d_bias) in bf16
    against JAX's; d_bias is the f32 sum of the bf16-rounded dx."""
    x, b, dy = _inputs(shape, sum(shape) + ls)
    tdt = torch.bfloat16 if bias_bf16 else torch.float32
    jdt = jnp.bfloat16 if bias_bf16 else jnp.float32
    jdx, jdb = _jax_vjp(x, b, dy, ls, jdt)

    xt = torch.from_numpy(x).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(tdt)
    dyt = torch.from_numpy(dy).to(torch.bfloat16)
    dx, db = K.bias_relu_lrn_bwd_plain(xt, bt, dyt, ls, ALPHA, BETA, KK)
    assert dx.dtype == torch.bfloat16 and db.dtype == tdt
    np.testing.assert_allclose(_f32(dx), jdx, rtol=BF16_ULP, atol=1e-6)
    slack = np.abs(_f32(dx) - jdx).sum(axis=(0, 2, 3))
    if bias_bf16:
        assert np.all(np.abs(_f32(db) - jdb)
                      <= BF16_ULP * np.abs(jdb) + slack + 1e-6)
    else:
        assert np.all(np.abs(_f32(db) - jdb)
                      <= 1e-5 * np.abs(jdb) + slack + 1e-6)
        # the same sum over the unrounded f32 dx lands elsewhere: the
        # check above tells the two apart
        dx32, _ = K.bias_relu_lrn_bwd_plain(xt.float(), bt, dyt.float(), ls,
                                            ALPHA, BETA, KK)
        off = np.abs(dx32.sum(dim=(0, 2, 3)).numpy() - jdb)
        assert np.any(off > 1e-5 * np.abs(jdb) + slack + 1e-6)

    xg = xt.clone().requires_grad_(True)
    bg = bt.clone().requires_grad_(True)
    K.BiasReluLRNAcrossChannels.apply(xg, bg, ls, ALPHA, BETA,
                                      KK).backward(dyt)
    assert torch.equal(xg.grad, dx) and torch.equal(bg.grad, db)


# every K4 shape the card's phase 3 and phase 23 run: AlexNet's norm1 /
# norm2 at B 256 and at dp 2's B 128, GoogLeNet's norm2, the ragged and
# wide-window shapes, a batch past 65,535
PLAN_SHAPES = [((256, 96, 55, 55), 5), ((256, 256, 27, 27), 5),
               ((32, 192, 56, 56), 5), ((128, 96, 55, 55), 5),
               ((128, 256, 27, 27), 5), ((3, 13, 7, 9), 5),
               ((16, 96, 55, 55), 5), ((8, 96, 27, 27), 13),
               ((3, 13, 7, 9), 13), ((65_600, 4, 3, 3), 5),
               ((65_600, 4, 3, 3), 13)]


def _covers(intervals, total):
    """The half-open intervals partition [0, total), in order."""
    at = 0
    for lo, hi in intervals:
        if lo != at or hi <= lo:
            return False
        at = hi
    return at == total


@pytest.mark.parametrize("blocks_per_sm", [1, 4, 6, 9, 16])
@pytest.mark.parametrize("shape,ls", PLAN_SHAPES)
def test_k4_plan_covers_every_element_once(shape, ls, blocks_per_sm):
    """At 132 SMs and any occupancy: block b is (n, tile, run) with b =
    (n * tiles + tile) * runs + run, as csrc/lrn.cu's `place` reads it;
    the runs partition the channels and the tiles the positions, so each
    (n, c, position) is written by exactly one block; a run reads x over
    2 pad channels past each end of its own; and at least one whole wave
    launches wherever runs of K4_MIN_RUN channels or more can fill one."""
    n, c, h, w = shape
    sms, pad = 132, ls // 2
    plan = K.k4_plan(shape, ls, sms, blocks_per_sm)
    assert plan.tiles == -(-h * w // K.K4_TILE)
    assert plan.runs == -(-c // plan.run)
    assert plan.blocks == n * plan.tiles * plan.runs
    runs = [(r * plan.run, min(c, (r + 1) * plan.run))
            for r in range(plan.runs)]
    tiles = [(t * K.K4_TILE, min(h * w, (t + 1) * K.K4_TILE))
             for t in range(plan.tiles)]
    assert _covers(runs, c) and _covers(tiles, h * w)
    for cs, ce in runs:
        x_read = (max(0, cs - 2 * pad), min(c, ce + 2 * pad))
        assert cs - x_read[0] == min(cs, 2 * pad)
        assert x_read[1] - ce == min(c - ce, 2 * pad)
    shortest = min(c, K.K4_MIN_RUN)
    finest = -(-c // -(-c // (c // shortest)))   # runs at the shortest run
    if n * plan.tiles * finest >= sms * blocks_per_sm:
        assert plan.blocks >= sms * blocks_per_sm
    assert plan.run >= shortest


def test_k4_plan_refuses_a_slab_of_2_31_elements_by_name():
    """A sample's C*H*W of 2^31 elements or more is refused by name from
    the shape alone (nothing is allocated); one element fewer plans."""
    with pytest.raises(ValueError, match=NAME):
        K.k4_plan((1, 2 ** 16, 2 ** 8, 2 ** 7), 5, 132, 6)
    with pytest.raises(ValueError, match=NAME):
        K.k4_plan((2, 3, 2 ** 16, 2 ** 15), 5, 132, 6)
    plan = K.k4_plan((1, 2 ** 16 - 1, 2 ** 8, 2 ** 7), 5, 132, 6)
    assert plan.blocks >= 132 * 6


def test_k4_cpu_tensor_takes_plain_version_and_counts_nothing():
    """A CPU tensor runs the plain (dx, d_bias), byte for byte, and no
    launch is counted."""
    x, b, dy = (torch.from_numpy(a) for a in _inputs((2, 8, 5, 7), 3))
    K.reset_launch_counts()
    dx, db = K.bias_relu_lrn_across_channels_bwd(x, b, dy, 5, ALPHA, BETA,
                                                 KK)
    pdx, pdb = K.bias_relu_lrn_bwd_plain(x, b, dy, 5, ALPHA, BETA, KK)
    assert torch.equal(dx, pdx) and torch.equal(db, pdb)
    assert torch.equal(db, pdx.float().sum(dim=(0, 2, 3)))
    assert all(v == 0 for v in K.launch_counts.values())
    assert not K.launch_counts_by_dtype
