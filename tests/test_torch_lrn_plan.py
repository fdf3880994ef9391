"""K1, K2 and K3 (`lrn_across_channels`, its backward, and
`bias_relu_lrn_across_channels`) on the CPU: their launch plan
(`lrn_plan`, `lrn_tile`), the fused bias+ReLU+LRN backward's gradient
start behind a channel Concat at a batch of 1 (K4 copies from 16-byte
words), and the tests' torch thread cap.  The kernels themselves run on
the card only (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from caffeonspark_tpu_torch.ops import kernels as K
from torch_common import cap_torch_threads, fused_lrn_concat_step

cap_torch_threads()

SMS = 132
# CaffeNet's and AlexNet's norm planes (169, 729, 3025 positions) at the
# batches the paths run (1 to 256: a per-rank batch of 1, serving's 64,
# training's 256), GoogLeNet's 56x56, the ragged plane of the wide
# window and a batch past 65,535
PLAN_SHAPES = [((1, 256, 13, 13), 5), ((64, 256, 13, 13), 5),
               ((256, 256, 13, 13), 5), ((1, 96, 27, 27), 5),
               ((64, 96, 27, 27), 5), ((256, 96, 27, 27), 5),
               ((1, 96, 55, 55), 5), ((64, 96, 55, 55), 5),
               ((256, 96, 55, 55), 5), ((32, 192, 56, 56), 5),
               ((3, 13, 7, 9), 13), ((65_600, 4, 3, 3), 5)]
# blocks an SM holds at the tiles 64, 96, 128
OCCUPANCY = [(1, 1, 1), (16, 12, 9), (12, 8, 6), (32, 21, 16)]


def _partition(size, width, total):
    """[lo, hi) pieces of `width` over `total`: they cover it in order,
    each element once."""
    pieces = [(i * width, min(total, (i + 1) * width))
              for i in range(size)]
    assert pieces[0][0] == 0 and pieces[-1][1] == total
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(pieces,
                                                            pieces[1:]))
    return pieces


def _idle(hw, tile):
    slots = -(-hw // tile) * tile
    return (slots - hw) / slots


@pytest.mark.parametrize("kernel", [1, 2], ids=["k1_k3", "k2"])
@pytest.mark.parametrize("shape,ls", PLAN_SHAPES)
def test_lrn_plan_covers_every_element_once(shape, ls, kernel):
    """At 132 SMs and any occupancy: block b is (n, tile, run) with b =
    (n * tiles + tile) * runs + run, as csrc/lrn.cu's `staged::place`
    reads it, each triple once; the runs partition the channels and the
    tiles the positions, so each (n, c, position) is written by exactly
    one block; a whole wave launches wherever runs of K4_MIN_RUN
    channels can fill one; the tile leaves under LRN_PAD_SHARE of its
    slots idle wherever one of LRN_TILES can (169 positions: two tiles
    of 96), else the fewest; K3's plan is K1's (the same halo)."""
    n, c, h, w = shape
    hw = h * w
    for occupancy in OCCUPANCY:
        plan = K.lrn_plan(shape, ls, SMS, occupancy, kernel)
        assert plan.tile == K.lrn_tile(hw) and plan.tile in K.LRN_TILES
        assert plan.tiles == -(-hw // plan.tile)
        assert plan.runs == -(-c // plan.run)
        assert plan.blocks == n * plan.tiles * plan.runs
        _partition(plan.runs, plan.run, c)
        _partition(plan.tiles, plan.tile, hw)
        if plan.blocks <= 200_000:
            b = np.arange(plan.blocks)
            run, nt = b % plan.runs, b // plan.runs
            tile, sample = nt % plan.tiles, nt // plan.tiles
            assert sample.max() == n - 1
            key = (sample * plan.tiles + tile) * plan.runs + run
            assert np.array_equal(np.sort(key), b)
        wave = SMS * occupancy[K.LRN_TILES.index(plan.tile)]
        assert plan.waves == plan.blocks / wave
        shortest = min(c, K.K4_MIN_RUN)
        finest = -(-c // -(-c // (c // shortest)))
        if n * plan.tiles * finest >= wave:
            assert plan.blocks >= wave
        assert plan.run >= shortest
        least = min(_idle(hw, t) for t in K.LRN_TILES)
        if least < K.LRN_PAD_SHARE:
            assert _idle(hw, plan.tile) < K.LRN_PAD_SHARE
        else:
            assert _idle(hw, plan.tile) == least
        if kernel == 1:
            assert K.lrn_plan(shape, ls, SMS, occupancy, 3) == plan
    if hw == 169:
        assert K.lrn_tile(hw) == 96


def test_lrn_plan_refuses_by_name():
    """More than 2^31 - 1 blocks, an occupancy that is not one a tile, or
    no SM are refused by the kernel's name from the shape alone."""
    for kernel, name in K.LRN_KERNELS.items():
        with pytest.raises(ValueError, match=name + ": .* more than 2"):
            K.lrn_plan((2 ** 31, 1, 1, 1), 5, SMS, (8, 8, 8), kernel)
        with pytest.raises(ValueError, match=name):
            K.lrn_plan((2, 8, 5, 5), 5, SMS, (8, 8), kernel)
        with pytest.raises(ValueError, match=name):
            K.lrn_plan((2, 8, 5, 5), 5, 0, (8, 8, 8), kernel)
        assert K.lrn_plan((2 ** 30, 1, 1, 1), 5, SMS, (8, 8, 8),
                          kernel).blocks == 2 ** 30


def test_fused_lrn_behind_a_concat_at_batch_1_gets_an_aligned_gradient(
        monkeypatch):
    """BiasReluLRNAcrossChannels' backward receives Concat's gradient 12
    bytes past a 16-byte boundary and hands K4's wrapper a copy that
    starts on 16 bytes (the card's K4 refuses any other start); the loss
    and every gradient equal the unfused net's (the conv's bias, ReLU and
    K1 / K2's plain versions) to f32 rounding."""
    seen, handed = [], []
    backward = K.BiasReluLRNAcrossChannels.backward
    wrapper = K.bias_relu_lrn_across_channels_bwd

    def seen_backward(ctx, dy):
        seen.append(dy.data_ptr() % 16)
        return backward(ctx, dy)

    def handed_wrapper(x, bias, dy, *args):
        handed.append((x.data_ptr() % 16, dy.data_ptr() % 16))
        return wrapper(x, bias, dy, *args)

    monkeypatch.setattr(K.BiasReluLRNAcrossChannels, "backward",
                        staticmethod(seen_backward))
    monkeypatch.setattr(K, "bias_relu_lrn_across_channels_bwd",
                        handed_wrapper)
    monkeypatch.setenv("COS_FUSE_BIAS_RELU_LRN", "1")
    loss, grads = fused_lrn_concat_step("cpu")
    assert seen == [12] and handed == [(0, 0)]
    monkeypatch.delenv("COS_FUSE_BIAS_RELU_LRN")
    want_loss, want = fused_lrn_concat_step("cpu")
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    for ln, bl in want.items():
        for bn, g in bl.items():
            np.testing.assert_allclose(grads[ln][bn].numpy(), g.numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_cap_torch_threads_divides_the_cores_among_xdist_workers(
        monkeypatch):
    """Under xdist the cap is max(1, cores // workers) and never raises
    the threads in force; without xdist it changes nothing."""
    before = torch.get_num_threads()
    cores = 12
    monkeypatch.setattr("os.cpu_count", lambda: cores)
    try:
        torch.set_num_threads(8)
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
        assert cap_torch_threads() == 8
        for workers, want in (("2", 6), ("6", 2), ("24", 1)):
            torch.set_num_threads(8)
            monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
            assert cap_torch_threads() == want == torch.get_num_threads()
        torch.set_num_threads(3)
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "2")
        assert cap_torch_threads() == 3
    finally:
        torch.set_num_threads(before)
