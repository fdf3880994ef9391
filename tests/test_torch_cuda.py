"""The port's CUDA kernels on the card against their plain PyTorch
versions (marker `cuda`; each test skips where there is no card).

This file imports torch, numpy and the port only, so that it runs on a
machine with a card and no JAX:

    COS_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_cuda.py

(COS_TPU_TESTS=1 keeps tests/conftest.py from importing jax.)
chip_smoke.py repeats these checks at the serving and training shapes.
Tolerances: LRN forward rtol 2e-5 / atol 2e-6, backward rtol 3e-4 /
atol 3e-5 (K4's d_bias plus the rounding of its sum, `_k4_check`); K1
and K3 bit-equal, K2 bit-equal in f32 and within one bf16 ulp in bf16
(`_k123_check`); int8 exact; flash attention (K6-K9, whose sums run in another order
than the plain version's matmuls) forward rtol/atol 2e-5, gradients
rtol 2e-4 / atol 1e-5, and in bf16 one bf16 ulp (2^-7) beyond those.
"""

import math

import numpy as np
import pytest
import torch

from caffeonspark_tpu_torch.ops import kernels as K
from torch_common import cap_torch_threads, fused_lrn_concat_step

cap_torch_threads()

LRN_SHAPES = [(2, 8, 4, 4), (1, 96, 55, 55), (2, 5, 7, 9), (1, 12, 9, 11),
              (2, 8, 5, 7), (1, 6, 4, 5), (1, 7, 3, 3)]
BWD_SHAPES = [(2, 8, 4, 4), (1, 12, 9, 11), (2, 8, 5, 7), (3, 13, 7, 9),
              (4, 256, 13, 13)]
ALPHA, BETA, KK = 0.05, 0.75, 1.0


def _x(shape, seed, scale=3.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) \
        * scale


def _close(got, want, rtol=2e-5, atol=2e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: COS_TPU_TESTS=1 "
                    "python -m pytest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_card):
    """K1, K3 and K5 on the card against their plain versions on the
    same inputs (chip_smoke.py repeats this at the serving shapes)."""
    for shape in LRN_SHAPES:
        x = torch.from_numpy(_x(shape, 9)).to(cuda_card)
        b = torch.randn(shape[1], device=cuda_card)
        for relu in (False, True):
            _close(K.lrn_across_channels(x, 5, 1e-4, 0.75, 1.0,
                                         relu).cpu(),
                   K.lrn_plain(x, 5, 1e-4, 0.75, 1.0, relu).cpu())
        _close(K.bias_relu_lrn_across_channels(x, b).cpu(),
               K.lrn_plain(x, 5, 1e-4, 0.75, 1.0, bias=b).cpu())
    for m, n, kk in ((1, 1000, 4096), (64, 128, 256), (3, 37, 1001)):
        xq = torch.randint(-127, 128, (m, kk), dtype=torch.int8,
                           device=cuda_card)
        wq = torch.randint(-127, 128, (n, kk), dtype=torch.int8,
                           device=cuda_card)
        assert torch.equal(K.int8_matmul(xq, wq).cpu(),
                           K.int8_matmul_plain(xq, wq).cpu())


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card(cuda_card):
    """K2 and K4 on the card against their plain versions, including
    channel counts that are not a multiple of the kernel's channel run
    (chip_smoke.py repeats this at the B=256 training shapes)."""
    for shape in BWD_SHAPES:
        for ls in (3, 5):
            x = torch.from_numpy(_x(shape, 9)).to(cuda_card)
            dy = torch.from_numpy(_x(shape, 10, 1.0)).to(cuda_card)
            b = torch.randn(shape[1], device=cuda_card)
            for relu in (False, True):
                _close(K.lrn_across_channels_bwd(x, dy, ls, ALPHA, BETA, KK,
                                                 relu).cpu(),
                       K.lrn_bwd_plain(x, dy, ls, ALPHA, BETA, KK,
                                       relu).cpu(), 3e-4, 3e-5)
            _close(K.bias_relu_lrn_across_channels_bwd(
                x, b, dy, ls, ALPHA, BETA, KK)[0].cpu(),
                K.bias_relu_lrn_bwd_plain(x, b, dy, ls, ALPHA, BETA,
                                          KK)[0].cpu(), 3e-4, 3e-5)


@pytest.mark.cuda
def test_lrn_functions_launch_kernels_on_card(cuda_card):
    """The autograd Functions route a CUDA tensor to K1/K2 and K3/K4
    (one launch each way) and give the plain versions' gradients."""
    x = torch.from_numpy(_x((2, 16, 6, 7), 3)).to(cuda_card)
    b = torch.randn(16, device=cuda_card)
    dy = torch.from_numpy(_x((2, 16, 6, 7), 4, 1.0)).to(cuda_card)
    K.reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    K.LRNAcrossChannels.apply(xg, 5, ALPHA, BETA, KK, False).backward(dy)
    xb = x.clone().requires_grad_(True)
    bg = b.clone().requires_grad_(True)
    K.BiasReluLRNAcrossChannels.apply(xb, bg, 5, ALPHA, BETA,
                                      KK).backward(dy)
    assert K.launch_counts == {
        "lrn_across_channels": 1, "lrn_across_channels_bwd": 1,
        "bias_relu_lrn_across_channels": 1,
        "bias_relu_lrn_across_channels_bwd": 1, "int8_matmul": 0,
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0, "flash_block_update": 0}
    _close(xg.grad.cpu(), K.lrn_bwd_plain(x, dy, 5, ALPHA, BETA, KK).cpu(),
           3e-4, 3e-5)
    dx, _ = K.bias_relu_lrn_bwd_plain(x, b, dy, 5, ALPHA, BETA, KK)
    _close(xb.grad.cpu(), dx.cpu(), 3e-4, 3e-5)
    _close(bg.grad.cpu(), dx.sum((0, 2, 3)).cpu(), 3e-4, 3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,local_size", [
    ((2, 20, 5, 7), 13), ((1, 96, 13, 13), 15), ((3, 13, 7, 9), 13),
    ((65_600, 4, 2, 3), 5), ((65_600, 3, 2, 2), 13)])
def test_lrn_kernels_take_any_window_and_batch_on_card(cuda_card, shape,
                                                       local_size):
    """K1-K4 at windows wider than the register ring's (local_size > 11)
    and at a batch past 65,535, against their plain versions, bit for
    bit as at the narrower windows."""
    x = torch.from_numpy(_x(shape, 5)).to(cuda_card)
    dy = torch.from_numpy(_x(shape, 6, 1.0)).to(cuda_card)
    b = torch.randn(shape[1], device=cuda_card)
    ls = local_size
    for relu in (False, True):
        y = K.lrn_across_channels(x, ls, ALPHA, BETA, KK, relu)
        assert torch.equal(y, K.lrn_plain(x, ls, ALPHA, BETA, KK, relu))
        dx = K.lrn_across_channels_bwd(x, dy, ls, ALPHA, BETA, KK, relu)
        _close(dx.cpu(), K.lrn_bwd_plain(x, dy, ls, ALPHA, BETA, KK,
                                         relu).cpu(), 3e-4, 3e-5)
    assert torch.equal(K.bias_relu_lrn_across_channels(x, b, ls, ALPHA,
                                                       BETA, KK),
                       K.lrn_plain(x, ls, ALPHA, BETA, KK, bias=b))
    _close(K.bias_relu_lrn_across_channels_bwd(x, b, dy, ls, ALPHA, BETA,
                                               KK)[0].cpu(),
           K.bias_relu_lrn_bwd_plain(x, b, dy, ls, ALPHA, BETA,
                                     KK)[0].cpu(), 3e-4, 3e-5)


# K4 (dx and d_bias in one pass): BWD_SHAPES, odd planes (55x55, 27x27,
# 13x13 put channel planes off 16-byte boundaries), a C below the
# kernel's stage of 8 channels, and batches past 65,535
K4_SHAPES = BWD_SHAPES + [(2, 96, 55, 55), (3, 96, 27, 27), (2, 256, 13, 13),
                          (2, 3, 2, 2), (1, 1, 1, 1)]


def _k4_inputs(shape, seed, device, dtype):
    x = torch.from_numpy(_x(shape, seed)).to(device=device, dtype=dtype)
    dy = torch.from_numpy(_x(shape, seed + 1, 1.0)).to(device=device,
                                                       dtype=dtype)
    b = torch.from_numpy(_x((shape[1],), seed + 2, 1.0)).to(device)
    return x, b, dy


def _k4_check(shape, ls, dtype, device):
    """K4's (dx, db) against the plain version: dx within rtol 3e-4 /
    atol 3e-5 (f32) or one bf16 ulp; db within the same bounds of the
    exact sum of the dx it returns, plus the rounding of its summation
    (2^-24 times the additions on its longest path, times the sum of
    |dx|: log2 of a tile's positions, then one a partial that a thread
    of its final sum adds, then a 256-wide tree), and of the plain
    version's db with the dx differences added."""
    x, b, dy = _k4_inputs(shape, 7 + sum(shape) + ls, device, dtype)
    dx, db = K.bias_relu_lrn_across_channels_bwd(x, b, dy, ls, ALPHA, BETA,
                                                 KK)
    pdx, pdb = K.bias_relu_lrn_bwd_plain(x, b, dy, ls, ALPHA, BETA, KK)
    rtol, atol = (3e-4, 3e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
    _close(dx.float().cpu(), pdx.float().cpu(), rtol, atol)
    dims = (0, 2, 3)
    got, d64 = db.double().cpu(), dx.double().cpu()
    parts = shape[0] * -(-shape[2] * shape[3] // K.K4_TILE)
    depth = math.ceil(math.log2(K.K4_TILE)) + -(-parts // 256) + 8
    allow = 2.0 ** -24 * depth * d64.abs().sum(dims)
    own = d64.sum(dims)
    assert bool(((got - own).abs() <= atol + rtol * own.abs() + allow).all())
    plain = pdb.double().cpu()
    diff = (d64 - pdx.double().cpu()).abs().sum(dims)
    assert bool(((got - plain).abs()
                 <= atol + rtol * plain.abs() + 2 * allow + diff).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("local_size", [3, 5, 13, 15])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_dx_and_db_match_plain_on_card(cuda_card, shape, local_size,
                                          dtype):
    """K4's dx and d_bias against the plain (dx, db) at the backward
    shapes and odd planes, every window kind (the register rings up to
    local_size 11, the runtime-window kernel above), f32 and bf16."""
    _k4_check(shape, local_size, dtype, cuda_card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,local_size", [((65_600, 4, 2, 3), 5),
                                              ((65_600, 3, 2, 2), 13)])
def test_k4_takes_a_batch_past_65535_on_card(cuda_card, shape, local_size,
                                             dtype):
    """K4 at N = 65,600 (a 1-D grid of (n, tile, run) blocks)."""
    _k4_check(shape, local_size, dtype, cuda_card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_refuses_a_misaligned_start_by_name_on_card(cuda_card, dtype):
    """x or dy that does not start on 16 bytes (a view one element into
    its storage) is refused by name, not copied; a view 16 bytes in
    launches and matches the plain version."""
    shape = (2, 16, 5, 7)
    x, b, dy = _k4_inputs(shape, 5, cuda_card, dtype)
    n = x.numel()
    per16 = 16 // x.element_size()
    rtol, atol = (3e-4, 3e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
    for off, ok in ((1, False), (per16, True)):
        xs = torch.zeros(n + off, device=cuda_card, dtype=dtype)
        xs[off:] = x.reshape(-1)
        xv = xs[off:].view(shape)
        for args in ((xv, b, dy), (x, b, xv)):
            if ok:
                dx, _ = K.bias_relu_lrn_across_channels_bwd(*args)
                pdx, _ = K.bias_relu_lrn_bwd_plain(*args)
                _close(dx.float().cpu(), pdx.float().cpu(), rtol, atol)
            else:
                with pytest.raises(ValueError,
                                   match="bias_relu_lrn_across_channels_bwd"):
                    K.bias_relu_lrn_across_channels_bwd(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_repeats_and_graph_replay_are_byte_equal_on_card(cuda_card,
                                                            dtype):
    """Two calls give the same bytes of dx and d_bias (no atomics), and a
    call captured in a CUDA graph replays to the eager call's bytes."""
    x, b, dy = _k4_inputs((4, 96, 27, 27), 11, cuda_card, dtype)
    dx, db = K.bias_relu_lrn_across_channels_bwd(x, b, dy)
    dx2, db2 = K.bias_relu_lrn_across_channels_bwd(x, b, dy)
    assert torch.equal(dx, dx2) and torch.equal(db, db2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.bias_relu_lrn_across_channels_bwd(x, b, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with K.captured_launches() as rec:
        with torch.cuda.graph(graph):
            gdx, gdb = K.bias_relu_lrn_across_channels_bwd(x, b, dy)
    assert rec["counts"] == {"bias_relu_lrn_across_channels_bwd": 1}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gdx, dx) and torch.equal(gdb, db)


# K1, K2 and K3 (the staged kernels): CaffeNet's 13x13 plane (two tiles
# of 96) and 27x27 (tiles of 128), a window of 13 (the runtime-window
# kernels), a C below a stage of 8 channels, one element
K123_CASES = [((2, 16, 13, 13), 5), ((3, 96, 27, 27), 5),
              ((2, 20, 13, 13), 13), ((3, 5, 7, 9), 3), ((1, 1, 1, 1), 5)]


def _k123_check(x, dy, b, ls):
    """K1 (with and without the fused ReLU), K3 and K2 against their plain
    versions on the same tensors: y bit for bit in f32 and bf16 (the
    plain version's operations; in bf16 the same rounding), dx bit for
    bit in f32 and within one bf16 ulp in bf16."""
    for relu in (False, True):
        assert torch.equal(K.lrn_across_channels(x, ls, ALPHA, BETA, KK, relu),
                           K.lrn_plain(x, ls, ALPHA, BETA, KK, relu))
        dx = K.lrn_across_channels_bwd(x, dy, ls, ALPHA, BETA, KK, relu)
        pdx = K.lrn_bwd_plain(x, dy, ls, ALPHA, BETA, KK, relu)
        if x.dtype == torch.float32:
            assert torch.equal(dx, pdx)
        else:
            _close(dx.float().cpu(), pdx.float().cpu(), BF16_ULP, 1e-6)
    assert torch.equal(K.bias_relu_lrn_across_channels(x, b, ls, ALPHA, BETA,
                                                       KK),
                       K.lrn_plain(x, ls, ALPHA, BETA, KK, bias=b))


def _view_at(t, off):
    """t's values in a view that starts `off` elements into a fresh
    allocation (which starts on 16 bytes)."""
    s = torch.zeros(t.numel() + off, device=t.device, dtype=t.dtype)
    s[off:] = t.reshape(-1)
    v = s[off:].view(t.shape)
    assert v.data_ptr() % 16 == off * t.element_size() % 16
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,local_size", K123_CASES)
def test_k1_k2_k3_match_plain_at_every_start_on_card(cuda_card, shape,
                                                     local_size, dtype):
    """K1, K2 and K3 on x and dy that start at each element of a 16-byte
    word (0-3 in f32, 0-7 in bf16; dy one element further), as a Slice
    top or a Concat's gradient can: no refusal (K4's is its own), and
    `_k123_check` holds them against their plain versions."""
    x, b, dy = _k4_inputs(shape, 13 + sum(shape) + local_size, cuda_card,
                          dtype)
    per16 = 16 // x.element_size()
    for off in range(per16):
        _k123_check(_view_at(x, off), _view_at(dy, (off + 1) % per16), b,
                    local_size)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_k3_repeats_and_graph_replay_are_byte_equal_on_card(cuda_card,
                                                                  dtype):
    """Two calls of K1, K3 and K2 give the same bytes, and the three
    captured in a CUDA graph (one launch each counted) replay to the
    eager calls' bytes."""
    for shape in ((4, 256, 13, 13), (4, 96, 27, 27)):
        x, b, dy = _k4_inputs(shape, 12, cuda_card, dtype)

        def calls():
            return (K.lrn_across_channels(x),
                    K.bias_relu_lrn_across_channels(x, b),
                    K.lrn_across_channels_bwd(x, dy))

        eager = calls()
        assert all(torch.equal(u, v) for u, v in zip(eager, calls()))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            calls()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with K.captured_launches() as rec:
            with torch.cuda.graph(graph):
                captured = calls()
        assert rec["counts"] == {"lrn_across_channels": 1,
                                 "bias_relu_lrn_across_channels": 1,
                                 "lrn_across_channels_bwd": 1}
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(captured, eager))


@pytest.mark.cuda
def test_fused_lrn_behind_a_concat_at_batch_1_on_card(cuda_card,
                                                      monkeypatch):
    """The fused conv -> ReLU -> LRN whose top joins a channel Concat
    second, at a batch of 1, under COS_FUSE_BIAS_RELU_LRN=1: K3 and K4
    launch once each (K4 takes Concat's gradient, 12 bytes off 16,
    through the Function's aligned copy), and the loss and every gradient
    equal the same step with every LRN kernel swapped for its plain
    version (K4's dx is the plain dx bit for bit; its d_bias sums in
    another order: rtol 1e-5)."""
    monkeypatch.setenv("COS_FUSE_BIAS_RELU_LRN", "1")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    K.reset_launch_counts()
    loss, grads = fused_lrn_concat_step(cuda_card)
    assert K.launch_counts["bias_relu_lrn_across_channels"] == 1
    assert K.launch_counts["bias_relu_lrn_across_channels_bwd"] == 1
    monkeypatch.setattr(K, "bias_relu_lrn_across_channels",
                        lambda x, b, ls, a, be, k: K.lrn_plain(
                            x, ls, a, be, k, bias=b))
    monkeypatch.setattr(K, "bias_relu_lrn_across_channels_bwd",
                        K.bias_relu_lrn_bwd_plain)
    want_loss, want = fused_lrn_concat_step(cuda_card)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    for ln, bl in want.items():
        for bn, g in bl.items():
            _close(grads[ln][bn].cpu(), g.cpu(), 1e-5, 1e-6)


# (B·H, T, D): tiles of 64 rows whole and ragged, every padded width
FLASH_SHAPES = [(2, 64, 16), (3, 200, 48), (4, 384, 32), (1, 1, 8),
                (2, 130, 128), (1, 65, 64), (2, 100, 96)]
FLASH_FWD_TOL, FLASH_RTOL, FLASH_ATOL = 2e-5, 2e-4, 1e-5
BF16_ULP = 2.0 ** -7


def _flash_inputs(shape, seed, device, dtype):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(device=device, dtype=dtype) for _ in range(4))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_match_plain_on_card(cuda_card, dtype):
    """K6, K7 and K8 on the card against their plain versions on the
    same inputs, causal and not, at whole and ragged tiles and every
    padded head width (chip_smoke.py repeats this at (64, 2048, 64))."""
    dt = getattr(torch, dtype)
    extra = BF16_ULP if dt == torch.bfloat16 else 0.0
    for i, shape in enumerate(FLASH_SHAPES):
        for causal in (False, True):
            q, k, v, do = _flash_inputs(shape, i, cuda_card, dt)
            o, lse = K.flash_attention_fwd(q, k, v, causal)
            o_p, lse_p = K.flash_attention_plain(q, k, v, causal)
            assert o.dtype == dt and lse.dtype == torch.float32
            _close(o.float().cpu(), o_p.float().cpu(),
                   FLASH_FWD_TOL + extra, FLASH_FWD_TOL)
            _close(lse.cpu(), lse_p.cpu(), FLASH_FWD_TOL, FLASH_FWD_TOL)
            delta = (do.float() * o_p.float()).sum(-1)
            got = K.flash_bwd_block(q, k, v, do, lse_p, delta,
                                    causal=causal)
            want = K.flash_bwd_block_plain(q, k, v, do, lse_p, delta,
                                           causal=causal)
            for g, w in zip(got, want):
                assert g.dtype == dt
                _close(g.float().cpu(), w.float().cpu(),
                       FLASH_RTOL + extra, FLASH_ATOL)
    # bf16 inputs with f32 gradients (the ring backward's out_dtype)
    if dt == torch.bfloat16:
        q, k, v, do = _flash_inputs((3, 200, 48), 9, cuda_card, dt)
        o_p, lse_p = K.flash_attention_plain(q, k, v, True)
        delta = (do.float() * o_p.float()).sum(-1)
        got = K.flash_bwd_block(q, k, v, do, lse_p, delta, causal=True,
                                out_dtype=torch.float32)
        want = K.flash_bwd_block_plain(q, k, v, do, lse_p, delta,
                                       causal=True, out_dtype=torch.float32)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _close(g.cpu(), w.cpu(), FLASH_RTOL, FLASH_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_flash_backward_is_deterministic_on_card(cuda_card, dtype,
                                                 out_dtype):
    """K7 and K8 have one owner block per output tile and no atomics:
    two runs on the same inputs give bit-equal dq, dk, dv, in every
    (input, output) dtype pair."""
    dt, odt = getattr(torch, dtype), getattr(torch, out_dtype)
    for causal in (False, True):
        q, k, v, do = _flash_inputs((4, 384, 64), 3, cuda_card, dt)
        o_p, lse_p = K.flash_attention_plain(q, k, v, causal)
        delta = (do.float() * o_p.float()).sum(-1)
        runs = [K.flash_bwd_block(q, k, v, do, lse_p, delta, causal=causal,
                                  out_dtype=odt) for _ in range(2)]
        for a, b in zip(*runs):
            assert a.dtype == odt and torch.equal(a, b)


@pytest.mark.cuda
def test_flash_function_launches_kernels_on_card(cuda_card):
    """FlashAttention routes a CUDA tensor to K6 and its backward to K7
    and K8 (one launch each), with the plain versions' gradients; a
    non-contiguous operand is refused, not run plain, and one wider than
    256 launches the wide kernel."""
    q, k, v, do = _flash_inputs((2, 3, 150, 40), 4, cuda_card,
                                torch.float32)
    K.reset_launch_counts()
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    K.flash_attention(*xs, True).backward(do)
    assert {n: c for n, c in K.launch_counts.items()
            if n.startswith("flash")} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1, "flash_block_update": 0}
    flat = [x.reshape(6, 150, 40) for x in (q, k, v, do)]
    o_p, lse_p = K.flash_attention_plain(*flat[:3], True)
    delta = (flat[3] * o_p).sum(-1)
    want = K.flash_bwd_block_plain(*flat, lse_p, delta, causal=True)
    for x, w in zip(xs, want):
        _close(x.grad.reshape(6, 150, 40).cpu(), w.cpu(), FLASH_RTOL,
               FLASH_ATOL)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention_fwd(flat[0].transpose(1, 2).contiguous()
                              .transpose(1, 2), flat[1], flat[2])
    wide = torch.zeros(1, 8, 257, device=cuda_card)
    before = K.launch_counts["flash_attention_fwd"]
    K.flash_attention_fwd(wide, wide, wide)
    assert K.launch_counts["flash_attention_fwd"] == before + 1


# (BH, Tq, Tk, D, q_off, k_off): whole and ragged tiles, Tq != Tk, hops
# whose causal edge leaves some rows with no visible key, every width
K9_SHAPES = [(2, 64, 64, 16, 64, 64), (2, 64, 64, 16, 128, 0),
             (3, 200, 328, 48, 100, 150), (1, 65, 130, 64, 0, 40),
             (2, 100, 37, 128, 10, 60), (1, 1, 1, 8, 0, 0),
             # the sp ring's per-rank blocks (T 2048 over 4): a diagonal
             # and a fully visible hop
             (16, 512, 512, 64, 512, 512), (16, 512, 512, 64, 1536, 0)]


def _k9_carry(bh, tq, d, seed, first, device):
    if first:
        return (torch.full((bh, tq), -float("inf"), device=device),
                torch.zeros(bh, tq, device=device),
                torch.zeros(bh, tq, d, device=device))
    rng = np.random.RandomState(seed)
    m = torch.from_numpy((rng.randn(bh, tq) + 2).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 5, (bh, tq)).astype(np.float32))
    acc = torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32))
    m[:, 0], l[:, 0], acc[:, 0] = -1e30, 0.0, 0.0
    return m.to(device), l.to(device), acc.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_block_update_matches_plain_on_card(cuda_card, dtype):
    """K9 on the card against its plain version on the same q, block and
    carry: causal and not, a first-hop (-inf, 0, 0) and a mid-ring carry
    (chip_smoke.py repeats this at the LM's per-rank (64, 512, 512,
    64))."""
    dt = getattr(torch, dtype)
    extra = BF16_ULP if dt == torch.bfloat16 else 0.0
    K.reset_launch_counts()
    launches = 0
    for i, (bh, tq, tk, d, q_off, k_off) in enumerate(K9_SHAPES):
        rng = np.random.RandomState(i)
        q = torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32))
        k, v = (torch.from_numpy(rng.randn(bh, tk, d).astype(np.float32))
                for _ in range(2))
        q, k, v = (x.to(device=cuda_card, dtype=dt) for x in (q, k, v))
        for causal in (False, True):
            for first in (True, False):
                carry = _k9_carry(bh, tq, d, i, first, cuda_card)
                got = K.flash_block_update(q, k, v, *carry, q_off, k_off,
                                           causal)
                launches += 1
                want = K.flash_block_update_plain(q, k, v, *carry, q_off,
                                                  k_off, causal)
                for g, w in zip(got, want):
                    assert g.dtype == torch.float32
                    real = w[w.abs() < 1e29]     # not -inf, not -1e30
                    scale = float(real.abs().max()) if real.numel() else 0.
                    _close(g.cpu(), w.cpu(), FLASH_FWD_TOL + extra,
                           FLASH_FWD_TOL * (scale + 1.0))
    assert K.launch_counts["flash_block_update"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_grads_match_flash_attention_on_card(cuda_card, causal):
    """The fused ring on an sp4 mesh whose ranks share the card: its
    output and gradients against FlashAttention's on the whole sequence,
    and K9/K7/K8 launched as the ring's choreography says (K6 not)."""
    from caffeonspark_tpu_torch.parallel import sp
    from caffeonspark_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(sp=4, devices=[cuda_card] * 4)
    q, k, v, do = _flash_inputs((2, 3, 256, 40), 7, cuda_card,
                                torch.float32)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    K.reset_launch_counts()
    out = sp.ring_attention(*xs, mesh, causal=causal, flash=True)
    out.backward(do)
    n = 4
    hops = n * (n + 1) // 2 if causal else n * n
    assert {name: c for name, c in K.launch_counts.items()
            if name.startswith("flash")} == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": hops,
        "flash_attention_bwd_dkv": hops, "flash_block_update": hops}
    ys = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = K.flash_attention(*ys, causal)
    ref.backward(do)
    _close(out.detach().cpu(), ref.detach().cpu(), FLASH_FWD_TOL,
           FLASH_FWD_TOL)
    for x, y in zip(xs, ys):
        _close(x.grad.cpu(), y.grad.cpu(), FLASH_RTOL, FLASH_ATOL)


# head widths the kernels pad to 256 (one whole, two ragged)
WIDE_SHAPES = [(2, 256, 256), (1, 100, 200), (2, 130, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_take_head_dim_256_on_card(cuda_card, dtype):
    """K6, K7, K8 and K9 at D 256, 200 and 160 against their plain
    versions, causal and not (K8 splits dK and dV's columns over two
    blocks there; chip_smoke.py repeats this at (16, 2048, 256))."""
    dt = getattr(torch, dtype)
    extra = BF16_ULP if dt == torch.bfloat16 else 0.0
    for i, shape in enumerate(WIDE_SHAPES):
        q, k, v, do = _flash_inputs(shape, 20 + i, cuda_card, dt)
        for causal in (False, True):
            o, lse = K.flash_attention_fwd(q, k, v, causal)
            o_p, lse_p = K.flash_attention_plain(q, k, v, causal)
            _close(o.float().cpu(), o_p.float().cpu(),
                   FLASH_FWD_TOL + extra, FLASH_FWD_TOL)
            _close(lse.cpu(), lse_p.cpu(), FLASH_FWD_TOL, FLASH_FWD_TOL)
            delta = (do.float() * o_p.float()).sum(-1)
            got = K.flash_bwd_block(q, k, v, do, lse_p, delta,
                                    causal=causal)
            want = K.flash_bwd_block_plain(q, k, v, do, lse_p, delta,
                                           causal=causal)
            for g, w in zip(got, want):
                _close(g.float().cpu(), w.float().cpu(),
                       FLASH_RTOL + extra, FLASH_ATOL)
            bh, t, d = shape
            carry = _k9_carry(bh, t, d, i, False, cuda_card)
            got = K.flash_block_update(q, k, v, *carry, t, 0, causal)
            want = K.flash_block_update_plain(q, k, v, *carry, t, 0, causal)
            for g, w in zip(got, want):
                real = w[w.abs() < 1e29]
                scale = float(real.abs().max()) if real.numel() else 0.
                _close(g.cpu(), w.cpu(), FLASH_FWD_TOL + extra,
                       FLASH_FWD_TOL * (scale + 1.0))


@pytest.mark.cuda
def test_flash_wrappers_take_head_dim_257_on_card(cuda_card):
    """D = 257 is past the padded-width kernels' widest tiles: every flash
    wrapper launches its wide kernel for it on a CUDA tensor (one launch
    each, no plain fallback) and agrees with its plain version."""
    q, k, v, do = _flash_inputs((1, 40, 257), 30, cuda_card, torch.float32)
    st = torch.zeros(1, 40, device=cuda_card)
    m = torch.full((1, 40), -float("inf"), device=cuda_card)
    calls = [
        ("flash_attention_fwd", lambda: K.flash_attention_fwd(q, k, v),
         lambda: K.flash_attention_plain(q, k, v)),
        ("flash_attention_bwd_dq",
         lambda: K.flash_attention_bwd_dq(q, k, v, do, st, st),
         lambda: K.flash_bwd_dq_plain(q, k, v, do, st, st)),
        ("flash_attention_bwd_dkv",
         lambda: K.flash_attention_bwd_dkv(q, k, v, do, st, st),
         lambda: K.flash_bwd_dkv_plain(q, k, v, do, st, st)),
        ("flash_block_update",
         lambda: K.flash_block_update(q, k, v, m, st, torch.zeros_like(q),
                                      0, 0, True),
         lambda: K.flash_block_update_plain(q, k, v, m, st,
                                            torch.zeros_like(q), 0, 0,
                                            True))]
    for name, call, plain in calls:
        before = K.launch_counts[name]
        got, want = call(), plain()
        assert K.launch_counts[name] == before + 1, name
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            real = w[w.abs() < 1e29]
            scale = float(real.abs().max()) if real.numel() else 0.
            _close(g.cpu(), w.cpu(), FLASH_RTOL, FLASH_ATOL * (scale + 1.0))


# head widths of the wide kernels: ragged, one column group and a part,
# two whole groups (the LM at 2 heads)
HEAD_DIMS_WIDE = [257, 320, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS_WIDE)
def test_flash_kernels_take_wide_heads_on_card(cuda_card, d, dtype):
    """K6, K7, K8 and K9 at D 257, 320 and 512 (their wide kernels)
    against their plain versions, causal and not, K9 from a first-hop and
    a mid-ring carry on a hop whose first rows see no key."""
    dt = getattr(torch, dtype)
    extra = BF16_ULP if dt == torch.bfloat16 else 0.0
    shape = (2, 200, d)
    q, k, v, do = _flash_inputs(shape, d, cuda_card, dt)
    for causal in (False, True):
        o, lse = K.flash_attention_fwd(q, k, v, causal)
        o_p, lse_p = K.flash_attention_plain(q, k, v, causal)
        _close(o.float().cpu(), o_p.float().cpu(), FLASH_FWD_TOL + extra,
               FLASH_FWD_TOL)
        _close(lse.cpu(), lse_p.cpu(), FLASH_FWD_TOL, FLASH_FWD_TOL)
        delta = (do.float() * o_p.float()).sum(-1)
        got = K.flash_bwd_block(q, k, v, do, lse_p, delta, causal=causal)
        want = K.flash_bwd_block_plain(q, k, v, do, lse_p, delta,
                                       causal=causal)
        for g, w in zip(got, want):
            _close(g.float().cpu(), w.float().cpu(), FLASH_RTOL + extra,
                   FLASH_ATOL)
        for first in (True, False):
            carry = _k9_carry(2, 200, d, d, first, cuda_card)
            # q_off 100 < k_off 150: the first 50 rows see no key
            got = K.flash_block_update(q, k[:, :137].contiguous(),
                                       v[:, :137].contiguous(), *carry, 100,
                                       150, causal)
            want = K.flash_block_update_plain(q, k[:, :137], v[:, :137],
                                              *carry, 100, 150, causal)
            for g, w in zip(got, want):
                real = w[w.abs() < 1e29]
                scale = float(real.abs().max()) if real.numel() else 0.
                _close(g.cpu(), w.cpu(), FLASH_FWD_TOL + extra,
                       FLASH_FWD_TOL * (scale + 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_forward_and_hop_are_deterministic_on_card(cuda_card, dtype):
    """K6 and K9 at D 512 (the wide kernels' column groups compute the
    same scores; only group 0 writes the row statistics): two runs on the
    same inputs give bit-equal O and lse, and bit-equal (m, l, acc)."""
    dt = getattr(torch, dtype)
    q, k, v, _ = _flash_inputs((2, 300, 512), 12, cuda_card, dt)
    carry = _k9_carry(2, 300, 512, 5, False, cuda_card)
    for causal in (False, True):
        a = K.flash_attention_fwd(q, k, v, causal)
        b = K.flash_attention_fwd(q, k, v, causal)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        a = K.flash_block_update(q, k, v, *carry, 300, 0, causal)
        b = K.flash_block_update(q, k, v, *carry, 300, 0, causal)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_is_deterministic_on_card(cuda_card, dtype):
    """K6 has one owner block per output row and no atomics: two runs on
    the same inputs give bit-equal O and lse."""
    dt = getattr(torch, dtype)
    for shape in ((4, 384, 64), (2, 256, 256)):
        q, k, v, _ = _flash_inputs(shape, 11, cuda_card, dt)
        for causal in (False, True):
            a = K.flash_attention_fwd(q, k, v, causal)
            b = K.flash_attention_fwd(q, k, v, causal)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_int8_matmul_is_exact_over_repeated_calls_on_card(cuda_card):
    """K5 at fc6's shape, a bucket of 1, and ragged M, N and K, each
    called three times and interleaved with the others: every result
    equals the exact plain product, so the split-K tile counters come
    back to zero after each call."""
    shapes = [(64, 4096, 9216), (1, 1000, 4096), (5, 70, 1001), (3, 37, 16)]
    g = torch.Generator(device=cuda_card).manual_seed(5)
    ops = []
    for m, n, kk in shapes:
        xq = torch.randint(-127, 128, (m, kk), device=cuda_card,
                           generator=g, dtype=torch.int64).to(torch.int8)
        wq = torch.randint(-127, 128, (n, kk), device=cuda_card,
                           generator=g, dtype=torch.int64).to(torch.int8)
        ops.append((xq, wq, K.int8_matmul_plain(xq, wq)))
    for _ in range(3):
        for xq, wq, want in ops:
            assert torch.equal(K.int8_matmul(xq, wq), want)


@pytest.mark.cuda
@pytest.mark.parametrize("tp_text", [
    "crop_size: 227 mirror: true mean_value: 104 mean_value: 117 "
    "mean_value: 123",
    "crop_size: 8 mirror: true scale: 0.5 mean_value: 100"])
def test_device_stage_matches_host_transform_on_card(cuda_card, tp_text):
    """The device-side transform's float stage on the card against the
    host transform of the same draws, within 1e-5."""
    from caffeonspark_tpu_torch.data.transformer import Transformer
    from caffeonspark_tpu_torch.proto import TransformationParameter
    tp = TransformationParameter.from_text(tp_text)
    size = max(tp.crop_size + 29, 12)
    x = np.random.RandomState(5).randint(0, 256, (16, 3, size, size)
                                         ).astype(np.float32)
    want = Transformer(tp, phase_train=True, seed=3)(x.copy())
    t = Transformer(tp, phase_train=True, seed=3)
    u8, aux = t.host_stage(x.copy())
    got = t.device_stage_fn()(torch.from_numpy(u8).to(cuda_card),
                              torch.from_numpy(aux).to(cuda_card))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_stager_batches_survive_a_slow_consumer_on_card(cuda_card):
    """device_prefetch on its stager thread and side stream: the
    consumer's stream is held by a sleep kernel before each batch is
    read, while the stager stages the next ones and drops its own
    references; every batch still reads as it was packed (the
    consumer's stream waits on the batch's event, and its tensors are
    recorded on that stream, so their memory is not handed out
    again)."""
    from caffeonspark_tpu_torch.data.queue_runner import device_prefetch
    from caffeonspark_tpu_torch.data.transformer import (DEVICE_AUX_SUFFIX,
                                                         Transformer)
    from caffeonspark_tpu_torch.proto import TransformationParameter
    t = Transformer(TransformationParameter(mean_value=[7.0], scale=0.5),
                    phase_train=False)
    rng = np.random.RandomState(0)
    host = []
    for _ in range(12):
        u8, aux = t.host_stage(rng.randint(0, 256, (64, 3, 64, 64)
                                           ).astype(np.uint8))
        host.append({"data": u8, "data" + DEVICE_AUX_SUFFIX: aux})
    sums = []
    for staged in device_prefetch(iter(host), cuda_card, depth=3,
                                  device_transforms={
                                      "data": t.device_stage_fn()},
                                  background=True):
        torch.cuda._sleep(20_000_000)      # ~10 ms on the consumer stream
        sums.append(staged["data"].double().sum())
        del staged
    assert len(sums) == 12
    for s, h in zip(sums, host):
        want = ((h["data"].astype(np.float64) - 7.0) * 0.5).sum()
        assert abs(float(s) - want) <= 1e-6 * abs(want) + 1e-3


@pytest.mark.cuda
def test_mixed_lm_step_launches_flash_kernels_in_bf16_on_card(cuda_card):
    """One mixed-precision step (-dtype mixed) of a small transformer_lm
    on the card: K6, K7 and K8 launch once per layer, every launch in
    bf16, the loss finite and the gradients f32."""
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.proto import SolverParameter
    from caffeonspark_tpu_torch.solver import Solver
    npm = zoo.transformer_lm(vocab=64, d_model=64, heads=2, layers=2,
                             seq=256, batch=2)
    sp = SolverParameter.from_text('base_lr: 0.1 lr_policy: "fixed" '
                                   'momentum: 0.9 random_seed: 1')
    solver = Solver(sp, npm, device=cuda_card,
                    compute_dtype=torch.bfloat16)
    params, state = solver.init()
    rng = np.random.RandomState(3)
    toks = torch.from_numpy(rng.randint(0, 64, (257, 2)).astype(np.float32))
    inputs = {"input_sentence": toks[:-1].to(cuda_card),
              "target_sentence": toks[1:].to(cuda_card)}
    K.reset_launch_counts()
    loss, _, grads = solver.loss_and_grads(params, inputs)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert K.launch_counts[name] == 2, name
        assert K.launch_counts_by_dtype[(name, "bfloat16")] == 2, name
    assert bool(torch.isfinite(loss))
    assert all(g.dtype == torch.float32 for bl in grads.values()
               for g in bl.values())


@pytest.mark.cuda
def test_bf16_gemm_accumulates_in_f32_on_card(cuda_card):
    """After a Solver pins the precision, cuBLAS's bf16 GEMMs reduce in
    f32: a long dot product of bf16 values equals the f32 sum rounded
    once (a bf16 reduction would drift by many ulps)."""
    from caffeonspark_tpu_torch.serving.forward import pin_f32_precision
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    pin_f32_precision()
    assert not \
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    k = 16384
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.rand(64, k).astype(np.float32)).to(
        cuda_card, torch.bfloat16)
    b = torch.from_numpy(rng.rand(k, 64).astype(np.float32)).to(
        cuda_card, torch.bfloat16)
    got = (a @ b).float()
    want = (a.double() @ b.double()).to(torch.bfloat16).float()
    ulp = torch.abs(want) * 2.0 ** -7
    assert bool(torch.all(torch.abs(got - want) <= ulp))


# ---------------------------------------------------------------------------
# COS_STEPS_PER_LOOP: k solver steps as one CUDA graph
# ---------------------------------------------------------------------------

def _resnet_text(batch=2, px=32):
    """The zoo's ResNet stem, a projecting and an identity bottleneck
    block at narrow widths (tests/test_torch_batchnorm.py's net)."""
    from caffeonspark_tpu_torch.models import zoo
    t = (f'name: "ResNetReduced"\nlayer {{ name: "data" type: "MemoryData" '
         f'top: "data" top: "label" memory_data_param {{ batch_size: {batch} '
         f'channels: 3 height: {px} width: {px} }} }}\n')
    t += zoo._CONV_BN.format(name="conv1", bottom="data", n=8, k=7,
                             extra="pad: 3 stride: 2")
    t += ('layer { name: "conv1_relu" type: "ReLU" bottom: "conv1" '
          'top: "conv1" }\nlayer { name: "pool1" type: "Pooling" '
          'bottom: "conv1" top: "pool1" pooling_param { pool: MAX '
          'kernel_size: 3 stride: 2 } }\n')
    t = zoo._res_block(t, "res2a", "pool1", 4, 16, 1, project=True)
    t = zoo._res_block(t, "res2b", "res2a", 4, 16, 1, project=False)
    t += ('layer { name: "pool5" type: "Pooling" bottom: "res2b" '
          'top: "pool5" pooling_param { pool: AVE global_pooling: true } }'
          '\nlayer { name: "fc" type: "InnerProduct" bottom: "pool5" '
          'top: "fc" inner_product_param { num_output: 10 weight_filler '
          '{ type: "xavier" } } }\nlayer { name: "loss" type: '
          '"SoftmaxWithLoss" bottom: "fc" bottom: "label" top: "loss" }\n')
    return t


NARROW_CAFFENET = {"conv1": 8, "conv2": 16, "conv3": 16, "conv4": 16,
                   "conv5": 8, "fc6": 32, "fc7": 32, "fc8": 10}


def _graph_case(name, device):
    """(solver, params, state, blocks of 4 steps' stacked inputs, mesh):
    a narrow crop-67 CaffeNet (LRN, Dropout; SGD with clip_gradients and
    iter_size 2), a narrow ResNet of the zoo's bottleneck blocks
    (BatchNorm's statistics written in place by every forward; SGD with
    iter_size 2) or a small causal transformer_lm (Adam, K6-K8; with
    `sp` the ring on 4 ranks of the one card: K9, K7, K8) or the zoo's
    lstm_lm (SGD with clip_gradients; the recurrence's Python loop, cont
    fed in the compute dtype as mini_cluster casts it)."""
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.parallel.mesh import build_mesh
    from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
    from caffeonspark_tpu_torch.solver import Solver
    rng = np.random.RandomState(7)
    mesh = None
    if name.startswith("caffenet"):
        npm = zoo.caffenet(batch_size=4, num_classes=10, crop=67)
        for lp in npm.layer:
            if lp.name in NARROW_CAFFENET:
                p = (lp.convolution_param if lp.type == "Convolution"
                     else lp.inner_product_param)
                p.num_output = NARROW_CAFFENET[lp.name]
        sp = SolverParameter.from_text(
            'base_lr: 0.01 lr_policy: "step" gamma: 0.5 stepsize: 3 '
            'momentum: 0.9 weight_decay: 0.0005 clip_gradients: 5 '
            'iter_size: 2 random_seed: 3')
        solver = Solver(sp, npm, device=device)
        blocks = [{"data": torch.from_numpy(
                       rng.randn(4, 8, 3, 67, 67).astype(np.float32) * 40),
                   "label": torch.from_numpy(
                       rng.randint(0, 10, (4, 8)).astype(np.float32))}
                  for _ in range(3)]
    elif name == "resnet":
        npm = NetParameter.from_text(_resnet_text(batch=4))
        sp = SolverParameter.from_text(
            'base_lr: 0.1 momentum: 0.9 weight_decay: 0.0001 '
            'iter_size: 2 random_seed: 3')
        solver = Solver(sp, npm, device=device)
        blocks = [{"data": torch.from_numpy(
                       rng.randn(4, 4, 3, 32, 32).astype(np.float32)),
                   "label": torch.from_numpy(
                       rng.randint(0, 10, (4, 4)).astype(np.float32))}
                  for _ in range(3)]
    elif name.startswith("lstm"):
        npm = zoo.lstm_lm(vocab=64, d_model=32, seq=10, batch_size=4)
        sp = SolverParameter.from_text(
            'base_lr: 0.01 lr_policy: "step" gamma: 0.5 stepsize: 3 '
            'momentum: 0.9 clip_gradients: 10 random_seed: 1')
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
        compute = torch.bfloat16 if name.endswith("mixed") else None
        solver = Solver(sp, npm, device=device, dtype=dtype,
                        compute_dtype=compute)
        cont = (rng.rand(3, 4, 10, 4) > 0.2).astype(np.float32)
        cont[:, :, 0] = 0.0
        blocks = [{"input_sentence": torch.from_numpy(
                       rng.randint(0, 64, (4, 10, 4)).astype(np.float32)),
                   "cont_sentence": torch.from_numpy(c).to(
                       torch.bfloat16 if dtype == torch.bfloat16 or compute
                       else torch.float32),
                   "target_sentence": torch.from_numpy(
                       rng.randint(-1, 64, (4, 10, 4)).astype(np.float32))}
                  for c in cont]
    else:
        npm = zoo.transformer_lm(vocab=64, d_model=64, heads=2, layers=2,
                                 seq=256, batch=2)
        sp = SolverParameter.from_text(
            'type: "ADAM" base_lr: 0.001 lr_policy: "inv" gamma: 0.1 '
            'power: 0.75 momentum: 0.9 momentum2: 0.999 random_seed: 1')
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
        compute = torch.bfloat16 if name.endswith("mixed") else None
        solver = Solver(sp, npm, device=device, dtype=dtype,
                        compute_dtype=compute)
        toks = rng.randint(0, 64, (3, 4, 257, 2)).astype(np.float32)
        blocks = [{"input_sentence": torch.from_numpy(t[:, :-1]),
                   "target_sentence": torch.from_numpy(t[:, 1:])}
                  for t in toks]
        if "sp" in name:
            mesh = build_mesh(sp=4, devices=[device] * 4)
    params, state = solver.init()
    blocks = [{k: v.to(device) for k, v in b.items()} for b in blocks]
    return solver, params, state, blocks, mesh


def _route(mesh):
    import contextlib
    from caffeonspark_tpu_torch.ops.layers import flash_mesh
    return flash_mesh(mesh) if mesh is not None else contextlib.nullcontext()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["caffenet", "lm", "lm_mixed", "lm_bf16",
                                  "lm_sp_mixed", "resnet", "lstm",
                                  "lstm_mixed", "lstm_bf16"])
def test_graphed_steps_equal_eager_steps_on_card(cuda_card, name):
    """Three blocks of 4 steps through train_step_many(4) (an eager
    warm-up, a capture and its replay, a replay) against 12 train_step
    calls from the same init: params, histories, losses and learning
    rates bit-equal (the dropout draws, clip and iter_size 2, the
    learning-rate schedule and Adam's correction read from the device
    buffers), cuDNN deterministic."""
    torch.backends.cudnn.deterministic = True
    solver, pa, sa, blocks, mesh = _graph_case(name, cuda_card)
    want = []
    with _route(mesh):
        for b in blocks:
            for i in range(4):
                loss, out = solver.train_step(pa, sa,
                                              {k: v[i] for k, v in b.items()})
                want.append((loss.item(), float(out["lr"])))
    solver2, pb, sb, _, _ = _graph_case(name, cuda_card)
    many = solver2.train_step_many(4)
    got = []
    with _route(mesh):
        for b in blocks:
            losses, out = many(pb, sb, b)
            got += list(zip(losses.tolist(), out["lr"].tolist()))
    assert many.captures == 1 and many.replays == 2
    assert sa.iter == sb.iter == 12
    assert got == want
    for tree_a, tree_b in ((pa, pb), (sa.history, sb.history),
                           (sa.history2, sb.history2)):
        for ln in tree_a:
            for bn in tree_a[ln]:
                assert torch.equal(tree_a[ln][bn], tree_b[ln][bn]), (ln, bn)


@pytest.mark.cuda
def test_graph_replays_count_their_launches_on_card(cuda_card):
    """The launches of a graphed chunk count once a replay: 3 blocks of
    4 steps of the CaffeNet (two LRN layers; iter_size 2) launch K1 and
    K2 2 x 2 x 12 times each, as 12 eager steps do, and the capture
    itself adds nothing."""
    solver, params, state, blocks, _ = _graph_case("caffenet", cuda_card)
    many = solver.train_step_many(4)
    K.reset_launch_counts()
    many(params, state, blocks[0])             # the eager warm-up
    assert K.launch_counts["lrn_across_channels"] == 16
    many(params, state, blocks[1])             # capture + one replay
    assert K.launch_counts["lrn_across_channels"] == 32
    many(params, state, blocks[2])
    torch.cuda.synchronize()
    for name in ("lrn_across_channels", "lrn_across_channels_bwd"):
        assert K.launch_counts[name] == 48, name
        assert K.launch_counts_by_dtype[(name, "float32")] == 48, name


@pytest.mark.cuda
def test_graph_capture_failure_raises_on_card(cuda_card, monkeypatch):
    """A step that syncs with the host cannot be captured: the capture
    raises, and nothing runs eagerly in its place."""
    solver, params, state, blocks, _ = _graph_case("caffenet", cuda_card)
    many = solver.train_step_many(4)
    many(params, state, blocks[0])
    real = solver.loss_grads_and_state

    def syncing(p, inputs):
        loss, out, grads, fwd_state = real(p, inputs)
        float(loss)                  # a device-to-host copy
        return loss, out, grads, fwd_state

    monkeypatch.setattr(solver, "loss_grads_and_state", syncing)
    with pytest.raises(RuntimeError):
        many(params, state, blocks[1])
    assert state.iter == 4 and many.replays == 0


BN_CASES = {
    "bn-train": ('layer { name: "l" type: "BatchNorm" bottom: "x" '
                 'top: "y" }', True, [(8, 16, 9, 9)]),
    "bn-global": ('layer { name: "l" type: "BatchNorm" bottom: "x" '
                  'top: "y" }', False, [(8, 16, 9, 9)]),
    "scale": ('layer { name: "l" type: "Scale" bottom: "x" top: "y" '
              'scale_param { bias_term: true filler { type: "gaussian" } '
              'bias_filler { type: "gaussian" } } }', True,
              [(8, 16, 9, 9)]),
    "concat": ('layer { name: "l" type: "Concat" bottom: "x" bottom: "x1" '
               'top: "y" }', True, [(8, 16, 9, 9), (8, 24, 9, 9)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_scale_concat_match_cpu_on_card(cuda_card, case):
    """BatchNorm (batch and global statistics, with the new running
    statistics), Scale and Concat on the card against the CPU: tops and
    input gradients rtol 1e-5 / atol 1e-6 (cuDNN-free reductions that
    sum in another order)."""
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetParameter
    layer, train, shapes = BN_CASES[case]
    names = ["x", "x1"][:len(shapes)]
    text = "".join(
        f'layer {{ name: "{n}" type: "Input" top: "{n}" input_param {{ '
        f'shape {{ {" ".join(f"dim: {d}" for d in s)} }} }} }}\n'
        for n, s in zip(names, shapes)) + layer
    outs = []
    for dev in ("cpu", cuda_card):
        net = Net(NetParameter.from_text(text), device=dev)
        params = net.init(4)
        if "l" in params and "variance" in params["l"]:
            params["l"]["mean"].fill_(0.5)
            params["l"]["variance"].fill_(6.0)
            params["l"]["count"].fill_(3.0)
        xs = {n: torch.from_numpy(_x(s, 20 + i)).to(dev).requires_grad_()
              for i, (n, s) in enumerate(zip(names, shapes))}
        state = {}
        y = net(params, xs, train=train, state_out=state)["y"]
        g = torch.autograd.grad((y * y).sum(), list(xs.values()))
        outs.append([y.detach().cpu(), *[t.cpu() for t in g],
                     *[t.cpu() for v in state.values() for t in v]])
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        _close(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_async_snapshot_of_card_tensors_equals_sync_on_card(cuda_card,
                                                             tmp_path):
    """AsyncSnapshotter with params and history on the card (pinned host
    copies, a stream synchronize): the files equal the synchronous
    snapshot's, and a step right after the submit does not reach
    them."""
    import filecmp
    import os
    from caffeonspark_tpu_torch import checkpoint
    solver, params, state, blocks, _ = _graph_case("resnet", cuda_card)
    solver.train_step(params, state, {k: v[0] for k, v in
                                      blocks[0].items()})
    checkpoint.snapshot(solver.train_net, params, state,
                        str(tmp_path / "sync" / "m"))
    snap = checkpoint.AsyncSnapshotter()
    try:
        snap.submit(solver.train_net, params, state,
                    str(tmp_path / "async" / "m"))
        solver.train_step(params, state, {k: v[1] for k, v in
                                          blocks[0].items()})
        snap.wait(timeout=120)
    finally:
        snap.close()
    names = sorted(os.listdir(tmp_path / "sync"))
    assert names == sorted(os.listdir(tmp_path / "async"))
    for n in names:
        assert filecmp.cmp(tmp_path / "sync" / n, tmp_path / "async" / n,
                           shallow=False), n


NEW_LAYER_CASES = {
    "prelu": ('layer { name: "l" type: "PReLU" bottom: "x" top: "y" '
              'prelu_param { filler { type: "gaussian" } } }', [(4, 8, 9, 9)]),
    "elu": ('layer { name: "l" type: "ELU" bottom: "x" top: "y" }',
            [(4, 8, 9, 9)]),
    "bnll": ('layer { name: "l" type: "BNLL" bottom: "x" top: "y" }',
             [(4, 8, 9, 9)]),
    "power": ('layer { name: "l" type: "Power" bottom: "x" top: "y" '
              'power_param { power: 2 scale: 0.5 shift: 1 } }',
              [(4, 8, 9, 9)]),
    "exp": ('layer { name: "l" type: "Exp" bottom: "x" top: "y" '
            'exp_param { base: 2 scale: 0.3 } }', [(4, 8, 9, 9)]),
    "mvn": ('layer { name: "l" type: "MVN" bottom: "x" top: "y" }',
            [(4, 8, 9, 9)]),
    "spp": ('layer { name: "l" type: "SPP" bottom: "x" top: "y" '
            'spp_param { pyramid_height: 3 } }', [(4, 8, 13, 11)]),
    "deconv": ('layer { name: "l" type: "Deconvolution" bottom: "x" '
               'top: "y" convolution_param { num_output: 6 kernel_size: 8 '
               'stride: 4 pad: 2 weight_filler { type: "gaussian" '
               'std: 0.1 } } }', [(2, 8, 9, 9)]),
    "crop": ('layer { name: "l" type: "Crop" bottom: "x" bottom: "x1" '
             'top: "y" crop_param { axis: 2 offset: 3 } }',
             [(2, 8, 13, 13), (2, 8, 7, 7)]),
    "batch_reindex": ('layer { name: "l" type: "BatchReindex" bottom: "x" '
                      'bottom: "x1" top: "y" }', [(6, 5), (9,)]),
    "euclidean": ('layer { name: "l" type: "EuclideanLoss" bottom: "x" '
                  'bottom: "x1" top: "y" }', [(16, 10), (16, 10)]),
    "sigmoid_ce": ('layer { name: "l" type: "SigmoidCrossEntropyLoss" '
                   'bottom: "x" bottom: "x1" top: "y" }',
                   [(16, 10), (16, 10)]),
    "hinge": ('layer { name: "l" type: "HingeLoss" bottom: "x" '
              'bottom: "x1" top: "y" hinge_loss_param { norm: L2 } }',
              [(16, 10), (16,)]),
    "stochastic": ('layer { name: "l" type: "Pooling" bottom: "x" top: "y" '
                   'pooling_param { pool: STOCHASTIC kernel_size: 3 '
                   'stride: 2 } }', [(4, 8, 9, 9)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NEW_LAYER_CASES))
def test_new_layer_types_match_cpu_on_card(cuda_card, case):
    """The stateless types of PR 14 on the card against the CPU (tops and
    the gradients of every param and float input, rtol 1e-5 / atol 1e-5;
    cuDNN's deconvolution with TF32 off).  Second bottoms of the index
    kinds (labels, BatchReindex's indices) are integers in range;
    STOCHASTIC pooling runs its TEST mean on non-negative input."""
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetParameter
    from caffeonspark_tpu_torch.serving.forward import pin_f32_precision
    pin_f32_precision()
    layer, shapes = NEW_LAYER_CASES[case]
    names = ["x", "x1"][:len(shapes)]
    text = "".join(
        f'layer {{ name: "{n}" type: "Input" top: "{n}" input_param {{ '
        f'shape {{ {" ".join(f"dim: {d}" for d in s)} }} }} }}\n'
        for n, s in zip(names, shapes)) + layer
    arrays = [_x(s, 30 + i, 1.0) for i, s in enumerate(shapes)]
    if case in ("hinge", "batch_reindex"):
        hi = shapes[0][1] if case == "hinge" else shapes[0][0]
        arrays[1] = np.random.RandomState(3).randint(
            0, hi, shapes[1]).astype(np.float32)
    if case == "stochastic":
        arrays[0] = np.abs(arrays[0])
    if case == "sigmoid_ce":
        arrays[1] = np.random.RandomState(4).rand(*shapes[1]).astype(
            np.float32)
    outs = []
    for dev in ("cpu", cuda_card):
        net = Net(NetParameter.from_text(text), device=dev)
        params = net.init(4)
        leaves = [t.requires_grad_() for bl in params.values()
                  for t in bl.values()]
        xs = {n: torch.from_numpy(a).to(dev) for n, a in zip(names, arrays)}
        xs["x"].requires_grad_()
        y = net(params, xs)["y"]
        g = torch.autograd.grad((y * y).sum(), [xs["x"]] + leaves)
        outs.append([y.detach().cpu(), *[t.cpu() for t in g]])
    for a, b in zip(*outs):
        _close(b, a, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the rest of the data path: SequenceFile / LevelDB feeding CaffeNet, and
# HDF5Output's side channel under a CUDA graph
# ---------------------------------------------------------------------------

def _store_source(store, path, crop=67):
    """A narrow CaffeNet's TRAIN source over 8 seeded 3x72x72 Datums in a
    SequenceFile or a LevelDB (snappy blocks) at `path`, written by the
    port's own writers."""
    from caffeonspark_tpu_torch.data.leveldb_io import LevelDBWriter
    from caffeonspark_tpu_torch.data.sequencefile import SequenceFileWriter
    from caffeonspark_tpu_torch.data.source import get_source
    from caffeonspark_tpu_torch.proto.caffe import Datum, LayerParameter
    rng = np.random.RandomState(5)
    recs = [(b"%08d" % i, Datum(
        channels=3, height=72, width=72, label=int(rng.randint(10)),
        data=rng.randint(0, 256, 3 * 72 * 72).astype(np.uint8).tobytes()
    ).to_binary()) for i in range(8)]
    xf = (f'transform_param {{ crop_size: {crop} mirror: true '
          'mean_value: 104 mean_value: 117 mean_value: 123 }')
    if store == "sequencefile":
        with SequenceFileWriter(path) as w:
            for k, v in recs:
                w.append(k.decode(), v)
        text = ('name: "data" type: "MemoryData" top: "data" top: "label" '
                'source_class: "com.yahoo.ml.caffe.SeqImageDataSource" '
                f'{xf} memory_data_param {{ source: "{path}" batch_size: 4 '
                'channels: 3 height: 72 width: 72 }')
    else:
        LevelDBWriter(path, snappy=True).write(recs)
        text = ('name: "data" type: "Data" top: "data" top: "label" '
                f'{xf} data_param {{ source: "{path}" batch_size: 4 '
                'backend: LEVELDB }')
    return lambda: get_source(LayerParameter.from_text(text),
                              phase_train=True, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["sequencefile", "leveldb"])
def test_store_feeds_a_caffenet_step_on_card(cuda_card, store, tmp_path,
                                             monkeypatch):
    """A SequenceFile / LevelDB source's first packed batch through the
    device-side transform on the card equals the CPU's host transform
    (1e-5), and a narrow CaffeNet step on it launches K1 and K2 twice
    each with a finite loss."""
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.proto import SolverParameter
    from caffeonspark_tpu_torch.solver import Solver
    make = _store_source(store, str(tmp_path / store))
    cpu = make()
    recs = list(cpu.shuffled_records(0))[:4]
    want = cpu.next_batch(recs)
    monkeypatch.setenv("COS_DEVICE_TRANSFORM", "1")
    card = make()
    assert card.enable_device_transform() is not None
    got = card.apply_device_stage(card.next_batch(recs), cuda_card)
    assert got["data"].device.type == "cuda"
    _close(got["data"].cpu(), want["data"], rtol=1e-5, atol=1e-5)
    assert torch.equal(got["label"].cpu(), torch.from_numpy(want["label"]))
    npm = zoo.caffenet(batch_size=4, num_classes=10, crop=67)
    for lp in npm.layer:
        if lp.name in NARROW_CAFFENET:
            p = (lp.convolution_param if lp.type == "Convolution"
                 else lp.inner_product_param)
            p.num_output = NARROW_CAFFENET[lp.name]
    solver = Solver(SolverParameter.from_text(
        'base_lr: 0.01 momentum: 0.9 random_seed: 3'), npm,
        device=cuda_card)
    params, state = solver.init()
    K.reset_launch_counts()
    loss, _ = solver.train_step(params, state, to_device(want, cuda_card))
    assert np.isfinite(loss.item())
    assert K.launch_counts["lrn_across_channels"] == 2
    assert K.launch_counts["lrn_across_channels_bwd"] == 2


HDF5_SINK_NET = """
name: "sink"
layer { name: "data" type: "Input" top: "data" top: "target"
  input_param { shape { dim: 4 dim: 16 } shape { dim: 4 dim: 8 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 8 weight_filler { type: "xavier" } } }
layer { name: "out" type: "HDF5Output" bottom: "ip" bottom: "target"
  hdf5_output_param { file_name: "unused.h5" } }
layer { name: "loss" type: "EuclideanLoss" bottom: "ip" bottom: "target"
  top: "loss" }
"""


@pytest.mark.cuda
def test_hdf5_output_side_channel_under_a_cuda_graph_on_card(cuda_card):
    """A net with an HDF5Output captures as a CUDA graph of 4 steps
    (COS_STEPS_PER_LOOP's path): its side channel stays out of the
    params, and 2 blocks of 4 graphed steps equal 8 eager steps bit for
    bit; an eager forward records the bottoms on the card."""
    from caffeonspark_tpu_torch.data.hdf5 import collect_hdf5_outputs
    from caffeonspark_tpu_torch.proto import NetParameter, SolverParameter
    from caffeonspark_tpu_torch.solver import Solver
    rng = np.random.RandomState(2)
    blocks = [{"data": torch.from_numpy(rng.randn(4, 4, 16).astype(
                   np.float32)).to(cuda_card),
               "target": torch.from_numpy(rng.randn(4, 4, 8).astype(
                   np.float32)).to(cuda_card)} for _ in range(2)]

    def solver():
        s = Solver(SolverParameter.from_text(
            'base_lr: 0.01 momentum: 0.9 random_seed: 1'),
            NetParameter.from_text(HDF5_SINK_NET), device=cuda_card)
        return (s,) + s.init()

    s1, p1, st1 = solver()
    for b in blocks:
        for i in range(4):
            s1.train_step(p1, st1, {k: v[i] for k, v in b.items()})
    s2, p2, st2 = solver()
    many = s2.train_step_many(4)
    for b in blocks:
        many(p2, st2, b)
    assert many.captures == 1 and many.replays == 1
    assert set(p2) == {"ip"}
    for bn in p1["ip"]:
        assert torch.equal(p1["ip"][bn], p2["ip"][bn]), bn
    state = {}
    s2.train_net(p2, {k: v[0] for k, v in blocks[0].items()},
                 state_out=state)
    outs = collect_hdf5_outputs(state)
    assert list(outs) == ["out"] and outs["out"][0].device.type == "cuda"
    assert torch.equal(outs["out"][1], blocks[0]["target"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["lrn", "bias_relu_lrn"])
def test_dp2_step_equals_dp1_on_card(cuda_card, fused, monkeypatch):
    """ParallelSolver's dp 2 step on the card (two ranks sharing it) of
    CaffeNet at its published conv and LRN widths (96 x 27 x 27 and
    256 x 13 x 13 LRNs), or of AlexNet under COS_FUSE_BIAS_RELU_LRN=1
    (the fused stem at 96 x 55 x 55 and 256 x 27 x 27), at B 8 and 10
    classes, against the single-device step (the dropout mask drawn
    once for the global batch), cuDNN deterministic: K1 / K2 (K3 / K4)
    launched twice as often, the loss within 1e-5, and each reduced
    gradient no farther from the same step in float64 on the CPU than
    twice dp 1's distance plus 1e-4 of its max (f32 sums that cancel,
    conv1's and conv2's weight gradients, move by up to 1e-2 of their
    max with any change of the reductions' order, at dp 1 as at dp 2)."""
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.parallel import ParallelSolver, build_mesh
    from caffeonspark_tpu_torch.proto import SolverParameter
    from caffeonspark_tpu_torch.solver import Solver
    if fused:
        monkeypatch.setenv("COS_FUSE_BIAS_RELU_LRN", "1")
    torch.backends.cudnn.deterministic = True
    npm = (zoo.alexnet if fused else zoo.caffenet)(batch_size=8,
                                                   num_classes=10)
    sp = SolverParameter.from_text(
        "base_lr: 0.01 momentum: 0.9 random_seed: 3")
    solver = Solver(sp, npm, device=cuda_card)
    rng = np.random.RandomState(2)
    host = {"data": rng.randn(8, 3, 227, 227).astype(np.float32) * 40,
            "label": rng.randint(0, 10, 8).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda_card) for k, v in host.items()}
    params, _ = solver.init()
    cpu64 = Solver(sp, npm, device="cpu", dtype=torch.float64)
    cpu64.generator.manual_seed(5)
    _, _, g64 = cpu64.loss_and_grads(
        {ln: {bn: t.cpu().double() for bn, t in bl.items()}
         for ln, bl in params.items()},
        {k: torch.from_numpy(v).double() for k, v in host.items()})
    names = (("bias_relu_lrn_across_channels",
              "bias_relu_lrn_across_channels_bwd") if fused
             else ("lrn_across_channels", "lrn_across_channels_bwd"))
    counts, grads = [], []
    for stepper in (solver, ParallelSolver(solver, build_mesh(
            dp=2, devices=[cuda_card] * 2))):
        solver.generator.manual_seed(5)
        K.reset_launch_counts()
        loss, _, g = stepper.loss_and_grads(params, batch)
        torch.cuda.synchronize()
        counts.append([K.launch_counts[n] for n in names])
        grads.append((float(loss), g))
    assert counts[0] == [2, 2] and counts[1] == [4, 4]
    (l1, g1), (l2, g2) = grads
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    for ln, bl in g64.items():
        for bn, r in bl.items():
            top = max(float(r.abs().max()), 1e-300)
            e1 = float((g1[ln][bn].cpu().double() - r).abs().max()) / top
            e2 = float((g2[ln][bn].cpu().double() - r).abs().max()) / top
            assert e2 <= 2 * e1 + 1e-4, (ln, bn, e1, e2)


@pytest.mark.cuda
@pytest.mark.parametrize("zero", [False, True], ids=["dp2", "dp2_zero"])
def test_graphed_dp2_steps_equal_eager_on_card(cuda_card, zero):
    """ParallelSolver's dp 2 steps as CUDA graphs of 4
    (train_step_many(4): the ranks' leaves, the all_reduce and, under
    ZeRO-1, the ranks' state slices captured) against 12 eager dp 2
    steps from the same init, on the narrow CaffeNet of the graph tests
    (Dropout, clip_gradients, iter_size 2): params, histories, losses
    and learning rates bit-equal, cuDNN deterministic."""
    from caffeonspark_tpu_torch.parallel import (ParallelSolver, build_mesh,
                                                 zero_state_specs)
    from caffeonspark_tpu_torch.parallel.comm import Shards
    torch.backends.cudnn.deterministic = True

    def case():
        solver, params, state, blocks, _ = _graph_case("caffenet",
                                                       cuda_card)
        ps = ParallelSolver(solver, build_mesh(dp=2,
                                               devices=[cuda_card] * 2),
                            zero_dp=zero)
        if zero:
            # the narrow net's blobs are under ZERO_MIN_NUMEL: split those
            # of 256 elements and more
            ps.state_specs = zero_state_specs(ps.param_specs,
                                              ps.layout.shapes, 2,
                                              min_numel=256)
        return ps, ps.shard_params(params), ps.shard_opt_state(state), \
            blocks

    ps, pa, sa, blocks = case()
    want = []
    for b in blocks:
        for i in range(4):
            loss, out = ps.train_step(pa, sa, {k: v[i] for k, v in b.items()})
            want.append((loss.item(), float(out["lr"])))
    ps2, pb, sb, _ = case()
    many = ps2.train_step_many(4)
    got = []
    for b in blocks:
        losses, out = many(pb, sb, b)
        got += list(zip(losses.tolist(), out["lr"].tolist()))
    assert many.captures == 1 and many.replays == 2
    assert got == want
    split = 0
    for tree_a, tree_b in ((pa, pb), (sa.history, sb.history),
                           (sa.history2, sb.history2)):
        for ln in tree_a:
            for bn in tree_a[ln]:
                a, b = tree_a[ln][bn], tree_b[ln][bn]
                if isinstance(a, Shards):
                    split += 1
                    a, b = a.whole(), b.whole()
                assert torch.equal(a, b), (ln, bn)
    assert (split > 0) == zero
