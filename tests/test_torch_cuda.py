"""The port's CUDA kernels on the card against their plain PyTorch
versions (marker `cuda`; each test skips where there is no card).

This file imports torch, numpy and the port only, so that it runs on a
machine with a card and no JAX:

    COS_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_cuda.py

(COS_TPU_TESTS=1 keeps tests/conftest.py from importing jax.)
chip_smoke.py repeats these checks at the serving and training shapes.
Tolerances: forward rtol 2e-5 / atol 2e-6, backward rtol 3e-4 /
atol 3e-5, int8 exact; every check so far has been bit-equal.
"""

import numpy as np
import pytest
import torch

from caffeonspark_tpu_torch.ops import kernels as K

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
                x, b, dy, ls, ALPHA, BETA, KK).cpu(),
                K.bias_relu_lrn_bwd_plain(x, b, dy, ls, ALPHA, BETA,
                                          KK).cpu(), 3e-4, 3e-5)


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
        "bias_relu_lrn_across_channels_bwd": 1, "int8_matmul": 0}
    _close(xg.grad.cpu(), K.lrn_bwd_plain(x, dy, 5, ALPHA, BETA, KK).cpu(),
           3e-4, 3e-5)
    dx = K.bias_relu_lrn_bwd_plain(x, b, dy, 5, ALPHA, BETA, KK)
    _close(xb.grad.cpu(), dx.cpu(), 3e-4, 3e-5)
    _close(bg.grad.cpu(), dx.sum((0, 2, 3)).cpu(), 3e-4, 3e-5)
