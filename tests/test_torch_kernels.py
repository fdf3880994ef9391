"""The PyTorch port's kernels (K1 LRN, K3 bias+ReLU+LRN, K5 int8 matmul)
against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against four references: the Pallas kernels in
interpret mode (as tests/test_pallas.py runs them), the XLA fallback
chains `xla_lrn_across_channels` / `xla_bias_relu_lrn`, and the JAX
`int8_matmul` / `int8_inner_product`.  Inputs are made with numpy from a
seed and handed to both packages.

Tolerances: LRN rtol 2e-5 / atol 2e-6 in f32, as in test_pallas.py
(exp/log and pow differ in their last bits across the frameworks); in
bf16 the two outputs may differ by one bf16 ulp (rtol 2^-7), since each
rounds an f32 value that may differ in its last bits.  int8 products
are exact; int8_inner_product matches to 1e-6.  The CUDA kernels
themselves run only on a card: tests/test_torch_cuda.py (marker
`cuda`) and chip_smoke.py hold them against the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.ops import pallas_kernels as PK
from caffeonspark_tpu.parallel.gradsync import quantize_int8 as jax_q8
from caffeonspark_tpu_torch.ops import kernels as K
from torch_common import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 2e-5, 2e-6
BF16_RTOL = 2.0 ** -7

# test_pallas.py 21-38 and 88-136 shapes, plus an odd C and 55x55
LRN_SHAPES = [(2, 8, 4, 4), (1, 96, 55, 55), (2, 5, 7, 9), (1, 12, 9, 11),
              (2, 8, 5, 7), (1, 6, 4, 5), (1, 7, 3, 3)]


def _x(shape, seed, scale=3.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) \
        * scale


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("local_size", [3, 5])
@pytest.mark.parametrize("shape", LRN_SHAPES)
def test_lrn_plain_matches_pallas_and_xla(shape, local_size, relu):
    x = _x(shape, sum(shape) + local_size)
    alpha, beta, k = 1e-4, 0.75, 1.0
    pallas = PK.lrn_across_channels(jnp.asarray(x), local_size, alpha,
                                    beta, k, True, relu)
    xla = PK.xla_lrn_across_channels(
        jnp.maximum(jnp.asarray(x), 0) if relu else jnp.asarray(x),
        local_size, alpha, beta, k)
    got = K.lrn_across_channels(torch.from_numpy(x), local_size, alpha,
                                beta, k, fuse_relu=relu)
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got.numpy(), pallas)
    _close(got.numpy(), xla)


def test_lrn_plain_alpha_beta_k():
    """test_pallas.py:32's non-default alpha/beta/k, local_size 3."""
    x = np.random.RandomState(1).rand(1, 6, 3, 3).astype(np.float32)
    pallas = PK.lrn_across_channels(jnp.asarray(x), 3, 0.01, 0.5, 2.0,
                                    True)
    got = K.lrn_across_channels(torch.from_numpy(x), 3, 0.01, 0.5, 2.0)
    _close(got.numpy(), pallas)
    _close(got.numpy(), PK.xla_lrn_across_channels(jnp.asarray(x), 3,
                                                   0.01, 0.5, 2.0))


@pytest.mark.parametrize("local_size", [3, 5])
@pytest.mark.parametrize("shape", LRN_SHAPES)
def test_bias_relu_lrn_plain_matches_pallas_and_xla(shape, local_size):
    x = _x(shape, 7 + sum(shape), scale=2.0)
    b = np.random.RandomState(8).randn(shape[1]).astype(np.float32)
    alpha, beta, k = 0.05, 0.75, 1.0
    pallas = PK.bias_relu_lrn_across_channels(
        jnp.asarray(x), jnp.asarray(b), local_size, alpha, beta, k, True)
    xla = PK.xla_bias_relu_lrn(jnp.asarray(x), jnp.asarray(b), local_size,
                               alpha, beta, k)
    got = K.bias_relu_lrn_across_channels(
        torch.from_numpy(x), torch.from_numpy(b), local_size, alpha, beta,
        k)
    _close(got.numpy(), pallas)
    _close(got.numpy(), xla)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 6, 6), (1, 7, 9, 11)])
def test_lrn_bf16_io_f32_normalizer(shape, bias):
    """bf16 in, bf16 out, f32 normalizer (test_pallas.py:175): the port
    matches the Pallas kernel to one bf16 ulp, and the f32 XLA chain on
    the same rounded input to bf16 output rounding."""
    xf = _x(shape, 3)
    b = np.random.RandomState(4).randn(shape[1]).astype(np.float32)
    x16 = jnp.asarray(xf, jnp.bfloat16)
    xt = torch.from_numpy(xf).to(torch.bfloat16)
    if bias:
        pallas = PK.bias_relu_lrn_across_channels(
            x16, jnp.asarray(b), 5, 1e-4, 0.75, 1.0, True)
        ref = PK.xla_bias_relu_lrn(jnp.asarray(x16, jnp.float32),
                                   jnp.asarray(b), 5, 1e-4, 0.75, 1.0)
        got = K.bias_relu_lrn_across_channels(xt, torch.from_numpy(b))
    else:
        pallas = PK.lrn_across_channels(x16, 5, 1e-4, 0.75, 1.0, True)
        ref = PK.xla_lrn_across_channels(jnp.asarray(x16, jnp.float32), 5,
                                         1e-4, 0.75, 1.0)
        got = K.lrn_across_channels(xt)
    assert got.dtype == torch.bfloat16
    got32 = got.float().numpy()
    _close(got32, np.asarray(pallas, np.float32), rtol=BF16_RTOL, atol=0)
    _close(got32, ref, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m,n,kk", [(64, 128, 256), (32, 256, 128),
                                    (50, 100, 256), (1, 1000, 4096),
                                    (3, 37, 1001)])
def test_int8_matmul_plain_exact(m, n, kk):
    """Exact against the JAX int8 matmul: the Pallas kernel in interpret
    mode where the shape tiles (32x128 tiles, K % 128), XLA's int8 dot
    where it does not."""
    rng = np.random.RandomState(m + n + kk)
    xq = rng.randint(-127, 128, (m, kk)).astype(np.int8)
    wq = rng.randint(-127, 128, (n, kk)).astype(np.int8)
    ref = PK.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), interpret=True)
    got = K.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("m,n,kk", [(32, 128, 256), (16, 32, 64),
                                    (5, 10, 300)])
def test_int8_inner_product_matches_jax(m, n, kk, transpose):
    rng = np.random.RandomState(10 + m)
    x = rng.randn(m, kk).astype(np.float32)
    w = (rng.randn(n, kk) * 0.1).astype(np.float32)
    wl = np.ascontiguousarray(w.T) if transpose else w
    ref = PK.int8_inner_product(jnp.asarray(x), jnp.asarray(wl),
                                transpose=transpose, interpret=True)
    got = K.int8_inner_product(torch.from_numpy(x), torch.from_numpy(wl),
                               transpose=transpose)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_int8_inner_product_resident_weight_matches_jax():
    """The publish-time path: an int8 weight with its w_scale."""
    rng = np.random.RandomState(12)
    x = rng.randn(8, 192).astype(np.float32)
    w = (rng.randn(24, 192) * 0.05).astype(np.float32)
    wq_j, sw_j = jax_q8(jnp.asarray(w), None)
    wq_t, sw_t = K.quantize_int8(torch.from_numpy(w))
    ref = PK.int8_inner_product(jnp.asarray(x), wq_j, w_scale=sw_j,
                                interpret=True)
    got = K.int8_inner_product(torch.from_numpy(x), wq_t, w_scale=sw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="w_scale"):
        K.int8_inner_product(torch.from_numpy(x), wq_t)


@pytest.mark.parametrize("vals", [
    [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49],   # halfway cases
    None])
def test_quantize_int8_bit_equal_to_jax(vals):
    """Both frameworks round half to even, so int8 quantization matches
    bit for bit: the same int8 values and the same f32 scale."""
    if vals is None:
        a = np.random.RandomState(5).randn(7, 33).astype(np.float32) * 0.3
    else:
        a = np.asarray(vals, np.float32)
    qj, sj = jax_q8(jnp.asarray(a), None)
    qt, st = K.quantize_int8(torch.from_numpy(a))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.numpy().tobytes() == np.asarray(sj, np.float32).tobytes()
    if vals is not None:
        assert list(qt.numpy()[1:7]) == [0, 2, 2, 0, -2, -2]


def test_wrappers_route_by_device_and_count_only_launches():
    """A CPU tensor takes the plain version and launches nothing; a
    shape-only meta tensor (net construction) does the same."""
    K.reset_launch_counts()
    x = torch.from_numpy(_x((1, 6, 3, 3), 2))
    K.lrn_across_channels(x)
    K.bias_relu_lrn_across_channels(x, torch.zeros(6))
    K.int8_matmul(torch.zeros((2, 4), dtype=torch.int8),
                  torch.zeros((3, 4), dtype=torch.int8))
    meta = K.lrn_across_channels(torch.empty((2, 4, 5, 5), device="meta"))
    assert meta.shape == (2, 4, 5, 5) and meta.device.type == "meta"
    assert all(v == 0 for v in K.launch_counts.values())
