"""Independent cross-checks of layer numerics against torch (CPU).

The suite's other parity tests compare against hand-derived oracles;
torch is an independent implementation of the same Caffe-era
definitions, so agreement here rules out a shared mistake:
  * Convolution (stride/pad/dilation/groups)
  * MaxPool with Caffe's ceil-mode output sizing
  * LRN ACROSS_CHANNELS (torch.nn.LocalResponseNorm implements the
    same k + (alpha/n)·sum window rule)
  * BatchNorm running-variance bias correction (torch's unbiased
    running_var update == Caffe's m/(m-1) factor — the round-2 advisor
    fix, batch_norm_layer.cpp)
"""

import numpy as np
import pytest
from torch_common import cap_torch_threads

cap_torch_threads()

torch = pytest.importorskip("torch")

import jax
from caffeonspark_tpu.net import Net
from caffeonspark_tpu.proto import NetParameter


def _single_layer_net(layer_text, in_shape):
    dims = " ".join(f"dim: {d}" for d in in_shape)
    npm = NetParameter.from_text(f"""
name: "t"
layer {{ name: "x" type: "Input" top: "x"
  input_param {{ shape {{ {dims} }} }} }}
{layer_text}
""")
    return Net(npm)


def _run(net, params, x, train=False):
    blobs, state = net.apply(params, {"x": x}, train=train)
    top = [t for lp in net.compute_layers for t in lp.top][-1]
    return np.asarray(blobs[top]), state


def test_conv_matches_torch():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 13, 15).astype(np.float32)
    net = _single_layer_net("""
layer { name: "c" type: "Convolution" bottom: "x" top: "c"
  convolution_param { num_output: 8 kernel_h: 3 kernel_w: 5
    stride_h: 2 stride_w: 1 pad_h: 1 pad_w: 2 dilation: 2 group: 2
    weight_filler { type: "gaussian" std: 0.1 } } }""",
        x.shape)
    params = net.init(jax.random.key(0))
    got, _ = _run(net, params, x)

    conv = torch.nn.Conv2d(6, 8, (3, 5), stride=(2, 1), padding=(1, 2),
                           dilation=2, groups=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            np.asarray(params["c"]["weight"])))
        conv.bias.copy_(torch.from_numpy(np.asarray(params["c"]["bias"])))
        want = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_maxpool_ceil_mode_matches_torch():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 10, 10).astype(np.float32)
    # 10 with k3 s2: ceil((10-3)/2)+1 = 5 (floor mode would give 4) —
    # exercises Caffe's ceil-mode sizing, which torch ceil_mode matches
    net = _single_layer_net("""
layer { name: "p" type: "Pooling" bottom: "x" top: "p"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }""",
        x.shape)
    params = net.init(jax.random.key(0))
    got, _ = _run(net, params, x)
    want = torch.nn.functional.max_pool2d(
        torch.from_numpy(x), 3, stride=2, ceil_mode=True).numpy()
    assert got.shape == want.shape == (2, 3, 5, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_lrn_matches_torch():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 7, 9).astype(np.float32)
    net = _single_layer_net("""
layer { name: "n" type: "LRN" bottom: "x" top: "n"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 k: 2.0 } }""",
        x.shape)
    params = net.init(jax.random.key(0))
    got, _ = _run(net, params, x)
    want = torch.nn.functional.local_response_norm(
        torch.from_numpy(x), 5, alpha=1e-4, beta=0.75, k=2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_batchnorm_running_stats_match_torch():
    """TRAIN-phase forward + running-stat update vs torch BatchNorm2d
    (momentum such that torch's update matches Caffe's moving-average
    accumulation for one step from zero state)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 5, 6, 7).astype(np.float32)
    net = _single_layer_net("""
layer { name: "bn" type: "BatchNorm" bottom: "x" top: "bn"
  batch_norm_param { eps: 1e-5 } }""",
        x.shape)
    params = net.init(jax.random.key(0))
    got, state = _run(net, params, x, train=True)

    bn = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=1.0, affine=False)
    bn.train()
    want = bn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    # Caffe stores sums scaled by the accumulated count; after one
    # update from zero state count==1, so mean_b/var_b ARE the stats.
    new_mean, new_var, new_count = state["bn"]
    np.testing.assert_allclose(np.asarray(new_count), [1.0], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(new_mean),
                               bn.running_mean.numpy(),
                               rtol=1e-4, atol=1e-5)
    # torch running_var uses the UNBIASED batch variance — exactly
    # Caffe's m/(m-1) bias_correction_factor (the advisor fix)
    np.testing.assert_allclose(np.asarray(new_var),
                               bn.running_var.numpy(),
                               rtol=1e-4, atol=1e-5)
