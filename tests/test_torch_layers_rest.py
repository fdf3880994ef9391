"""The stateless layer types of the PyTorch port against the JAX
package: the activations, MVN, Bias, Parameter, BatchReindex, SPP,
Deconvolution, the shape ops, the six other losses and STOCHASTIC
pooling.

Each case is one prototxt built in both packages, params and inputs
from numpy with a seed.  Tolerances: tops within 1e-6 relative (plus
1e-6 of the blob's largest element); the gradients of a weighted sum of
the tops, with respect to every param and input, within 1e-5 of their
largest element (reductions sum in other orders).  Integer-valued
inputs (labels, indices, pair labels) carry no gradient in either
package.  ArgMax's inputs are continuous draws, so they hold no ties:
the two packages order tied elements differently.

STOCHASTIC pooling's TEST mode is held against JAX; its TRAIN draw comes
from a `torch.Generator` (JAX draws from its own keys), so it is held by
its invariants: each output an element of its window, an all-zero
window giving 0, the frequencies of the picks following value / Σ, the
gradient going to the picked element, and the draw changing with the
generator's seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.ops import layers as JL
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.ops import layers as L
from caffeonspark_tpu_torch.proto import (BlobProto, LayerParameter,
                                          NetParameter, NetState, Phase)
from torch_common import cap_torch_threads

cap_torch_threads()

TOP_RTOL = 1e-6
GRAD_TOL = 1e-5


def _input(name, *dims):
    return (f'layer {{ name: "{name}" type: "Input" top: "{name}" '
            f'input_param {{ shape {{ {" ".join(f"dim: {d}" for d in dims)}'
            ' } } }\n')


def _layer(typ, bottoms, tops=("y",), extra=""):
    bots = " ".join(f'bottom: "{b}"' for b in bottoms)
    tps = " ".join(f'top: "{t}"' for t in tops)
    return f'layer {{ name: "l" type: "{typ}" {bots} {tps} {extra} }}\n'


def _one(typ, extra="", shape=(2, 3, 4, 5)):
    return _input("x", *shape) + _layer(typ, ["x"], extra=extra)


GAUSS = 'filler { type: "gaussian" std: 0.5 }'
W_GAUSS = 'weight_filler { type: "gaussian" std: 0.3 }'
B_GAUSS = 'bias_filler { type: "gaussian" std: 0.2 }'


def _loss(typ, shapes, extra=""):
    names = ["a", "b", "c"][:len(shapes)]
    return ("".join(_input(n, *s) for n, s in zip(names, shapes))
            + _layer(typ, names, extra=extra))


# inputs by name: "pos" (0.1, 2.1), "prob" (rows of a softmax), "label"
# (integer class ids), "pair" (0 / 1), "unit" (0, 1), "idx" (0..3);
# anything else a normal draw * 2 + 0.5
CASES = {
    "prelu": (_one("PReLU", f"prelu_param {{ {GAUSS} }}"), {}),
    "prelu-shared": (_one("PReLU", "prelu_param { channel_shared: true "
                                   f"{GAUSS} }}"), {}),
    "prelu-default-slope": (_one("PReLU"), {}),
    "elu": (_one("ELU", "elu_param { alpha: 0.5 }"), {}),
    "sigmoid": (_one("Sigmoid"), {}),
    "tanh": (_one("TanH"), {}),
    "absval": (_one("AbsVal"), {}),
    "bnll": (_one("BNLL"), {}),
    "power-square": (_one("Power", "power_param { power: 2 scale: 0.5 "
                                   "shift: 1 }"), {}),
    "power-sqrt": (_one("Power", "power_param { power: 0.5 scale: 2 "
                                 "shift: 0.5 }"), {"x": "pos"}),
    "power-affine": (_one("Power", "power_param { scale: -1.5 shift: 0.25 }"),
                     {}),
    "exp": (_one("Exp", "exp_param { scale: 0.5 shift: 0.1 }"), {}),
    "exp-base2": (_one("Exp", "exp_param { base: 2 scale: 0.7 }"), {}),
    "log": (_one("Log", "log_param { scale: 1.5 shift: 0.2 }"),
            {"x": "pos"}),
    "log-base10": (_one("Log", "log_param { base: 10 }"), {"x": "pos"}),
    "threshold": (_one("Threshold", "threshold_param { threshold: 0.3 }"),
                  {}),
    "mvn": (_one("MVN"), {}),
    "mvn-across": (_one("MVN", "mvn_param { across_channels: true }"), {}),
    "mvn-mean-only": (_one("MVN", "mvn_param { normalize_variance: false }"),
                      {}),
    "bias": (_one("Bias", f"bias_param {{ {GAUSS} }}"), {}),
    "bias-axis0-2axes": (_one("Bias", f"bias_param {{ axis: 0 num_axes: 2 "
                                      f"{GAUSS} }}"), {}),
    "bias-num_axes-1": (_one("Bias", f"bias_param {{ num_axes: -1 "
                                     f"{GAUSS} }}"), {}),
    "bias-two-bottoms": (_input("x", 2, 3, 4, 5) + _input("b", 3, 4)
                         + _layer("Bias", ["x", "b"],
                                  extra="bias_param { num_axes: 2 }"), {}),
    "parameter": ('layer { name: "l" type: "Parameter" top: "y" '
                  'parameter_param { shape { dim: 2 dim: 3 } } }\n', {}),
    "batch_reindex": (_input("x", 4, 3, 2) + _input("i", 6)
                      + _layer("BatchReindex", ["x", "i"]), {"i": "idx"}),
    "spp-max": (_one("SPP", "spp_param { pyramid_height: 3 }",
                     (2, 3, 13, 11)), {}),
    "spp-ave": (_one("SPP", "spp_param { pyramid_height: 3 pool: AVE }",
                     (2, 3, 13, 11)), {}),
    "deconv": (_one("Deconvolution", "convolution_param { num_output: 4 "
                    f"kernel_size: 4 stride: 2 pad: 1 {W_GAUSS} {B_GAUSS} }}",
                    (2, 3, 5, 6)), {}),
    "deconv-group-dilation": (_one("Deconvolution", "convolution_param { "
                                   "num_output: 4 kernel_size: 3 stride: 2 "
                                   f"group: 2 dilation: 2 {W_GAUSS} "
                                   f"{B_GAUSS} }}", (2, 4, 5, 5)), {}),
    "deconv-fcn-head": (_one("Deconvolution", "convolution_param { "
                             "num_output: 3 bias_term: false kernel_size: 16 "
                             f"stride: 8 {W_GAUSS} }}", (1, 3, 3, 3)), {}),
    "reshape": (_one("Reshape", "reshape_param { shape { dim: 0 dim: -1 "
                                "dim: 5 } }"), {}),
    "reshape-axis": (_one("Reshape", "reshape_param { axis: 1 num_axes: 2 "
                                     "shape { dim: 12 } }"), {}),
    "slice-points": (_input("x", 2, 6, 3)
                     + _layer("Slice", ["x"], ("y0", "y1", "y2"),
                              "slice_param { axis: 1 slice_point: 1 "
                              "slice_point: 4 }"), {}),
    "slice-even": (_input("x", 4, 3, 2)
                   + _layer("Slice", ["x"], ("y0", "y1"),
                            "slice_param { axis: 0 }"), {}),
    "tile": (_one("Tile", "tile_param { axis: 2 tiles: 3 }"), {}),
    "reduction-sum": (_one("Reduction", "reduction_param { axis: 1 }"), {}),
    "reduction-asum": (_one("Reduction", "reduction_param { operation: ASUM "
                                         "axis: 2 coeff: 0.5 }"), {}),
    "reduction-sumsq": (_one("Reduction", "reduction_param { operation: "
                                          "SUMSQ axis: -1 }"), {}),
    "reduction-mean": (_one("Reduction", "reduction_param { operation: MEAN "
                                         "coeff: -2 }"), {}),
    "crop": (_input("x", 2, 3, 9, 8) + _input("r", 2, 3, 5, 4)
             + _layer("Crop", ["x", "r"],
                      extra="crop_param { axis: 2 offset: 3 offset: 1 }"),
             {}),
    "crop-axis1": (_input("x", 2, 5, 9, 8) + _input("r", 2, 3, 5, 5)
                   + _layer("Crop", ["x", "r"],
                            extra="crop_param { axis: 1 offset: 2 }"), {}),
    "silence": (_input("x", 2, 3) + _input("z", 4)
                + 'layer { name: "s" type: "Silence" bottom: "z" }\n'
                + _layer("TanH", ["x"]), {}),
    "argmax-axis": (_one("ArgMax", "argmax_param { axis: 1 top_k: 2 }"), {}),
    "argmax-axis-values": (_one("ArgMax", "argmax_param { axis: -1 top_k: 3 "
                                          "out_max_val: true }"), {}),
    "argmax-flat": (_one("ArgMax", "argmax_param { top_k: 3 }"), {}),
    "argmax-flat-values": (_one("ArgMax", "argmax_param { top_k: 2 "
                                          "out_max_val: true }"), {}),
    "euclidean": (_loss("EuclideanLoss", [(6, 5), (6, 5)]), {}),
    "sigmoid_cross_entropy": (_loss("SigmoidCrossEntropyLoss",
                                    [(6, 5), (6, 5)]), {"b": "unit"}),
    "contrastive": (_loss("ContrastiveLoss", [(8, 4), (8, 4), (8,)],
                          "contrastive_loss_param { margin: 3 }"),
                    {"c": "pair"}),
    "contrastive-legacy": (_loss("ContrastiveLoss", [(8, 4), (8, 4), (8,)],
                                 "contrastive_loss_param { margin: 6 "
                                 "legacy_version: true }"), {"c": "pair"}),
    "hinge-l1": (_loss("HingeLoss", [(6, 5), (6,)]), {"b": "label"}),
    "hinge-l2": (_loss("HingeLoss", [(6, 5), (6,)],
                       "hinge_loss_param { norm: L2 }"), {"b": "label"}),
    "multinomial_logistic": (_loss("MultinomialLogisticLoss",
                                   [(6, 5), (6,)]),
                             {"a": "prob", "b": "label"}),
    "infogain-bottom": (_loss("InfogainLoss", [(6, 5), (6,), (5, 5)]),
                        {"a": "prob", "b": "label", "c": "pos"}),
    "infogain-source": (_loss("InfogainLoss", [(6, 5), (6,)],
                              'infogain_loss_param { source: "{src}" }'),
                        {"a": "prob", "b": "label"}),
    "infogain-identity": (_loss("InfogainLoss", [(6, 5), (6,)]),
                          {"a": "prob", "b": "label"}),
    "stochastic-test": (_one("Pooling", "pooling_param { pool: STOCHASTIC "
                                        "kernel_size: 3 stride: 2 }",
                             (2, 3, 7, 8)), {"x": "pos"}),
    "stochastic-test-ceil": (_one("Pooling", "pooling_param { pool: "
                                             "STOCHASTIC kernel_size: 2 "
                                             "stride: 2 }", (2, 2, 5, 5)),
                             {"x": "pos"}),
}
# every type this file covers
NEW_TYPES = sorted({"PReLU", "ELU", "Sigmoid", "TanH", "AbsVal", "BNLL",
                    "Power", "Exp", "Log", "Threshold", "MVN", "Bias",
                    "Parameter", "BatchReindex", "SPP", "Deconvolution",
                    "Reshape", "Slice", "Tile", "Reduction", "Crop",
                    "Silence", "ArgMax", "EuclideanLoss",
                    "SigmoidCrossEntropyLoss", "ContrastiveLoss",
                    "HingeLoss", "MultinomialLogisticLoss", "InfogainLoss"})
REFUSED = ("MixtureOfExperts",)


def _draw(kind, shape, rng):
    if kind == "pos":
        return (rng.rand(*shape) * 2 + 0.1).astype(np.float32)
    if kind == "unit":
        return rng.rand(*shape).astype(np.float32)
    if kind == "pair":
        return rng.randint(0, 2, shape).astype(np.float32)
    if kind == "idx":
        return rng.randint(0, 4, shape).astype(np.float32)
    if kind == "prob":
        z = np.exp(rng.randn(*shape))
        return (z / z.sum(axis=-1, keepdims=True)).astype(np.float32)
    return (rng.randn(*shape) * 2 + 0.5).astype(np.float32)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _case_text(case, tmp_path):
    text, kinds = CASES[case]
    if "{src}" in text:
        h = np.random.RandomState(3).rand(5, 5).astype(np.float32) + 0.2
        src = tmp_path / "infogain.binaryproto"
        src.write_bytes(BlobProto(data=[float(v) for v in h.ravel()])
                        .to_binary())
        text = text.replace("{src}", str(src))
    return text, kinds


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case, tmp_path):
    """Tops and the gradients of every param and input."""
    text, kinds = _case_text(case, tmp_path)
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=int(Phase.TEST)))
    tnet = Net(NetParameter.from_text(text), NetState(phase=Phase.TEST),
               device="cpu")
    rng = np.random.RandomState(11)
    inputs = {n: _draw(kinds.get(n, "normal"), s, rng)
              for n, s, _ in tnet.input_specs}
    if "label" in kinds.values():
        c = tnet.input_specs[0][1][1]
        for n, k in kinds.items():
            if k == "label":
                inputs[n] = rng.randint(0, c, inputs[n].shape).astype(
                    np.float32)
    arrays = {ln: {bn: (rng.randn(*s) * 0.5).astype(np.float32)
                   for bn, s, _ in specs}
              for ln, specs in tnet.param_layout.items()}
    weights = {t: np.asarray(rng.randn(*tnet.blob_shapes[t]), np.float32)
               for t in tnet.output_blobs if t not in inputs}
    assert weights

    def jloss(p, x):
        blobs, _ = jnet.apply(p, x, train=False)
        return (sum(jnp.sum(blobs[t] * w) for t, w in weights.items()),
                blobs)

    (_, jblobs), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
         for ln, bl in arrays.items()},
        {n: jnp.asarray(a) for n, a in inputs.items()})

    tp = {ln: {bn: t.requires_grad_(True) for bn, t in bl.items()}
          for ln, bl in convert.params_from_numpy(tnet, arrays).items()}
    tx = {n: torch.from_numpy(a).requires_grad_(True)
          for n, a in inputs.items()}
    blobs = tnet(tp, tx)
    total = sum(torch.sum(blobs[t] * torch.from_numpy(w))
                for t, w in weights.items())
    leaves = [t for bl in tp.values() for t in bl.values()] + list(
        tx.values())
    # ArgMax's indices and Threshold's steps reach no gradient
    grads = (torch.autograd.grad(total, leaves, allow_unused=True)
             if total.requires_grad else [None] * len(leaves))
    for t in weights:
        assert tuple(blobs[t].shape) == tuple(jblobs[t].shape), t
        _close(blobs[t].detach(), jblobs[t], TOP_RTOL, f"top {t}")
    jflat = [jgp[ln][bn] for ln, bl in tp.items() for bn in bl] + [
        jgx[n] for n in tx]
    names = [f"{ln}/{bn}" for ln, bl in tp.items() for bn in bl] + list(tx)
    for g, jg, what in zip(grads, jflat, names):
        if g is None:
            assert not np.any(np.asarray(jg)), what
        else:
            _close(g, jg, GRAD_TOL, f"grad {what}")


def test_get_op_serves_every_type_but_the_refused():
    """Every layer type of the JAX package but MixtureOfExperts is served
    (the four data and output types since the data-path slice); it is
    refused by name."""
    served = set(L._REGISTRY)
    assert set(NEW_TYPES) <= served
    assert {"LSTM", "RNN"} <= served
    assert set(JL._REGISTRY) - served == set(REFUSED)
    for name in REFUSED:
        with pytest.raises(NotImplementedError, match=name):
            L.get_op(name)


# ---------------------------------------------------------------------------
# STOCHASTIC pooling at TRAIN: the invariants of the draw
# ---------------------------------------------------------------------------

def _stoch_lp(k=2, s=2):
    return LayerParameter.from_text(
        'name: "p" type: "Pooling" bottom: "x" top: "y" pooling_param { '
        f'pool: STOCHASTIC kernel_size: {k} stride: {s} }}')


def _train(x, seed, lp=None):
    g = torch.Generator().manual_seed(seed)
    ctx = L.Ctx(train=True, generator=g, layer_name="p")
    return L.get_op("Pooling").apply(ctx, lp or _stoch_lp(), [], [x])[0]


def test_stochastic_train_picks_window_elements():
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 6, 7)
                         .astype(np.float32))
    x[0, 0, :2, :2] = 0.0                 # one all-zero window
    lp = _stoch_lp(3, 2)
    y = _train(x, 1, lp)
    assert tuple(y.shape) == (2, 3, 3, 3)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 1))    # the ceil-mode tail
    for n in range(2):
        for c in range(3):
            for i in range(3):
                for j in range(3):
                    win = xp[n, c, 2 * i:2 * i + 3, 2 * j:2 * j + 3]
                    assert bool((win == y[n, c, i, j]).any())
    y2 = _train(x, 1, _stoch_lp())
    assert float(y2[0, 0, 0, 0]) == 0.0
    # the draw follows the generator: the same seed repeats it, another
    # seed changes it
    assert torch.equal(_train(x, 1, lp), y)
    assert not torch.equal(_train(x, 2, lp), y)
    with pytest.raises(ValueError, match="generator"):
        L.get_op("Pooling").apply(L.Ctx(train=True, layer_name="p"), lp, [],
                                  [x])


def test_stochastic_train_frequencies_and_gradient():
    """Over 4,000 windows each value v of [1, 3, 2, 4] is picked with
    probability v / 10, within 0.03 (about 5 standard deviations of a
    frequency of 0.4 over 4,000 draws); the gradient is one-hot at the
    pick."""
    win = torch.tensor([[1.0, 3.0], [2.0, 4.0]])
    x = win.repeat(40, 100).reshape(1, 1, 80, 200)
    y = _train(x, 7)
    picks = y.ravel()
    for v in (1.0, 2.0, 3.0, 4.0):
        freq = float((picks == v).float().mean())
        assert abs(freq - v / 10.0) < 0.03, (v, freq)
    xg = win.reshape(1, 1, 2, 2).clone().requires_grad_(True)
    out = _train(xg, 3)
    (g,) = torch.autograd.grad(out.sum(), xg)
    assert sorted(g.ravel().tolist()) == [0.0, 0.0, 0.0, 1.0]
    assert float(g.ravel()[int(torch.argmax(g.ravel()))]) == 1.0
    assert float((xg.detach() * g).sum()) == float(out.detach())
