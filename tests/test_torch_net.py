"""The PyTorch port's layers and Net against the JAX package's `Net`.

Same prototxt in both packages, parameters moved from the JAX net to
the port through numpy (`convert.params_from_numpy`) or through a
.caffemodel, inputs made with numpy from a seed.  Tolerance in f32:
rtol 1e-4, atol 1e-5 — the frameworks' convolutions sum in different
orders (XLA's CPU conv vs PyTorch's), which moves the last bits, and
the LRN/pooling layers pass those differences on.
"""

import numpy as np
import pytest
import torch

from caffeonspark_tpu import checkpoint as jax_ckpt
from caffeonspark_tpu.data.transformer import Transformer as JaxTransformer
from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import Phase as JaxPhase
from caffeonspark_tpu.proto import TransformationParameter as JaxTP
from caffeonspark_tpu_torch import checkpoint
from caffeonspark_tpu_torch.convert import params_from_numpy
from caffeonspark_tpu_torch.data.transformer import Transformer
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.proto import (NetState, Phase,
                                          TransformationParameter)
from torch_port_helpers import (jax_params_numpy, narrow_net_text,
                                torch_net_param)
from torch_common import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-4, 1e-5
FUSE_ENVS = {"unfused": {}, "relu": {"COS_FUSE_RELU_LRN": "1"},
             "bias_relu": {"COS_FUSE_BIAS_RELU_LRN": "1"}}


def _pair(text: str):
    """(JAX TEST-phase Net, port TEST-phase Net on the CPU) of one
    prototxt."""
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=JaxPhase.TEST))
    tnet = Net(torch_net_param(text), NetState(phase=Phase.TEST),
               device="cpu")
    return jnet, tnet


def _inputs(net, seed, scale=255.0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape, kind in net.input_specs:
        out[name] = (rng.randint(0, 10, shape).astype(np.float32)
                     if kind == "label"
                     else rng.rand(*shape).astype(np.float32) * scale)
    return out


def _run_both(text, seed=0, scale=255.0):
    jnet, tnet = _pair(text)
    pn = jax_params_numpy(jnet, seed)
    feeds = _inputs(jnet, seed + 1, scale)
    jblobs, _ = jnet.apply({ln: {bn: a for bn, a in bl.items()}
                            for ln, bl in pn.items()}, feeds, train=False)
    tblobs = tnet(params_from_numpy(tnet, pn),
                  {k: torch.from_numpy(v) for k, v in feeds.items()})
    return jnet, tnet, jblobs, tblobs


@pytest.mark.parametrize("name", ["caffenet", "alexnet", "lenet"])
def test_zoo_builds_the_jax_graphs(name):
    mine = getattr(zoo, name)(32) if name == "lenet" else \
        getattr(zoo, name)(batch_size=32, num_classes=7, crop=99)
    ref = getattr(jax_zoo, name)(32) if name == "lenet" else \
        getattr(jax_zoo, name)(batch_size=32, num_classes=7, crop=99)
    assert mine.to_text() == ref.to_text()


@pytest.mark.parametrize("name", ["caffenet", "alexnet", "lenet"])
@pytest.mark.parametrize("env", list(FUSE_ENVS))
def test_peephole_sets_match_jax(name, env, monkeypatch):
    for k, v in FUSE_ENVS[env].items():
        monkeypatch.setenv(k, v)
    jnet, tnet = _pair(narrow_net_text(name))
    assert tnet.fused_relu_lrn == jnet.fused_relu_lrn
    assert tnet.fused_bias_lrn == jnet.fused_bias_lrn
    assert [lp.name for lp in tnet.compute_layers] == \
        [lp.name for lp in jnet.compute_layers]
    assert tnet.blob_shapes == jnet.blob_shapes
    assert tnet.output_blobs == jnet.output_blobs
    assert {ln: [(b, s) for b, s, _ in sp]
            for ln, sp in tnet.param_layout.items()} == \
        {ln: [(b, s) for b, s, _ in sp]
         for ln, sp in jnet.param_layout.items()}
    if name == "alexnet" and env != "unfused":
        assert tnet.fused_relu_lrn == {"norm1", "norm2"}
    if name == "alexnet" and env == "bias_relu":
        assert tnet.fused_bias_lrn == {"norm1": "conv1", "norm2": "conv2"}
    if name == "caffenet":       # pool sits between relu and norm
        assert not tnet.fused_relu_lrn


@pytest.mark.parametrize("name", ["caffenet", "alexnet", "lenet"])
def test_fusion_predicates_match_jax(name):
    """fusable_relu_for_lrn / prefuse_conv_bias_eligible, re-implemented
    in the port, give the JAX package's answer for every LRN layer."""
    from caffeonspark_tpu import net as jax_net_mod
    from caffeonspark_tpu_torch import net as net_mod
    text = narrow_net_text(name)
    jl = list(JaxNetParameter.from_text(text).layer)
    tl = list(torch_net_param(text).layer)
    for i, lp in enumerate(tl):
        jr = jax_net_mod.fusable_relu_for_lrn(jl, jl[i])
        tr = net_mod.fusable_relu_for_lrn(tl, lp)
        assert (tr.name if tr else None) == (jr.name if jr else None)
        if tr is not None:
            ri = tl.index(tr)
            assert net_mod.prefuse_conv_bias_eligible(tl, lp, tr) == \
                jax_net_mod.prefuse_conv_bias_eligible(jl, jl[i], jl[ri])
    if name == "alexnet":
        norm1 = next(lp for lp in tl if lp.name == "norm1")
        assert net_mod.fusable_relu_for_lrn(tl, norm1).name == "relu_conv1"


@pytest.mark.parametrize("name", ["caffenet", "alexnet"])
@pytest.mark.parametrize("env", list(FUSE_ENVS))
def test_whole_net_matches_jax(name, env, monkeypatch):
    for k, v in FUSE_ENVS[env].items():
        monkeypatch.setenv(k, v)
    jnet, tnet, jb, tb = _run_both(narrow_net_text(name))
    for blob in ("norm1", "norm2", "pool5", "fc6", "fc7", "fc8"):
        np.testing.assert_allclose(tb[blob].numpy(), np.asarray(jb[blob]),
                                   rtol=RTOL, atol=ATOL, err_msg=blob)
    for blob in tnet.output_blobs:          # accuracy, loss
        np.testing.assert_allclose(tb[blob].numpy(), np.asarray(jb[blob]),
                                   rtol=RTOL, atol=ATOL, err_msg=blob)


def test_lenet_matches_jax():
    _, tnet, jb, tb = _run_both(narrow_net_text("lenet"), scale=1.0)
    for blob in ("pool2", "ip1", "ip2", "loss", "accuracy"):
        np.testing.assert_allclose(tb[blob].numpy(), np.asarray(jb[blob]),
                                   rtol=RTOL, atol=ATOL, err_msg=blob)


def _single_layer(layer: str, shape) -> str:
    dims = " ".join(f"dim: {d}" for d in shape)
    return (f'name: "t"\nlayer {{ name: "x" type: "Input" top: "x" '
            f'input_param {{ shape {{ {dims} }} }} }}\n{layer}')


POOLS = [
    # Caffe AVE divisor = window ∩ padded extent, with pad != 0
    ("AVE", "kernel_size: 3 stride: 2 pad: 1", (2, 3, 9, 9)),
    ("AVE", "kernel_size: 3 stride: 2 pad: 1", (1, 2, 8, 10)),
    ("AVE", "kernel_h: 3 kernel_w: 2 stride_h: 2 stride_w: 3 pad_h: 1 "
            "pad_w: 1", (1, 2, 11, 7)),
    ("AVE", "kernel_size: 2 stride: 2", (1, 3, 7, 7)),
    ("MAX", "kernel_size: 3 stride: 2", (2, 4, 13, 13)),   # ceil mode
    ("MAX", "kernel_size: 3 stride: 2 pad: 1", (1, 2, 8, 8)),
    ("MAX", "global_pooling: true", (2, 3, 5, 6)),
    ("AVE", "global_pooling: true", (2, 3, 5, 6)),
]


@pytest.mark.parametrize("method,geom,shape", POOLS)
def test_pooling_matches_jax(method, geom, shape):
    text = _single_layer(
        f'layer {{ name: "p" type: "Pooling" bottom: "x" top: "p" '
        f'pooling_param {{ pool: {method} {geom} }} }}', shape)
    jnet, tnet, jb, tb = _run_both(text, scale=1.0)
    assert tuple(tb["p"].shape) == tuple(jb["p"].shape)
    np.testing.assert_allclose(tb["p"].numpy(), np.asarray(jb["p"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("geom,shape", [
    ("num_output: 8 kernel_size: 3 group: 2 pad: 1", (2, 6, 9, 9)),
    ("num_output: 8 kernel_h: 3 kernel_w: 5 stride_h: 2 stride_w: 1 "
     "pad_h: 1 pad_w: 2 dilation: 2 group: 2", (2, 6, 13, 15)),
    ("num_output: 4 kernel_size: 11 stride: 4", (1, 3, 35, 35)),
])
def test_grouped_dilated_conv_matches_jax(geom, shape):
    text = _single_layer(
        f'layer {{ name: "c" type: "Convolution" bottom: "x" top: "c" '
        f'convolution_param {{ {geom} weight_filler {{ type: "gaussian" '
        f'std: 0.1 }} bias_filler {{ type: "uniform" min: -1 max: 1 }} '
        f'}} }}', shape)
    _, _, jb, tb = _run_both(text, scale=1.0)
    np.testing.assert_allclose(tb["c"].numpy(), np.asarray(jb["c"]),
                               rtol=RTOL, atol=ATOL)


def test_within_channel_lrn_and_softmax_match_jax():
    text = _single_layer(
        'layer { name: "n" type: "LRN" bottom: "x" top: "n" lrn_param { '
        'local_size: 3 alpha: 0.1 beta: 0.75 norm_region: WITHIN_CHANNEL '
        '} }\nlayer { name: "s" type: "Softmax" bottom: "n" top: "s" }',
        (2, 4, 5, 5))
    _, _, jb, tb = _run_both(text, scale=2.0)
    for blob in ("n", "s"):
        np.testing.assert_allclose(tb[blob].numpy(), np.asarray(jb[blob]),
                                   rtol=RTOL, atol=ATOL)


def test_serving_load_inits_only_layers_the_file_lacks(tmp_path):
    """A model file without fc8 (a finetune source): the other layers
    come from the file, fc8 from the seed-0 fillers."""
    from caffeonspark_tpu_torch.proto import NetParameter
    _, tnet = _pair(narrow_net_text("caffenet"))
    params = tnet.init(9)
    path = str(tmp_path / "no_fc8.caffemodel")
    checkpoint.save_caffemodel(path, tnet, params)
    npm = NetParameter.from_binary(open(path, "rb").read())
    npm.layer = [lp for lp in npm.layer if lp.name != "fc8"]
    with open(path, "wb") as f:
        f.write(npm.to_binary())
    loaded = checkpoint.load_serving_params(tnet, path)
    assert torch.equal(loaded["fc7"]["weight"], params["fc7"]["weight"])
    assert torch.equal(loaded["fc8"]["weight"],
                       tnet.init(0, layers=["fc8"])["fc8"]["weight"])
    with pytest.raises(ValueError, match="fc8"):
        checkpoint.load_serving_params(tnet, path, strict=True)


def test_params_from_numpy_checks_the_layout():
    _, tnet = _pair(narrow_net_text("lenet"))
    good = {ln: {b: np.zeros(s, np.float32) for b, s, _ in sp}
            for ln, sp in tnet.param_layout.items()}
    out = params_from_numpy(tnet, good)
    assert out["ip1"]["weight"].shape == (500, 800)
    missing_layer = {k: v for k, v in good.items() if k != "conv2"}
    with pytest.raises(KeyError, match="conv2"):
        params_from_numpy(tnet, missing_layer)
    missing_blob = dict(good, ip2={"weight": good["ip2"]["weight"]})
    with pytest.raises(KeyError, match="ip2/bias"):
        params_from_numpy(tnet, missing_blob)
    bad_shape = dict(good, ip2=dict(good["ip2"],
                                    weight=np.zeros((10, 499), np.float32)))
    with pytest.raises(ValueError, match="ip2/weight"):
        params_from_numpy(tnet, bad_shape)


def test_caffemodel_is_the_contract_between_packages(tmp_path):
    """A .caffemodel the JAX package wrote loads through the port's
    loader to the same values, and the port's file loads back in the
    JAX package: both directions exact."""
    jnet, tnet = _pair(narrow_net_text("alexnet"))
    pn = jax_params_numpy(jnet, 3)
    jax_file = str(tmp_path / "jax.caffemodel")
    jax_ckpt.save_caffemodel(jax_file, jnet, {ln: dict(bl)
                                              for ln, bl in pn.items()})
    loaded = checkpoint.load_serving_params(tnet, jax_file, strict=True)
    finetuned = checkpoint.copy_layers(tnet, tnet.init(5), jax_file)
    for ln, bl in pn.items():
        for bn, a in bl.items():
            np.testing.assert_array_equal(loaded[ln][bn].numpy(), a)
            np.testing.assert_array_equal(finetuned[ln][bn].numpy(), a)
    port_file = str(tmp_path / "port.caffemodel")
    checkpoint.save_caffemodel(port_file, tnet, loaded)
    back = jax_ckpt.load_caffemodel_blobs(port_file)
    for ln, specs in jnet.param_layout.items():
        for i, (bn, _, _) in enumerate(specs):
            np.testing.assert_array_equal(back[ln][i], pn[ln][bn])
    with open(port_file, "rb") as f1, open(jax_file, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("tp_text,shape", [
    ("scale: 0.00390625", (2, 1, 12, 12)),
    ("crop_size: 5 mean_value: 104 mean_value: 117 mean_value: 123 "
     "scale: 0.5", (3, 3, 9, 8)),
    ("crop_size: 6 mean_value: 100", (2, 3, 6, 6)),
])
def test_test_phase_transformer_matches_jax(tp_text, shape):
    batch = np.random.RandomState(6).rand(*shape).astype(np.float32) * 255
    ref = JaxTransformer(JaxTP.from_text(tp_text), phase_train=False)(batch)
    got = Transformer(TransformationParameter.from_text(tp_text))(batch)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
