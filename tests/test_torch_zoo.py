"""The port's model zoo against the JAX package's: VGG-16, ResNet-50 and
GoogLeNet.

  * each net's prototxt text equals the JAX zoo's for several argument
    sets (the port keeps a letter-for-letter copy, so `copy_layers`
    matches published caffemodels' layer names in both packages);
  * `Net.blob_shapes`, the param layout and `num_params` equal the JAX
    `Net`'s at batch 2 in the TRAIN and TEST phases (shape inference
    only: no forward runs), and the counts are the published nets':
    VGG-16 138,357,544; ResNet-50 25.5-25.7 M weights besides the
    BatchNorm statistics; GoogLeNet's main trunk (no auxiliary towers)
    6.5-7.5 M.
"""

import math

import pytest

from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu_torch.models import zoo
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.proto import NetParameter, NetState, Phase
from torch_common import cap_torch_threads

cap_torch_threads()

TEXT_CASES = [
    ("vgg16", {}), ("vgg16", dict(batch_size=2, num_classes=10,
                                  image_size=64)),
    ("resnet50", {}), ("resnet50", dict(batch_size=3, num_classes=7)),
    ("googlenet", {}), ("googlenet", dict(batch_size=2, num_classes=10,
                                          image_size=128)),
    ("googlenet", dict(aux_heads=False)),
]


@pytest.mark.parametrize("name,kw", TEXT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TEXT_CASES)])
def test_prototxt_equals_the_jax_zoo(name, kw):
    assert getattr(zoo, name)(**kw).to_text() \
        == getattr(jax_zoo, name)(**kw).to_text()


def _both(text, phase):
    jnet = JaxNet(JaxNetParameter.from_text(text),
                  JaxNetState(phase=int(phase)))
    tnet = Net(NetParameter.from_text(text), NetState(phase=phase),
               device="meta")
    return jnet, tnet


SHAPE_CASES = [("vgg16", {}), ("resnet50", {}), ("googlenet", {}),
               ("googlenet", dict(aux_heads=False))]


@pytest.mark.parametrize("phase", [Phase.TRAIN, Phase.TEST],
                         ids=["train", "test"])
@pytest.mark.parametrize("name,kw", SHAPE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SHAPE_CASES)])
def test_shapes_and_param_counts_equal_jax(name, kw, phase):
    text = getattr(zoo, name)(batch_size=2, **kw).to_text()
    jnet, tnet = _both(text, phase)
    assert tnet.blob_shapes == {k: tuple(v)
                                for k, v in jnet.blob_shapes.items()}
    assert {ln: [(bn, tuple(s)) for bn, s, _ in specs]
            for ln, specs in tnet.param_layout.items()} \
        == {ln: [(bn, tuple(s)) for bn, s, _ in specs]
            for ln, specs in jnet.param_layout.items()}
    assert tnet.num_params() == jnet.num_params()
    assert tnet.output_blobs == jnet.output_blobs
    assert tnet.loss_weights == pytest.approx(jnet.loss_weights)


def test_published_parameter_counts():
    vgg = Net(NetParameter.from_text(zoo.vgg16(batch_size=2).to_text()),
              device="meta")
    assert vgg.num_params() == 138_357_544
    res = Net(NetParameter.from_text(zoo.resnet50(batch_size=2)
                                     .to_text()), device="meta")
    stats = set(res.stat_param_layers())
    weights = sum(math.prod(s) for ln, specs in res.param_layout.items()
                  if ln not in stats for _, s, _ in specs)
    assert 25_500_000 <= weights <= 25_700_000
    assert len(stats) == 53
    trunk = Net(NetParameter.from_text(
        zoo.googlenet(batch_size=2, aux_heads=False).to_text()),
        device="meta")
    assert 6_500_000 <= trunk.num_params() <= 7_500_000
    full = Net(NetParameter.from_text(zoo.googlenet(batch_size=2)
                                      .to_text()), device="meta")
    test = Net(NetParameter.from_text(zoo.googlenet(batch_size=2)
                                      .to_text()),
               NetState(phase=Phase.TEST), device="meta")
    # the auxiliary towers are TRAIN-only
    assert full.num_params() > trunk.num_params() == test.num_params()
