"""Shared helpers of the tests/test_torch_*.py files: the same narrow,
small-crop image nets built in both packages, and parameters moved from
the JAX package to the PyTorch port as numpy."""

import jax
import numpy as np

from caffeonspark_tpu.models import zoo as jax_zoo
from caffeonspark_tpu_torch.proto import NetParameter as TorchNetParameter

# the zoo's widths cut so a whole net runs in well under a second on
# the CPU; conv2/4/5 keep group 2 (every width stays even)
NARROW = {"conv1": 8, "conv2": 16, "conv3": 16, "conv4": 16, "conv5": 8,
          "fc6": 32, "fc7": 32, "fc8": 10}
CROP = 67          # the smallest crop whose pool5 is still 1x1
BATCH = 2


def narrow_net_text(name: str, batch: int = BATCH, crop: int = CROP,
                    source_class: str = "", source: str = "") -> str:
    """Prototxt of the JAX zoo's `name` net at narrow widths (lenet keeps
    its own widths)."""
    if name == "lenet":
        npm = jax_zoo.lenet(batch)
    else:
        npm = getattr(jax_zoo, name)(batch_size=batch, num_classes=10,
                                     crop=crop)
        for lp in npm.layer:
            if lp.name in NARROW:
                p = (lp.convolution_param if lp.type == "Convolution"
                     else lp.inner_product_param)
                p.num_output = NARROW[lp.name]
    if source_class:
        npm.layer[0].source_class = source_class
        npm.layer[0].memory_data_param.source = source
    return npm.to_text()


def torch_net_param(text: str) -> TorchNetParameter:
    return TorchNetParameter.from_text(text)


def jax_params_numpy(net, seed: int = 0):
    """The JAX net's filler-initialized params as {layer: {blob: np}}."""
    params = net.init(jax.random.key(seed))
    return {ln: {bn: np.asarray(a) for bn, a in bl.items()}
            for ln, bl in params.items()}
