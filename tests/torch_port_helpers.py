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


def datum_records(n, c=1, h=28, w=28, seed=0):
    """`n` seeded uint8 Datum records keyed b"%08d", labels in [0, 10)."""
    from caffeonspark_tpu_torch.proto.caffe import Datum
    rng = np.random.RandomState(seed)
    return [(b"%08d" % i, Datum(
        channels=c, height=h, width=w,
        data=rng.randint(0, 256, c * h * w).astype(np.uint8).tobytes(),
        label=int(rng.randint(10))).to_binary()) for i in range(n)]


def lenet_solver(tmp_path, data_layer_text: str, max_iter: int = 4,
                 extra: str = ""):
    """The zoo's LeNet with its data layer replaced by `data_layer_text`
    and an inv-policy SGD solver (plus `extra` lines): the solver's path
    and a -weights file of the port's fillers (seed 21)."""
    from caffeonspark_tpu_torch import checkpoint
    from caffeonspark_tpu_torch.proto import SolverParameter
    from caffeonspark_tpu_torch.solver import Solver
    text = jax_zoo.lenet(8).to_text()
    body = text[text.index("layer {", text.index("layer {") + 1):]
    net = tmp_path / "net.prototxt"
    net.write_text(f'name: "LeNet"\n{data_layer_text}\n{body}')
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{net}"\nbase_lr: 0.01 momentum: 0.9 weight_decay: 0.0005 '
        f'lr_policy: "inv" gamma: 0.0001 power: 0.75\nmax_iter: {max_iter}'
        f'\nsnapshot: 0\nrandom_seed: 13\n{extra}')
    ts = Solver(SolverParameter.from_text("base_lr: 0.01"),
                TorchNetParameter.from_text(net.read_text()), device="cpu")
    init = str(tmp_path / "init.caffemodel")
    checkpoint.save_caffemodel(init, ts.train_net, ts.train_net.init(21))
    return str(solver), init


def lenet_cli_pair(tmp_path, data_layer_text: str, max_iter: int = 4):
    """-train of the zoo's LeNet (its data layer replaced by
    `data_layer_text`) through both CLIs from one -weights file: the two
    final models as {layer: [np arrays]}."""
    import os

    from caffeonspark_tpu import caffe_on_spark as jax_cos
    from caffeonspark_tpu import checkpoint as jax_ckpt
    from caffeonspark_tpu_torch import caffe_on_spark, checkpoint
    solver, init = lenet_solver(tmp_path, data_layer_text, max_iter)
    assert caffe_on_spark.main(["-conf", solver, "-train", "-weights",
                                init, "-output", str(tmp_path / "t"),
                                "-device", "cpu"]) == 0
    assert jax_cos.main(["-conf", solver, "-train", "-weights", init,
                         "-output", str(tmp_path / "j")]) == 0
    return (checkpoint.load_caffemodel_blobs(
        os.path.join(tmp_path, "t", "model.caffemodel")),
        jax_ckpt.load_caffemodel_blobs(
            os.path.join(tmp_path, "j", "model.caffemodel")))
