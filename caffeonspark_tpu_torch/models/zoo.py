"""Model zoo: programmatic NetParameters for the nets this package trains
and serves (a copy of `caffeonspark_tpu/models/zoo.py`'s LeNet,
CaffeNet, AlexNet and transformer LM definitions, so both packages
build the same graphs)."""

from __future__ import annotations

from ..proto import NetParameter, parse_net_prototxt

LENET = """
name: "LeNet"
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 64 channels: 1 height: 28 width: 28 }
  transform_param { scale: 0.00390625 } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  param { lr_mult: 1 } param { lr_mult: 2 }
  convolution_param { num_output: 20 kernel_size: 5 stride: 1
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  param { lr_mult: 1 } param { lr_mult: 2 }
  convolution_param { num_output: 50 kernel_size: 5 stride: 1
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
  param { lr_mult: 1 } param { lr_mult: 2 }
  inner_product_param { num_output: 500
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  param { lr_mult: 1 } param { lr_mult: 2 }
  inner_product_param { num_output: 10
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layer { name: "accuracy" type: "Accuracy" bottom: "ip2" bottom: "label"
  top: "accuracy" include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss" }
"""

_CONV = """
layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 2 decay_mult: 0 }}
  convolution_param {{ num_output: {n} kernel_size: {k} {extra}
    weight_filler {{ type: "gaussian" std: {std} }}
    bias_filler {{ type: "constant" value: {bias} }} }} }}
layer {{ name: "relu_{name}" type: "ReLU" bottom: "{name}" top: "{name}" }}
"""

_FC = """
layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 2 decay_mult: 0 }}
  inner_product_param {{ num_output: {n}
    weight_filler {{ type: "gaussian" std: {std} }}
    bias_filler {{ type: "constant" value: {bias} }} }} }}
"""

_HEAD = """
name: "{name}"
layer {{ name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param {{ batch_size: {batch_size} channels: 3
    height: {crop} width: {crop} }} }}
"""

_TAIL = """
layer { name: "accuracy" type: "Accuracy" bottom: "fc8" bottom: "label"
  top: "accuracy" include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" bottom: "label"
  top: "loss" }
"""


def _pool(name: str, bottom: str) -> str:
    return f"""
layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}" top: "{name}"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
"""


def _norm(name: str, bottom: str) -> str:
    return f"""
layer {{ name: "{name}" type: "LRN" bottom: "{bottom}" top: "{name}"
  lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}
"""


def _classifier(num_classes: int) -> str:
    t = _FC.format(name="fc6", bottom="pool5", n=4096, std=0.005, bias=1)
    t += """
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6"
  dropout_param { dropout_ratio: 0.5 } }
"""
    t += _FC.format(name="fc7", bottom="fc6", n=4096, std=0.005, bias=1)
    t += """
layer { name: "relu7" type: "ReLU" bottom: "fc7" top: "fc7" }
layer { name: "drop7" type: "Dropout" bottom: "fc7" top: "fc7"
  dropout_param { dropout_ratio: 0.5 } }
"""
    t += _FC.format(name="fc8", bottom="fc7", n=num_classes, std=0.01,
                    bias=0)
    return t + _TAIL


def caffenet(batch_size: int = 64, num_classes: int = 1000,
             crop: int = 227) -> NetParameter:
    """AlexNet-style CaffeNet (the bvlc_reference_net workload): pool
    before norm, so its LRNs see relu'd, pooled inputs."""
    t = _HEAD.format(name="CaffeNet", batch_size=batch_size, crop=crop)
    t += _CONV.format(name="conv1", bottom="data", n=96, k=11,
                      extra="stride: 4", std=0.01, bias=0)
    t += _pool("pool1", "conv1") + _norm("norm1", "pool1")
    t += _CONV.format(name="conv2", bottom="norm1", n=256, k=5,
                      extra="pad: 2 group: 2", std=0.01, bias=1)
    t += _pool("pool2", "conv2") + _norm("norm2", "pool2")
    t += _CONV.format(name="conv3", bottom="norm2", n=384, k=3,
                      extra="pad: 1", std=0.01, bias=0)
    t += _CONV.format(name="conv4", bottom="conv3", n=384, k=3,
                      extra="pad: 1 group: 2", std=0.01, bias=1)
    t += _CONV.format(name="conv5", bottom="conv4", n=256, k=3,
                      extra="pad: 1 group: 2", std=0.01, bias=1)
    t += _pool("pool5", "conv5") + _classifier(num_classes)
    return parse_net_prototxt(t)


def alexnet(batch_size: int = 64, num_classes: int = 1000,
            crop: int = 227) -> NetParameter:
    """Original bvlc_alexnet (norm before pool).  Same parameter shapes
    as caffenet(); its conv -> relu -> norm stems are where the ReLU->LRN
    and conv-bias peepholes fire (norm1 at 55x55, norm2 at 27x27)."""
    t = _HEAD.format(name="AlexNet", batch_size=batch_size, crop=crop)
    t += _CONV.format(name="conv1", bottom="data", n=96, k=11,
                      extra="stride: 4", std=0.01, bias=0)
    t += _norm("norm1", "conv1") + _pool("pool1", "norm1")
    t += _CONV.format(name="conv2", bottom="pool1", n=256, k=5,
                      extra="pad: 2 group: 2", std=0.01, bias=1)
    t += _norm("norm2", "conv2") + _pool("pool2", "norm2")
    t += _CONV.format(name="conv3", bottom="pool2", n=384, k=3,
                      extra="pad: 1", std=0.01, bias=0)
    t += _CONV.format(name="conv4", bottom="conv3", n=384, k=3,
                      extra="pad: 1 group: 2", std=0.01, bias=1)
    t += _CONV.format(name="conv5", bottom="conv4", n=256, k=3,
                      extra="pad: 1 group: 2", std=0.01, bias=1)
    t += _pool("pool5", "conv5") + _classifier(num_classes)
    return parse_net_prototxt(t)


def lenet(batch_size: int = 64) -> NetParameter:
    npm = parse_net_prototxt(LENET)
    for lyr in npm.layer:
        if lyr.type == "MemoryData":
            lyr.memory_data_param.batch_size = batch_size
    return npm


def transformer_lm(vocab: int = 1000, d_model: int = 128, heads: int = 4,
                   layers: int = 2, seq: int = 32, batch: int = 8
                   ) -> NetParameter:
    """Small causal transformer language model (extension family: the
    reference tops out at LSTM; this exercises MultiHeadAttention from a
    plain prototxt).  Time-major (T, B) int inputs like the LSTM path."""
    t = f"""
name: "TransformerLM"
layer {{ name: "data" type: "CoSData" top: "input_sentence"
  top: "target_sentence"
  cos_data_param {{ batch_size: {batch}
    top {{ name: "input_sentence" type: INT_ARRAY channels: {seq}
          sample_num_axes: 1 transpose: true }}
    top {{ name: "target_sentence" type: INT_ARRAY channels: {seq}
          sample_num_axes: 1 transpose: true }} }} }}
layer {{ name: "embed" type: "Embed" bottom: "input_sentence"
  top: "h0" embed_param {{ input_dim: {vocab} num_output: {d_model}
    bias_term: false
    weight_filler {{ type: "uniform" min: -0.05 max: 0.05 }} }} }}
"""
    bottom = "h0"
    hd = d_model // heads
    for i in range(1, layers + 1):
        t += f"""
layer {{ name: "attn{i}" type: "MultiHeadAttention" bottom: "{bottom}"
  top: "attn{i}"
  attention_param {{ num_heads: {heads} head_dim: {hd} causal: true }} }}
layer {{ name: "res{i}a" type: "Eltwise" bottom: "{bottom}"
  bottom: "attn{i}" top: "res{i}a" }}
layer {{ name: "ff{i}" type: "InnerProduct" bottom: "res{i}a"
  top: "ff{i}" inner_product_param {{ num_output: {4 * d_model} axis: 2
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "ff{i}_relu" type: "ReLU" bottom: "ff{i}" top: "ff{i}" }}
layer {{ name: "ff{i}_out" type: "InnerProduct" bottom: "ff{i}"
  top: "ff{i}_out" inner_product_param {{ num_output: {d_model} axis: 2
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "res{i}b" type: "Eltwise" bottom: "res{i}a"
  bottom: "ff{i}_out" top: "res{i}b" }}
"""
        bottom = f"res{i}b"
    t += f"""
layer {{ name: "logits" type: "InnerProduct" bottom: "{bottom}"
  top: "logits" inner_product_param {{ num_output: {vocab} axis: 2
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "logits"
  bottom: "target_sentence" top: "loss"
  loss_param {{ ignore_label: -1 }} softmax_param {{ axis: 2 }} }}
"""
    return parse_net_prototxt(t)
