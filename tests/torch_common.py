"""Helpers of the port's tests that import neither jax nor the JAX
package, so that tests/test_torch_cuda.py can use them on the card's
machine (tests/torch_port_helpers.py imports jax)."""

import os

import torch


def cap_torch_threads() -> int:
    """Under xdist (PYTEST_XDIST_WORKER_COUNT set), cap this worker's
    torch intra-op threads at max(1, os.cpu_count() // workers): each
    worker would otherwise run its convolutions and matmuls on one
    thread a core, crowding the cores that the other workers' tests, the
    JAX package's thread-timing tests among them, run on.  Each port test
    module calls it once, where it is imported.  Returns the threads in
    force."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        cap = max(1, (os.cpu_count() or 1) // max(1, int(workers)))
        if torch.get_num_threads() > cap:
            torch.set_num_threads(cap)
    return torch.get_num_threads()


# conv -> ReLU -> LRN (K3 and K4 under COS_FUSE_BIAS_RELU_LRN=1), whose
# top joins a channel Concat second, at a batch of 1: Concat's backward
# hands the LRN a contiguous narrow of the joined gradient 3 x 7 x 7
# elements in, 588 bytes, 12 past a 16-byte boundary
FUSED_LRN_CONCAT_NET = """
name: "fused_lrn_concat"
layer { name: "data" type: "Input" top: "data" top: "side" top: "target"
  input_param { shape { dim: 1 dim: 3 dim: 9 dim: 9 }
                shape { dim: 1 dim: 3 dim: 7 dim: 7 }
                shape { dim: 1 dim: 10 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 16 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.05 beta: 0.75 } }
layer { name: "cat" type: "Concat" bottom: "side" bottom: "norm1"
  top: "cat" }
layer { name: "ip" type: "InnerProduct" bottom: "cat" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "EuclideanLoss" bottom: "ip" bottom: "target"
  top: "loss" }
"""
FUSED_LRN_CONCAT_INPUTS = {"data": (1, 3, 9, 9), "side": (1, 3, 7, 7),
                           "target": (1, 10)}


def fused_lrn_concat_step(device, seed: int = 0):
    """One loss and backward of FUSED_LRN_CONCAT_NET (its fusion as the
    environment's COS_FUSE_BIAS_RELU_LRN sets it) from seeded numpy
    inputs and params of seed 1: (loss, {layer: {blob: gradient}})."""
    import numpy as np

    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetParameter
    net = Net(NetParameter.from_text(FUSED_LRN_CONCAT_NET), device=device)
    params = net.init(seed=1)
    rng = np.random.RandomState(seed)
    inputs = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
              for k, s in FUSED_LRN_CONCAT_INPUTS.items()}
    leaves = {ln: {bn: t.clone().requires_grad_(True) for bn, t in bl.items()}
              for ln, bl in params.items()}
    loss, _ = net.loss(leaves, inputs)
    loss.backward()
    return float(loss.detach()), {
        ln: {bn: t.grad for bn, t in bl.items()} for ln, bl in leaves.items()}
