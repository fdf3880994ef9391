"""CaffeOnSpark on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of `caffeonspark_tpu`: the same Caffe solver and
net prototxts, the same `.caffemodel` files, the same serving wire
format.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package on this package's path is a CUDA kernel written by hand
(`csrc/`, bound in `ops/kernels.py`).

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"`, or `-device cpu` on the command line), where each
kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
