"""Weight fillers with Caffe semantics (filler.hpp), drawn from an
explicit `torch.Generator`.

The draws happen on the CPU generator the caller passes and the result
then moves to `device`, so one seed gives the same weights on every
device.  `jax.random` and torch give different numbers for one seed:
tests move parameters between the packages instead of comparing
initialisations.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..proto.caffe import FillerParameter, VarianceNorm


def _fans(shape: Sequence[int]) -> Tuple[float, float]:
    """Caffe: fan_in = count/num, fan_out = count/channels for 4D blobs;
    for a 2D (IP) weight (N, K): fan_in = K, fan_out = N."""
    if len(shape) == 0:
        return 1.0, 1.0
    count = math.prod(shape)
    fan_in = count / shape[0]
    fan_out = count / shape[1] if len(shape) > 1 else float(shape[0])
    return fan_in, fan_out


def _n_for(filler: FillerParameter, shape) -> float:
    fan_in, fan_out = _fans(shape)
    vn = filler.variance_norm
    if vn == VarianceNorm.FAN_OUT:
        return fan_out
    if vn == VarianceNorm.AVERAGE:
        return (fan_in + fan_out) / 2.0
    return fan_in


def fill(generator: torch.Generator, filler: FillerParameter,
         shape: Sequence[int], dtype=torch.float32,
         device="cpu") -> torch.Tensor:
    t = filler.type or "constant"
    shape = tuple(int(s) for s in shape)
    g = generator
    if t == "constant":
        out = torch.full(shape, float(filler.value))
    elif t == "uniform":
        out = torch.empty(shape).uniform_(filler.min, filler.max,
                                          generator=g)
    elif t == "gaussian":
        out = filler.mean + filler.std * torch.randn(shape, generator=g)
    elif t == "xavier":
        scale = math.sqrt(3.0 / _n_for(filler, shape))
        out = torch.empty(shape).uniform_(-scale, scale, generator=g)
    elif t == "msra":
        std = math.sqrt(2.0 / _n_for(filler, shape))
        out = std * torch.randn(shape, generator=g)
    elif t == "positive_unitball":
        flat = torch.rand(shape, generator=g).reshape(shape[0], -1)
        out = (flat / flat.sum(dim=1, keepdim=True)).reshape(shape)
    else:
        raise ValueError(f"unknown filler type {t!r}")
    return out.to(dtype=dtype, device=device).contiguous()
