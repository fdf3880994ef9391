"""Sequence parallelism: the counterpart of `caffeonspark_tpu/parallel/sp.py`.

Only `attention`, the single-device reference softmax attention, is
ported so far: the ring over an `sp` mesh axis (and its flash block
update, K9) comes with the multi-device slice.  The flash kernels'
tests hold the port's attention against it.
"""

from __future__ import annotations

import math

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, q_offset: int = 0,
              k_offset: int = 0) -> torch.Tensor:
    """Reference softmax attention. q, k, v: (B, H, T, D); a causal mask
    of -inf with global query/key offsets."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
