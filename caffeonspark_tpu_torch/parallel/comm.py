"""The transport between ranks of a mesh: `all_reduce`, `reduce_scatter`
and `all_gather` over one axis (the counterparts of `lax.psum`,
`lax.psum_scatter` and `lax.all_gather`), and `Shards`, a tensor held as
one block per rank.

Beside `parallel.sp.ppermute` these are the port's only transports.
Each moves a rank's tensor to the receiving rank's device with `.to`,
a no-op between ranks of one card, and sums or concatenates there, in
rank order.  Every rank of a mesh on one card therefore shares one
result.  The gradient exchange (`gradsync.py`) reduces its buckets
through them; a transport between cards or processes
(`torch.distributed`) replaces these functions and nothing else.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .mesh import Mesh


class Shards(list):
    """A tensor held as one block per rank of a mesh axis, the blocks in
    rank order along dimension `dim`: tp ranks' column blocks of a
    weight, or dp ranks' slices of a ZeRO-1 optimizer state."""

    def __init__(self, blocks: Sequence[torch.Tensor], dim: int):
        super().__init__(blocks)
        self.dim = dim

    def whole(self) -> torch.Tensor:
        """The blocks joined on the first block's device."""
        return all_gather(self, self.dim)

    def map(self, fn) -> "Shards":
        return Shards([fn(t) for t in self], self.dim)

    # read by the layers as a tensor's (InnerProduct's int8 test, the
    # mixed-precision cast)
    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    def is_floating_point(self) -> bool:
        return self[0].is_floating_point()


def split(t: torch.Tensor, n: int, dim: int) -> List[torch.Tensor]:
    """`t` cut into n equal blocks along `dim` (views)."""
    if t.shape[dim] % n:
        raise ValueError(f"extent {t.shape[dim]} of dim {dim} not "
                         f"divisible by {n} ranks")
    return list(torch.chunk(t, n, dim=dim))


def all_reduce(tensors: Sequence[torch.Tensor], mesh: Mesh,
               axis_name: str) -> List[torch.Tensor]:
    """The sum of the ranks' tensors along `axis_name`, one copy on each
    rank's device (`lax.psum`): summed in rank order, so every rank holds
    the same bits.  With no mesh, one rank's tensor: itself.
    Differentiable."""
    devs = (mesh.axis_devices(axis_name) if mesh is not None
            else [tensors[0].device])
    if len(tensors) != len(devs):
        raise ValueError(f"all_reduce over {axis_name!r}: {len(tensors)} "
                         f"tensors for {len(devs)} ranks")
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    return [total.to(d) for d in devs]


def reduce_scatter(tensors: Sequence[torch.Tensor], mesh: Mesh,
                   axis_name: str) -> List[torch.Tensor]:
    """The ranks' flats summed slice by slice (`lax.psum_scatter`,
    tiled): each flat is padded with zeros to a multiple of the ranks,
    cut into one slice per rank, and rank r holds the rank-order sum of
    slice r on its device.  `all_gather(out, 0)[:numel]` is then
    `all_reduce`'s sum, bit for bit."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    if len(tensors) != n:
        raise ValueError(f"reduce_scatter over {axis_name!r}: "
                         f"{len(tensors)} tensors for {n} ranks")
    flats = [t.reshape(-1) for t in tensors]
    pad = (-flats[0].numel()) % n
    if pad:
        flats = [torch.cat([f, f.new_zeros(pad)]) for f in flats]
    slices = [torch.chunk(f, n) for f in flats]
    out = []
    for r, d in enumerate(devs):
        total = slices[0][r].to(d)
        for s in slices[1:]:
            total = total + s[r].to(d)
        out.append(total)
    return out


def all_gather(tensors: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The ranks' blocks joined along `dim` on the first block's device
    (`lax.all_gather(tiled=True)`).  Differentiable."""
    if len(tensors) == 1:
        return tensors[0]
    dev = tensors[0].device
    return torch.cat([t.to(dev) for t in tensors], dim=dim)
