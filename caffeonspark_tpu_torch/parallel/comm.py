"""The transport between ranks of a mesh: `all_reduce`, `reduce_scatter`
and `all_gather` over one axis (the counterparts of `lax.psum`,
`lax.psum_scatter` and `lax.all_gather`), and `Shards`, a tensor held as
one block per rank.

Beside `parallel.sp.ppermute` these are the port's only transports.
Each moves a rank's tensor to the receiving rank's device with `.to`,
a no-op between ranks of one card, and sums or concatenates there, in
rank order.  Every rank of a mesh on one card therefore shares one
result.  The gradient exchange (`gradsync.py`) reduces its buckets
through them.

When the dp axis spans processes (`Mesh.spans`), a collective over dp
first reduces or joins this process's ranks in rank order, then calls
the gloo collective of `torch.distributed` on that one tensor, in
process order: every process ends with the same bits.  gloo takes CUDA
tensors for each of the three (checked on an H100 with torch 2.11
between two processes sharing the card: `ROUTES`), so no collective
stages through host memory of its own.  `all_reduce` is differentiable
across processes too: its backward sums the cotangents over them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .mesh import Mesh

# how each collective crosses processes on CUDA tensors: gloo itself
# (its CUDA path copies through host memory inside the collective)
ROUTES = {"all_reduce": "gloo", "reduce_scatter": "gloo",
          "all_gather": "gloo"}


class Shards(list):
    """A tensor held as one block per rank of a mesh axis, the blocks in
    rank order along dimension `dim`: tp ranks' column blocks of a
    weight, or dp ranks' slices of a ZeRO-1 optimizer state."""

    def __init__(self, blocks: Sequence[torch.Tensor], dim: int,
                 first: int = 0, parts: Optional[int] = None):
        super().__init__(blocks)
        self.dim = dim
        # the blocks are parts first .. first + len - 1 of `parts`: a
        # ZeRO-1 state split over a dp axis that spans processes holds
        # only this process's ranks' slices
        self.first = int(first)
        self.parts = len(self) if parts is None else int(parts)

    @property
    def spans(self) -> bool:
        """True when other processes hold the other parts."""
        return self.parts > len(self)

    def whole(self) -> torch.Tensor:
        """The blocks joined on the first block's device."""
        if self.spans:
            raise ValueError(
                f"parts {self.first}..{self.first + len(self) - 1} of "
                f"{self.parts}: the rest are other processes' (a snapshot "
                "writes them as sharded sidecars)")
        return all_gather(self, self.dim)

    def map(self, fn) -> "Shards":
        return Shards([fn(t) for t in self], self.dim, self.first,
                      self.parts)

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


def _spans(mesh: Optional[Mesh], axis_name: str) -> bool:
    return mesh is not None and axis_name == "dp" and mesh.spans


def _dist():
    import torch.distributed as dist
    return dist


class _ProcessSum(torch.autograd.Function):
    """The sum over processes of one tensor each (gloo all_reduce); its
    backward sums the cotangents over them, since every process's loss
    reads the sum."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        _dist().all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g)
        return g


def process_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`t` summed over the processes `mesh`'s dp axis spans (itself when
    it spans none).  Differentiable."""
    if mesh is None or not mesh.spans:
        return t
    if t.requires_grad:
        return _ProcessSum.apply(t)
    y = t.detach().contiguous().clone()
    _dist().all_reduce(y)
    return y


def all_reduce(tensors: Sequence[torch.Tensor], mesh: Mesh,
               axis_name: str) -> List[torch.Tensor]:
    """The sum of the ranks' tensors along `axis_name`, one copy on each
    rank's device (`lax.psum`): summed in rank order, so every rank holds
    the same bits; over a dp axis that spans processes, this process's
    sum then summed over the processes.  With no mesh, one rank's
    tensor: itself.  Differentiable."""
    devs = (mesh.axis_devices(axis_name) if mesh is not None
            else [tensors[0].device])
    if len(tensors) != len(devs):
        raise ValueError(f"all_reduce over {axis_name!r}: {len(tensors)} "
                         f"tensors for {len(devs)} ranks")
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    if _spans(mesh, axis_name):
        total = process_sum(total, mesh)
    return [total.to(d) for d in devs]


def reduce_scatter(tensors: Sequence[torch.Tensor], mesh: Mesh,
                   axis_name: str) -> List[torch.Tensor]:
    """The ranks' flats summed slice by slice (`lax.psum_scatter`,
    tiled): each flat is padded with zeros to a multiple of the ranks,
    cut into one slice per rank, and rank r holds the rank-order sum of
    slice r on its device.  `all_gather(out, 0)[:numel]` is then
    `all_reduce`'s sum, bit for bit.  Over a dp axis that spans
    processes the slices are the global ranks' (this process holds
    `mesh.dp_offset` ..): the process sums its ranks' flats, gloo's
    reduce_scatter sums each process's share over the processes, and
    each rank takes its slice of it."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    if len(tensors) != n:
        raise ValueError(f"reduce_scatter over {axis_name!r}: "
                         f"{len(tensors)} tensors for {n} ranks")
    flats = [t.reshape(-1) for t in tensors]
    if _spans(mesh, axis_name):
        share, _ = _process_share(flats, mesh)
        return [c.to(d) for c, d in zip(torch.chunk(share, n), devs)]
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


def local_flat_sum(flats: Sequence[torch.Tensor], mesh: Mesh,
                   pad_to: int = 1) -> torch.Tensor:
    """This process's ranks' flats summed in rank order on the first
    one's device, padded with zeros to a multiple of `pad_to`: a fresh
    tensor, which a collective may overwrite."""
    total = flats[0]
    for f in flats[1:]:
        total = total + f.to(total.device)
    pad = (-total.numel()) % pad_to
    if pad:
        return torch.cat([total, total.new_zeros(pad)])
    return total.clone() if len(flats) == 1 else total


def _process_share(flats: Sequence[torch.Tensor], mesh: Mesh,
                   async_op: bool = False):
    """This process's share (1 / procs) of the flats' sum over every dp
    rank, padded to a multiple of `dp_total` (reduce_scatter's body),
    and the gloo work that fills it (None unless `async_op`)."""
    total = local_flat_sum(flats, mesh, mesh.dp_total)
    share = total.new_empty(total.numel() // mesh.procs)
    work = _dist().reduce_scatter_tensor(share, total, async_op=async_op)
    return share, work


def start_reduce(flats: Sequence[torch.Tensor], mesh: Mesh, *,
                 hier: bool) -> Callable[[], torch.Tensor]:
    """Issue the reduction of this process's ranks' flats over the
    processes without waiting (gloo, `async_op=True`): the sum of every
    dp rank's flat, or under `hier` its reduce_scatter, whose all_gather
    follows at the wait.  Returns the wait: a function giving the sum's
    first numel elements, the same bits as `all_reduce` (or
    `reduce_scatter` + `all_gather_dp`)."""
    numel = flats[0].numel()
    if hier:
        share, work = _process_share(flats, mesh, async_op=True)

        def wait_hier() -> torch.Tensor:
            work.wait()
            return _gather_processes(share, 0, mesh)[:numel]
        return wait_hier
    total = local_flat_sum(flats, mesh)
    work = _dist().all_reduce(total, async_op=True)

    def wait() -> torch.Tensor:
        work.wait()
        return total
    return wait


def _gather_processes(t: torch.Tensor, dim: int, mesh: Mesh
                      ) -> torch.Tensor:
    """Every process's `t` (one shape on all) joined along `dim`, in
    process order (gloo all_gather)."""
    t = t.contiguous()
    out = t.new_empty(mesh.procs * t.numel())
    _dist().all_gather_into_tensor(out, t.reshape(-1))
    return torch.cat(out.view(mesh.procs, *t.shape).unbind(0), dim=dim)


def all_gather_dp(tensors: Sequence[torch.Tensor], dim: int,
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """The dp ranks' blocks joined along `dim` over the whole axis: this
    process's (`all_gather`), then, when the axis spans processes, every
    process's in process order.  Not differentiable across processes."""
    local = all_gather(tensors, dim)
    if mesh is None or not mesh.spans:
        return local
    return _gather_processes(local, dim, mesh)


def all_gather(tensors: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The ranks' blocks joined along `dim` on the first block's device
    (`lax.all_gather(tiled=True)`).  Differentiable."""
    if len(tensors) == 1:
        return tensors[0]
    dev = tensors[0].device
    return torch.cat([t.to(dev) for t in tensors], dim=dim)
