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

When an axis spans processes (`Mesh.axis_spans`), a collective over it
first reduces or joins this process's ranks in rank order, then calls
the gloo collective of `torch.distributed` on that one tensor over this
process's line of processes along the axis (`Mesh.group`), in line
order: every process of the line ends with the same bits.  gloo takes
CUDA tensors for all_reduce, reduce_scatter and all_gather (checked on
an H100 with torch 2.11 between two processes sharing the card:
`ROUTES`).  Its point-to-point send and recv are CPU-only in PyTorch's
table of backends, so the ring's hop across processes (`shift_line`)
stages a CUDA tensor through pinned host memory; it posts both sides at
once (`batch_isend_irecv`), never a blocking send on both.

Over a dp axis `all_reduce` is differentiable across processes (its
backward sums the cotangents over them).  Over a tp or sp axis, whose
peers hold the same replicated activations, `gather_line` joins each
process's part (its backward takes this process's slice of a cotangent
that every peer holds whole), `take_line` cuts a replicated tensor to
this process's part (its backward joins the parts' cotangents), and
`sum_line_grad` passes a replicated input to a split product (its
backward sums the parts' cotangents): Megatron's g and f.  `TRAFFIC`
counts the bytes each axis sends across processes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .mesh import Mesh

# how each collective crosses processes on CUDA tensors: gloo itself
# (its CUDA path copies through host memory inside the collective); the
# ring's hop through pinned host buffers of the port's own
ROUTES = {"all_reduce": "gloo", "reduce_scatter": "gloo",
          "all_gather": "gloo", "ppermute": "gloo send/recv via pinned "
          "host buffers"}

# bytes this process sent across processes, per axis, under a ring
# schedule (an all_gather of P parts sends (P - 1) parts, an all_reduce
# 2 (P - 1) / P of its tensor, a hop its tensor); `reset_traffic` zeroes
TRAFFIC: Dict[str, int] = {"dp": 0, "tp": 0, "sp": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


def _count(axis_name: str, nbytes: float) -> None:
    TRAFFIC[axis_name] = TRAFFIC.get(axis_name, 0) + int(nbytes)


class Shards(list):
    """A tensor held as one block per rank of a mesh axis, the blocks in
    rank order along dimension `dim`: tp ranks' column blocks of a
    weight, or dp ranks' slices of a ZeRO-1 optimizer state."""

    def __init__(self, blocks: Sequence[torch.Tensor], dim: int,
                 first: int = 0, parts: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__(blocks)
        self.dim = dim
        # the blocks are parts first .. first + len - 1 of `parts`: a
        # ZeRO-1 state split over a dp axis that spans processes holds
        # only this process's ranks' slices, a blob split over a tp axis
        # that spans them its tp ranks' column blocks (`mesh`: the row
        # whose tp line joins them)
        self.first = int(first)
        self.parts = len(self) if parts is None else int(parts)
        self.mesh = mesh

    @property
    def spans(self) -> bool:
        """True when other processes hold the other parts."""
        return self.parts > len(self)

    def whole(self) -> torch.Tensor:
        """The blocks joined on the first block's device; over a tp line
        of processes, every process's (`gather_line`, differentiable)."""
        if self.spans and self.mesh is not None:
            return gather_line(all_gather(self, self.dim), self.dim,
                               self.mesh, "tp")
        if self.spans:
            raise ValueError(
                f"parts {self.first}..{self.first + len(self) - 1} of "
                f"{self.parts}: the rest are other processes' (a snapshot "
                "writes them as sharded sidecars)")
        return all_gather(self, self.dim)

    def map(self, fn) -> "Shards":
        return Shards([fn(t) for t in self], self.dim, self.first,
                      self.parts, self.mesh)

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
    return mesh is not None and mesh.axis_spans(axis_name)


def _dist():
    import torch.distributed as dist
    return dist


def _ring_bytes(t: torch.Tensor, n: int) -> float:
    """An all_reduce's bytes a process sends on a ring of n."""
    return 2 * (n - 1) * t.numel() * t.element_size() / n


class _ProcessSum(torch.autograd.Function):
    """The sum over a line of processes of one tensor each (gloo
    all_reduce); its backward sums the cotangents over them, since
    every process's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return _line_sum(x.detach().clone(), mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return (_line_sum(g.contiguous().clone(), ctx.mesh, ctx.axis_name),
                None, None)


def _line_sum(y: torch.Tensor, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """`y` summed in place over this process's line along `axis_name`."""
    _count(axis_name, _ring_bytes(y, mesh.line_procs(axis_name)))
    _dist().all_reduce(y, group=mesh.group(axis_name))
    return y


def process_sum(t: torch.Tensor, mesh: Optional[Mesh],
                axis_name: str = "dp") -> torch.Tensor:
    """`t` summed over the processes of this process's line along
    `axis_name` (itself when the axis spans none).  Differentiable."""
    if not _spans(mesh, axis_name):
        return t
    if t.requires_grad:
        return _ProcessSum.apply(t, mesh, axis_name)
    return _line_sum(t.detach().contiguous().clone(), mesh, axis_name)


def all_reduce(tensors: Sequence[torch.Tensor], mesh: Mesh,
               axis_name: str) -> List[torch.Tensor]:
    """The sum of the ranks' tensors along `axis_name`, one copy on each
    rank's device (`lax.psum`): summed in rank order, so every rank holds
    the same bits; over an axis that spans processes, this process's
    sum then summed over its line of processes.  With no mesh, one
    rank's tensor: itself.  Differentiable."""
    devs = (mesh.axis_devices(axis_name) if mesh is not None
            else [tensors[0].device])
    if len(tensors) != len(devs):
        raise ValueError(f"all_reduce over {axis_name!r}: {len(tensors)} "
                         f"tensors for {len(devs)} ranks")
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    if _spans(mesh, axis_name):
        total = process_sum(total, mesh, axis_name)
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
    reduce_scatter sums each process's share over the dp line, and
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
    """This process's share (1 / the dp line's processes) of the flats'
    sum over every dp rank, padded to a multiple of `dp_total`
    (reduce_scatter's body), and the gloo work that fills it (None
    unless `async_op`)."""
    total = local_flat_sum(flats, mesh, mesh.dp_total)
    n = mesh.dp_blocks
    share = total.new_empty(total.numel() // n)
    _count("dp", (n - 1) * share.numel() * share.element_size())
    work = _dist().reduce_scatter_tensor(share, total, group=mesh.group("dp"),
                                         async_op=async_op)
    return share, work


def start_reduce(flats: Sequence[torch.Tensor], mesh: Mesh, *,
                 hier: bool) -> Callable[[], torch.Tensor]:
    """Issue the reduction of this process's ranks' flats over the dp
    line of processes without waiting (gloo, `async_op=True`): the sum
    of every dp rank's flat, or under `hier` its reduce_scatter, whose
    all_gather follows at the wait.  Returns the wait: a function
    giving the sum's first numel elements, the same bits as
    `all_reduce` (or `reduce_scatter` + `all_gather_dp`)."""
    numel = flats[0].numel()
    if hier:
        share, work = _process_share(flats, mesh, async_op=True)

        def wait_hier() -> torch.Tensor:
            work.wait()
            return _gather_processes(share, 0, mesh)[:numel]
        return wait_hier
    total = local_flat_sum(flats, mesh)
    _count("dp", _ring_bytes(total, mesh.dp_blocks))
    work = _dist().all_reduce(total, group=mesh.group("dp"), async_op=True)

    def wait() -> torch.Tensor:
        work.wait()
        return total
    return wait


def _gather_processes(t: torch.Tensor, dim: int, mesh: Mesh,
                      axis_name: str = "dp") -> torch.Tensor:
    """Every process's `t` (one shape on all) of this process's line
    along `axis_name`, joined along `dim` in line order (gloo
    all_gather)."""
    t = t.contiguous()
    n = mesh.line_procs(axis_name)
    out = t.new_empty(n * t.numel())
    _count(axis_name, (n - 1) * t.numel() * t.element_size())
    _dist().all_gather_into_tensor(out, t.reshape(-1),
                                   group=mesh.group(axis_name))
    return torch.cat(out.view(n, *t.shape).unbind(0), dim=dim)


def all_gather_dp(tensors: Sequence[torch.Tensor], dim: int,
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """The dp ranks' blocks joined along `dim` over the whole axis: this
    process's (`all_gather`), then, when the axis spans processes, every
    process's of the dp line in line order.  Not differentiable across
    processes."""
    local = all_gather(tensors, dim)
    if not _spans(mesh, "dp"):
        return local
    return _gather_processes(local, dim, mesh)


def all_gather(tensors: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The ranks' blocks joined along `dim` on the first block's device
    (`lax.all_gather(tiled=True)`).  Differentiable."""
    if len(tensors) == 1:
        return tensors[0]
    dev = tensors[0].device
    return torch.cat([t.to(dev) for t in tensors], dim=dim)


# ---------------------------------------------------------------------------
# a tp or sp axis across processes: the peers of a line hold replicated
# activations, each process computing its part
# ---------------------------------------------------------------------------

def _own_slice(t: torch.Tensor, dim: int, mesh: Mesh,
               axis_name: str) -> torch.Tensor:
    """This process's part of `t` along `dim` (its place on the line)."""
    n = mesh.line_procs(axis_name)
    return torch.chunk(t, n, dim=dim)[mesh.line_index(axis_name)]


class _GatherLine(torch.autograd.Function):
    """gather_line: forward joins the line's parts, backward takes this
    process's slice of the whole cotangent (every peer holds it)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis_name):
        ctx.dim, ctx.mesh, ctx.axis_name = dim, mesh, axis_name
        return _gather_processes(x.detach(), dim, mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return (_own_slice(g, ctx.dim, ctx.mesh, ctx.axis_name).contiguous(),
                None, None, None)


class _TakeLine(torch.autograd.Function):
    """take_line: forward takes this process's part of a replicated
    tensor, backward joins the parts' cotangents over the line."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis_name):
        ctx.dim, ctx.mesh, ctx.axis_name = dim, mesh, axis_name
        return _own_slice(x.detach(), dim, mesh, axis_name).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather_processes(g, ctx.dim, ctx.mesh, ctx.axis_name),
                None, None, None)


class _SumLineGrad(torch.autograd.Function):
    """sum_line_grad: the identity forward; backward sums the cotangent
    over the line (each process's part of a split product reads the
    whole replicated input)."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_line_sum(g.contiguous().clone(), ctx.mesh, ctx.axis_name),
                None, None)


def gather_line(t: torch.Tensor, dim: int, mesh: Mesh,
                axis_name: str) -> torch.Tensor:
    """This process's part joined with its line's along `dim`, in line
    order (the tp head or column blocks, the sp ring's time blocks);
    itself when the axis spans no process.  Differentiable: the
    backward takes this process's slice, not a sum."""
    if not _spans(mesh, axis_name):
        return t
    return _GatherLine.apply(t, dim, mesh, axis_name)


def take_line(t: torch.Tensor, dim: int, mesh: Mesh,
              axis_name: str) -> torch.Tensor:
    """This process's part along `dim` of a tensor that every peer of
    its line holds whole; itself when the axis spans no process.
    Differentiable: the backward joins the parts' cotangents."""
    if not _spans(mesh, axis_name):
        return t
    return _TakeLine.apply(t, dim, mesh, axis_name)


def sum_line_grad(t: torch.Tensor, mesh: Mesh,
                  axis_name: str) -> torch.Tensor:
    """`t` itself, whose cotangent is summed over the line of processes
    along `axis_name` (the input of a product split over it)."""
    if not _spans(mesh, axis_name):
        return t
    return _SumLineGrad.apply(t, mesh, axis_name)


def _hop(tensors: Sequence[torch.Tensor], mesh: Mesh, axis_name: str,
         step: int) -> List[torch.Tensor]:
    """Each tensor sent to the process `step` places on along the line
    and the same shapes received from the one `step` places back, all
    posted at once (`batch_isend_irecv`); CUDA tensors go through pinned
    host buffers (gloo's send and recv take CPU tensors)."""
    dist = _dist()
    group = mesh.group(axis_name)
    dst, src = mesh.peer(axis_name, step), mesh.peer(axis_name, -step)
    sends, recvs, ops = [], [], []
    for t in tensors:
        t = t.detach().contiguous()
        host = t.to("cpu") if t.device.type == "cpu" else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        buf = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=t.device.type == "cuda")
        sends.append(host)
        recvs.append(buf)
        ops += [dist.P2POp(dist.isend, host, dst, group=group),
                dist.P2POp(dist.irecv, buf, src, group=group)]
        _count(axis_name, t.numel() * t.element_size())
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [r.to(t.device, non_blocking=False)
            for r, t in zip(recvs, tensors)]


class _ShiftLine(torch.autograd.Function):
    """shift_line, differentiable: the backward hands each cotangent
    back the other way along the ring."""

    @staticmethod
    def forward(ctx, mesh, axis_name, *xs):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return tuple(_hop(xs, mesh, axis_name, 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_hop(gs, ctx.mesh, ctx.axis_name, -1))


def shift_line(tensors: Sequence[torch.Tensor], mesh: Mesh,
               axis_name: str) -> List[torch.Tensor]:
    """The ring's hop across processes: each of this process's tensors
    goes to the next process on its line along `axis_name` (cyclic), and
    the previous one's arrive.  Differentiable."""
    return list(_ShiftLine.apply(mesh, axis_name, *tensors))
