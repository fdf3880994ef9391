"""Device meshes: the counterpart of `caffeonspark_tpu/parallel/mesh.py`.

A `Mesh` places ranks on torch devices along the named axes (pp, ep,
sp, tp, dp), as a JAX Mesh places them on jax devices.  Several ranks
may share one device: an sp ring of 4 ranks runs on one card, as the
JAX package's CPU suite runs its rings on virtual devices that share one
CPU.  What stays per rank is the arithmetic and the choreography; only
the transport between ranks (`parallel.sp.ppermute`) is a copy between
devices, a no-op between ranks of one device.

The dp, tp and sp axes run programs of their own: dp and tp in
`parallel/dp.py` (`ParallelSolver`: each dp rank's forward and backward
on its slice of the batch, tp ranks computing column blocks of the large
matmuls), sp in the ring attention of `parallel/sp.py`.  `MeshLayout`
says where each parameter blob lives (replicated, or split over tp by
`tp_param_specs`), as the JAX package's does; a spec is a tuple of axis
names or None per dimension, JAX's PartitionSpec as a tuple.  ep and pp
wait for MixtureOfExperts and the pipeline (ROADMAP Queue 1 item 8):
`build_mesh`, which every mesh comes from, refuses them by name.

Several processes (`distributed_init`: `torch.distributed` over gloo)
extend the dp axis: each of `procs` processes holds `shape["dp"]` local
dp ranks on its own device, so the global dp axis is procs x that, in
the JAX package's order (dp the fastest axis, a process's ranks
contiguous: process p holds global dp ranks p*k .. p*k + k - 1).  The
collectives over dp (`parallel.comm`) first reduce a process's ranks,
then call gloo.  A tp or sp axis would span processes in that order;
it is refused by name (ROADMAP Queue 1 item 6c2).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("pp", "ep", "sp", "tp", "dp")
# a blob's placement: one axis name (or None) per dimension; () is
# replicated (JAX's PartitionSpec as a tuple)
Spec = Tuple[Optional[str], ...]


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'dp[,tp[,sp[,ep]]]' → build_mesh kwargs; rejects extra dims
    instead of silently dropping them.  Any token may instead be a
    named 'axis=N' dim ('pp=4', 'tp=2,pp=2', '2,2,pp=2') — the only
    spelling for the pp axis, which has no positional slot.  The same
    grammar and messages as the JAX package's parser."""
    names = ["dp", "tp", "sp", "ep"]
    out: Dict[str, int] = {}
    pos = 0
    for tok in spec.split(","):
        tok = tok.strip()
        if "=" in tok:
            name, _, val = tok.partition("=")
            name = name.strip()
            if name not in AXES:
                raise ValueError(
                    f"mesh spec {spec!r}: unknown axis {name!r} "
                    f"(axes: {','.join(AXES)})")
            dim = int(val)
        else:
            if pos >= len(names):
                raise ValueError(
                    f"mesh spec {spec!r} has more than {len(names)} "
                    f"positional dims ({','.join(names)})")
            name = names[pos]
            pos += 1
            dim = int(tok)
        if name in out:
            raise ValueError(
                f"mesh spec {spec!r}: axis {name!r} given twice")
        if dim < 1:
            raise ValueError(
                f"mesh spec {spec!r}: axis {name!r} must be >= 1, "
                f"got {dim}")
        out[name] = dim
    return out


class Mesh:
    """Ranks laid out on the axes (pp, ep, sp, tp, dp): `devices` is the
    numpy object array of shape (pp, ep, sp, tp, dp) whose entry is the
    torch.device of that rank; `shape` maps each axis name to its
    extent, in AXES order.  These are this process's ranks: with
    `procs` > 1 processes, each holds as many, and the global dp axis is
    `dp_total` = procs x shape["dp"], this process's ranks starting at
    global dp rank `dp_offset`."""

    def __init__(self, devices: np.ndarray, procs: int = 1, proc: int = 0):
        if devices.ndim != len(AXES):
            raise ValueError(f"mesh devices need {len(AXES)} axes "
                             f"{AXES}, got shape {devices.shape}")
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))
        self.procs = int(procs)
        self.proc = int(proc)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans(self) -> bool:
        """True when the dp axis spans processes."""
        return self.procs > 1

    @property
    def dp_total(self) -> int:
        return self.shape["dp"] * self.procs

    @property
    def dp_offset(self) -> int:
        return self.proc * self.shape["dp"]

    def local(self) -> "Mesh":
        """This process's ranks as a mesh of their own (no process
        spanned): the evaluation forward, which every process runs whole
        on the same replicated batch."""
        return Mesh(self.devices)

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices of the ranks along `axis_name`, at index 0 of
        every other axis: the ranks of one ring."""
        i = AXES.index(axis_name)
        index = [0] * len(AXES)
        out = []
        for r in range(self.devices.shape[i]):
            index[i] = r
            out.append(self.devices[tuple(index)])
        return out

    def sub(self, **index: int) -> "Mesh":
        """The mesh of the ranks at `index` on the named axes (each kept
        with extent 1): `sub(dp=r)` is dp row r, whose tp and sp ranks
        run that row's attention blocks."""
        sl = tuple(slice(index[a], index[a] + 1) if a in index
                   else slice(None) for a in AXES)
        return Mesh(self.devices[sl])

    def describe(self) -> Dict[str, object]:
        """JSON-serializable summary with the JAX package's
        `MeshLayout.describe` keys: axes with extent > 1, the number of
        ranks, and the sharded blobs (none: every parameter is
        replicated)."""
        return {"axes": global_axes(self), "devices": self.size * self.procs,
                "sharded_params": [], **process_info(self)}


def global_axes(mesh: Mesh) -> Dict[str, int]:
    """The axes of extent > 1 over every process (dp: `dp_total`)."""
    axes = {ax: int(n) for ax, n in mesh.shape.items() if n > 1}
    if mesh.dp_total > 1:
        axes["dp"] = mesh.dp_total
    return axes or {"dp": 1}


def process_info(mesh: Mesh) -> Dict[str, int]:
    """The `processes` key of a description, when processes span it."""
    return {"processes": mesh.procs} if mesh.spans else {}


def distributed_init(server: Optional[str], cluster: Optional[int],
                     rank: Optional[int]) -> Tuple[int, int]:
    """Join the processes of one training run (the JAX package's
    `distributed_init`, gloo here): `server` is the rendezvous
    `host:port` that process 0 listens on, `cluster` the number of
    processes, `rank` this one's.  A no-op for one process.  Returns
    (processes, this rank).  The NodeAgent's `agent://host:port` form
    is ROADMAP Queue 1 item 9, refused by name."""
    n = int(cluster or 1)
    if n <= 1:
        if rank:
            raise ValueError(f"-rank {rank} needs -cluster above it "
                             "(one process is rank 0)")
        return 1, 0
    if not server:
        raise ValueError(f"-cluster {n} needs -server host:port (the "
                         "rendezvous that process 0 listens on)")
    if server.startswith("agent://"):
        raise ValueError(f"-server {server}: the NodeAgent's rendezvous "
                         "is ROADMAP Queue 1 item 9 (give process 0's "
                         "host:port)")
    r = int(rank or 0)
    if not 0 <= r < n:
        raise ValueError(f"-rank {r} outside -cluster {n} (0..{n - 1})")
    import torch.distributed as dist
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (n, r):
            raise RuntimeError(
                f"torch.distributed already joined as rank "
                f"{dist.get_rank()} of {dist.get_world_size()}, not "
                f"{r} of {n}")
        return n, r
    dist.init_process_group("gloo", init_method=f"tcp://{server}",
                            world_size=n, rank=r)
    return n, r


def process_group() -> Tuple[int, int]:
    """(processes, this rank) of the joined run, or (1, 0)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def check_processes(dims: Dict[str, int], procs: int) -> None:
    """Refuse by name a tp or sp axis over `procs` > 1 processes: in the
    dp-fastest order it would span them (ROADMAP Queue 1 item 6c2)."""
    across = {a: d for a, d in dims.items() if a in ("tp", "sp") and d > 1}
    if procs > 1 and across:
        raise ValueError(
            f"mesh {across} over {procs} processes: in the dp-fastest "
            "order a tp or sp axis would span processes, which the "
            "PyTorch port does not run yet (ROADMAP Queue 1 item 6c2); "
            "the dp axis spans them")


def build_mesh(*, dp: Optional[int] = None, tp: int = 1, sp: int = 1,
               pp: int = 1, ep: int = 1,
               devices: Optional[Sequence] = None,
               procs: Optional[int] = None,
               proc: Optional[int] = None) -> Mesh:
    """Mesh over `devices` (one rank each, in order; a device may repeat)
    with named axes (pp, ep, sp, tp, dp); dp is inferred as the
    remainder when unset.  The default is one rank per visible card.
    ep and pp > 1 are refused by name.  `devices` are this process's
    ranks; `procs` / `proc` (default: the joined `torch.distributed`
    run's, else 1 / 0) give the processes that each hold as many, the
    dp axis spanning them; a tp or sp axis then is refused by name."""
    if procs is None or proc is None:
        procs, proc = process_group()
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise ValueError("no CUDA device visible: pass the ranks' "
                             "devices (e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    fixed = tp * sp * pp * ep
    if n % fixed != 0:
        raise ValueError(
            f"{n} devices not divisible by tp*sp*pp*ep={fixed}")
    if dp is None:
        dp = n // fixed
    if dp * fixed != n:
        raise ValueError(f"dp*tp*sp*pp*ep={dp * fixed} != {n} devices")
    later = {a: d for a, d in (("ep", ep), ("pp", pp)) if d > 1}
    if later:
        raise ValueError(
            f"mesh {later}: the PyTorch port runs the dp, tp and sp axes; "
            "ep and pp > 1 wait for MixtureOfExperts and the pipeline "
            "(ROADMAP Queue 1 item 8)")
    check_processes({"tp": tp, "sp": sp}, procs)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(pp, ep, sp, tp, dp), procs=procs, proc=proc)


def dp_data_rank(mesh: Mesh) -> Tuple[int, int]:
    """(data_rank, data_num_ranks) of this process: which shard of the
    record stream it feeds, from its dp coordinates as in the JAX
    package (process p of P holds global dp rows p*k .. p*k + k - 1, so
    it is shard p of P).  One process feeds the whole stream
    (`ParallelSolver.shard_batch` splits each batch over its dp ranks).
    The port's shard p is block p of each global batch of the one
    stream (`DataSource.take_block`), so that P processes train what
    one process trains."""
    if not mesh.spans or mesh.dp_total <= 1:
        return 0, 1
    return mesh.proc, mesh.procs


# ---------------------------------------------------------------------------
# named-axis layouts (param/input spec construction), shared by the
# training step (ParallelSolver) and the evaluation forward (BlobForward)
# ---------------------------------------------------------------------------

TP_MIN_FEATURES = 1024  # shard only matmuls big enough to matter


def tp_param_specs(net) -> Dict[str, Dict[str, Spec]]:
    """Spec per param blob: column-split large InnerProduct / Embed
    weights and the LSTM / RNN input projections over 'tp' (Megatron's
    split on num_output), the rest replicated; the JAX package's rule
    (its `tp_param_specs`), blob by blob."""
    specs: Dict[str, Dict[str, Spec]] = {}
    by_name = {lp.name: lp for lp in net.compute_layers}
    for lname, blobs in net.param_layout.items():
        lp = by_name[lname]
        specs[lname] = {}
        for bname, shape, _ in blobs:
            spec: Spec = ()
            if lp.type == "InnerProduct" and bname == "weight":
                ipp = lp.inner_product_param
                if int(ipp.num_output) >= TP_MIN_FEATURES:
                    # (num_output, K), or (K, num_output) transposed
                    spec = (None, "tp") if ipp.transpose else ("tp", None)
            elif lp.type == "InnerProduct" and bname == "bias":
                if int(lp.inner_product_param.num_output) >= TP_MIN_FEATURES:
                    spec = ("tp",)
            elif lp.type == "Embed" and bname == "weight":
                if int(lp.embed_param.num_output) >= TP_MIN_FEATURES:
                    spec = (None, "tp")      # (vocab, dim): dim split
            elif lp.type in ("LSTM", "RNN") and bname.startswith("W_x"):
                if int(lp.recurrent_param.num_output) * 4 >= TP_MIN_FEATURES:
                    spec = ("tp", None)      # (4N, D): gate split
            elif lp.type == "MixtureOfExperts" and bname in ("W1", "W2"):
                spec = ("ep", None, None)    # expert-dim split
            specs[lname][bname] = spec
    return specs


def validate_param_specs(specs: Dict[str, Dict[str, Spec]],
                         shapes: Dict[str, Dict[str, tuple]],
                         mesh: Mesh) -> None:
    """Divisibility guard: every split param dim must divide by its mesh
    axis (the JAX package's message)."""
    for ln, blobs in specs.items():
        for bn, spec in blobs.items():
            for dim_i, ax in enumerate(spec):
                if ax is None:
                    continue
                size = mesh.shape.get(ax, 1)
                dim = shapes[ln][bn][dim_i]
                if size > 1 and dim % size != 0:
                    raise ValueError(
                        f"layer {ln!r} blob {bn!r}: dim {dim_i} "
                        f"(size {dim}) not divisible by mesh axis "
                        f"{ax!r} (size {size}) — adjust "
                        f"num_experts/num_output or the mesh")


def split_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dimension `spec` splits over `axis`, or None."""
    return spec.index(axis) if axis in spec else None


class MeshLayout:
    """Where each parameter blob and each net input of one Net lives on
    one Mesh: blobs replicated or split over tp (`tp_param_specs`, with
    the divisibility guard), inputs split over dp on their batch axis
    (axis 1 for a time-major top, whose time stays whole: the ring
    splits it inside the attention).  ParallelSolver (training) and
    BlobForward (evaluation) share one object, so the forward that
    evaluates a model splits it as the step that trained it did."""

    def __init__(self, net, mesh: Mesh):
        self.net = net
        self.mesh = mesh
        self.tp_on = mesh.shape.get("tp", 1) > 1
        self.param_specs: Dict[str, Dict[str, Spec]] = (
            tp_param_specs(net) if self.tp_on
            else {ln: {bn: () for bn, _, _ in blobs}
                  for ln, blobs in net.param_layout.items()})
        self.shapes = {ln: {bn: s for bn, s, _ in blobs}
                       for ln, blobs in net.param_layout.items()}
        validate_param_specs(self.param_specs, self.shapes, mesh)

    @property
    def dp(self) -> int:
        return self.mesh.shape.get("dp", 1)

    # -- inputs ---------------------------------------------------------
    def input_specs(self, net=None) -> Dict[str, Spec]:
        """Per-input spec: the batch axis (`Net.input_batch_axes`) split
        over dp; with an sp axis, a time-major (T, B, ·) top's time over
        sp too (the JAX package's specs; the port's ring cuts the time
        itself, inside the attention)."""
        has_sp = self.mesh.shape.get("sp", 1) > 1
        out: Dict[str, Spec] = {}
        for name, ax in self.batch_axes(net).items():
            spec = [None] * ax + ["dp"]
            if has_sp and ax == 1:
                spec[0] = "sp"
            out[name] = tuple(spec)
        return out

    def batch_axes(self, net=None) -> Dict[str, int]:
        """The axis of each net input that dp splits."""
        return (net or self.net).input_batch_axes()

    def check_batch(self, net=None, dp: Optional[int] = None) -> None:
        """Refuse by name a data layer whose batch dp (this process's
        ranks, or the `dp` given: the global axis for the training net,
        whose prototxt batch is the global batch) does not divide (the
        JAX package cannot place such a batch on the mesh)."""
        net = net or self.net
        dp = self.dp if dp is None else dp
        axes = self.batch_axes(net)
        for name, shape, _ in net.input_specs:
            ax = axes[name]
            if dp > 1 and len(shape) > ax and shape[ax] % dp:
                layer = next((lp.name for lp in net.layers
                              if name in lp.top), name)
                raise ValueError(
                    f"layer {layer!r}: batch {shape[ax]} of {name!r} is "
                    f"not divisible by the mesh's dp axis ({dp} ranks)")

    # -- placement ------------------------------------------------------
    def place_params(self, params) -> Dict:
        """Each blob on the mesh's home device (its first rank's): the
        ranks' blocks are views of it, made by the step.  On one card
        every rank shares one storage."""
        home = self.mesh.devices.flat[0]
        return {ln: {bn: t.to(home) for bn, t in blobs.items()}
                for ln, blobs in params.items()}

    # -- identity -------------------------------------------------------
    def describe(self) -> Dict[str, object]:
        """JSON-serializable layout summary (the metrics' `info.mesh`):
        axes with extent > 1, the number of ranks, and the split blobs
        as the JAX package lists them ("layer/blob:tp,None")."""
        sharded = sorted(
            f"{ln}/{bn}:{','.join(str(a) for a in spec)}"
            for ln, blobs in self.param_specs.items()
            for bn, spec in blobs.items()
            if any(ax is not None for ax in spec))
        return {"axes": global_axes(self.mesh),
                "devices": self.mesh.size * self.mesh.procs,
                "sharded_params": sharded, **process_info(self.mesh)}


def lockstep_steps(total_records: int, batch_per_step: int,
                   num_ranks: int) -> int:
    """The minPartSize equalization invariant (`CaffeOnSpark.scala:185-
    200`): every rank must take the SAME number of steps or a collective
    deadlocks.  The per-epoch step count: floor(min records per rank /
    batch)."""
    per_rank = total_records // num_ranks
    return max(0, per_rank // batch_per_step)
