"""Data- and tensor-parallel execution of a Solver step over a mesh: the
counterpart of `caffeonspark_tpu/parallel/dp.py`.

The JAX package's step IS the single-device step on the global batch,
which GSPMD partitions: the batch sharded over dp, parameters
replicated or split over tp, XLA's gradient all-reduce implied by the
loss being a mean over the sharded batch.  The port writes that
partition out.  Each dp rank runs the forward and the backward on its
B/dp slice of the global batch, with parameter leaves of its own (views
of the one storage when its ranks share a card), so each rank has
gradients of its own; `parallel.comm.all_reduce` sums them over dp, blob
by blob, or the gradient exchange (`gradsync.py`, COS_GRAD_SYNC) sums
them bucket by bucket.
The forward goes layer by layer across the ranks (`Net.forward_ranks`),
so every layer that couples the batch sees the global batch, as under
GSPMD: BatchNorm's statistics, the losses' normalizers, Accuracy, and
Dropout's mask, drawn once for the whole batch.  dp N therefore takes
dp 1's step on the same global batch, up to the order of the sums.

Tensor parallelism: `MeshLayout` splits the large InnerProduct, Embed
and LSTM / RNN input weights by column over tp (`tp_param_specs`); each
tp rank computes its column block, an all_gather joins them.
MultiHeadAttention splits its heads over tp and its batch over dp, so
the flash kernels run once per (B/dp, H/tp) block, and under dp × sp the
ring runs once per dp row.

ZeRO-1 (`COS_ZERO=1` or `ParallelSolver(zero_dp=True)`):
`zero_state_specs` splits the optimizer state of each blob of at least
ZERO_MIN_NUMEL elements over dp, on its largest divisible dimension,
into one tensor per dp rank (`parallel.comm.Shards`).  Rank r updates
its slice of the parameters from its slice of the reduced gradient and
its state; an all_gather joins the slices.  Composes with
COS_STATE_DTYPE.  Snapshots gather the state (`checkpoint.whole_state`):
the files have dp 1's layout.

Several processes (`mesh.distributed_init`, gloo): the dp axis spans
them, each process running its own ranks' forward and backward
(`Net.forward_ranks` over the processes: the couplings of the batch,
the losses' normalizers and Dropout's one global draw, cross them) and
exchanging the gradients through `parallel.comm`, so that every process
applies the same update.  The step it is given is its block of the
global batch (`DataSource.take_block`).  Every process starts from the
same parameters, drawn from one seed; `check_start` holds them equal
once, by a checksum over the processes.  Under ZeRO-1 a process holds
the state slices of its own dp ranks, and a snapshot writes them as its
sharded sidecar (`checkpoint.snapshot`).  COS_STEPS_PER_LOOP=K keeps
its chunks, each K eager steps: a gloo collective cannot be captured in
a CUDA graph.
"""

from __future__ import annotations

import functools
import logging
import os
import zlib
from typing import Dict, List, Optional, Tuple

import torch

from ..net import Params
from ..ops.layers import flash_mesh
from ..solver import OptState, Solver, eager_many, steps_many, take_step
from .comm import (Shards, all_gather, all_gather_dp, all_reduce,
                   process_sum, split)
from .gradsync import RankGrads
from .mesh import Mesh, MeshLayout, Spec, split_dim

_LOG = logging.getLogger(__name__)

ZERO_MIN_NUMEL = 16384  # split only state blobs big enough to matter


def zero_state_specs(param_specs: Dict[str, Dict[str, Spec]],
                     shapes: Dict[str, Dict[str, tuple]],
                     dp: int, *, min_numel: int = ZERO_MIN_NUMEL
                     ) -> Dict[str, Dict[str, Spec]]:
    """ZeRO-1 optimizer-state specs: for each blob of at least
    `min_numel` elements, 'dp' on the LARGEST unsplit dimension that dp
    divides (so the slices balance: an fc (4096, 9216) blob splits its
    9216 axis), the first such on a tie; the params keep their specs.
    The JAX package's rule, blob by blob."""
    out: Dict[str, Dict[str, Spec]] = {}
    for ln, blobs in param_specs.items():
        out[ln] = {}
        for bn, spec in blobs.items():
            shape = shapes[ln][bn]
            numel = 1
            for d in shape:
                numel *= int(d)
            new = spec
            if dp > 1 and shape and numel >= min_numel and "dp" not in spec:
                axes = list(spec) + [None] * (len(shape) - len(spec))
                best = None
                for i, (ax, dim) in enumerate(zip(axes, shape)):
                    if ax is None and dim % dp == 0 and (
                            best is None or dim > shape[best]):
                        best = i
                if best is not None:
                    axes[best] = "dp"
                    new = tuple(axes)
            out[ln][bn] = new
    return out


def rank_blocks(t: torch.Tensor, spec: Spec, mesh: Mesh,
                leaf: bool) -> object:
    """One dp rank's view of a param blob: the tensor, or its tp column
    blocks (`Shards`) when `spec` splits it over tp.  `leaf` makes each
    a fresh autograd leaf (the rank's own gradient)."""
    def own(x):
        return x.detach().requires_grad_(True) if leaf else x
    dim = split_dim(spec, "tp")
    if dim is None or mesh.shape["tp"] == 1:
        return own(t)
    devs = mesh.axis_devices("tp")
    return Shards([own(b.to(d)) for b, d in
                   zip(split(t, len(devs), dim), devs)], dim)


def rank_params(layout: MeshLayout, params: Params, leaf: bool = False
                ) -> List[Params]:
    """The dp ranks' params ({layer: {blob: tensor or Shards}}), each on
    its dp row's devices."""
    out = []
    for r in range(layout.dp):
        row = layout.mesh.sub(dp=r)
        out.append({ln: {bn: rank_blocks(
            t.to(row.devices.flat[0]),
            layout.param_specs.get(ln, {}).get(bn, ()), row, leaf)
            for bn, t in bl.items()} for ln, bl in params.items()})
    return out


def shard_inputs(layout: MeshLayout, inputs: Dict[str, torch.Tensor],
                 net=None) -> List[Dict[str, torch.Tensor]]:
    """The global batch cut into the dp ranks' slices (each input on its
    batch axis, `MeshLayout.batch_axes`), each on its rank's device."""
    axes = layout.batch_axes(net)
    dp = layout.dp
    cut = {k: split(v, dp, axes[k]) if k in axes else [v] * dp
           for k, v in inputs.items()}
    return [{k: blocks[r].to(layout.mesh.sub(dp=r).devices.flat[0])
             for k, blocks in cut.items()} for r in range(dp)]


class ParallelSolver:
    """A Solver's train / eval step over a mesh, with the Solver's step
    interface (`train_step`, `train_step_many`, `loss_grads_and_state`,
    `apply_update`), so that `GraphedSteps` captures the dp step."""

    def __init__(self, solver: Solver, mesh: Mesh, *,
                 zero_dp: Optional[bool] = None):
        self.solver = solver
        self.mesh = mesh
        # one layout for the training step and the evaluation forward
        self.layout = MeshLayout(solver.train_net, mesh)
        # the prototxt batch is the global batch, over every process
        self.layout.check_batch(dp=mesh.dp_total)
        if mesh.dp_total > 1:
            solver.train_net.batch_axes()   # refuses what dp cannot split
        self.tp_on = self.layout.tp_on
        if zero_dp is None:
            zero_dp = os.environ.get("COS_ZERO") == "1"
        self.zero_on = bool(zero_dp) and mesh.dp_total > 1
        self.param_specs = self.layout.param_specs
        self.state_specs = (zero_state_specs(self.param_specs,
                                             self.layout.shapes,
                                             mesh.dp_total)
                            if self.zero_on else self.param_specs)
        # the gradient exchange (gradsync.py): the mesh resolves
        # COS_GRAD_SYNC=auto and carries the reductions; the blobs split
        # over tp keep the per-block path (JAX dp.py:123-133)
        solver.grad_sync.bind_mesh(mesh, skip_blobs=frozenset(
            (ln, bn) for ln, blobs in self.param_specs.items()
            for bn, spec in blobs.items()
            if any(ax is not None for ax in spec)))
        self._many: Dict[int, object] = {}
        self._eval = None

    # -- the Solver's attributes the step reads --------------------------
    @property
    def param(self):
        return self.solver.param

    @property
    def device(self) -> torch.device:
        return self.solver.device

    @property
    def train_net(self):
        return self.solver.train_net

    @property
    def generator(self) -> torch.Generator:
        return self.solver.generator

    @property
    def grad_sync(self):
        return self.solver.grad_sync

    @property
    def _mult_values(self):
        return self.solver._mult_values

    def update_scalars(self, lr, it: int) -> List[float]:
        return self.solver.update_scalars(lr, it)

    @property
    def num_dp_ranks(self) -> int:
        """The dp ranks over every process."""
        return self.mesh.dp_total

    def global_batch(self, per_device_batch: int) -> int:
        """per_device_batch × dp (the JAX package's helper)."""
        return per_device_batch * self.num_dp_ranks

    # -- placement ---------------------------------------------------------
    def init(self) -> Tuple[Params, OptState]:
        params, st = self.solver.init()
        return self.shard_params(params), self.shard_opt_state(st)

    def shard_params(self, params: Params) -> Params:
        return self.layout.place_params(params)

    def check_start(self, params: Params, state: OptState) -> None:
        """Every process starts from the same parameters and iteration:
        each one's checksum (CRC-32 over the blobs' bytes, in the net's
        blob order, and the iteration) is gathered over the processes,
        and a process whose sum is not rank 0's is named.  One
        collective; nothing with one process."""
        if not self.mesh.spans:
            return
        import torch.distributed as dist
        crc = zlib.crc32(str(int(state.iter)).encode())
        for ln, specs in self.train_net.param_layout.items():
            for bn, _, _ in specs:
                t = params[ln][bn].detach().contiguous().to("cpu")
                crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes(), crc)
        mine = torch.tensor([crc], dtype=torch.int64)
        every = torch.empty(self.mesh.procs, dtype=torch.int64)
        dist.all_gather_into_tensor(every, mine)
        bad = [r for r, c in enumerate(every.tolist()) if c != every[0]]
        if bad:
            raise RuntimeError(
                f"rank {', '.join(map(str, bad))}: parameters (or "
                f"iteration) differ from rank 0's at the start (checksums "
                f"{every.tolist()}); every process must start from the "
                "same seed, -weights and -snapshot")

    def shard_opt_state(self, st: OptState) -> OptState:
        """The state on the mesh: under ZeRO-1 each split blob becomes
        its dp ranks' slices (`Shards`, each its own tensor on its
        rank's device; over several processes this process's ranks'
        slices of the global split), the rest on the home device."""
        devs = self.mesh.axis_devices("dp")
        home = devs[0]
        k, off = len(devs), self.mesh.dp_offset
        n = self.mesh.dp_total

        def place(tree):
            out = {}
            for ln, bl in tree.items():
                out[ln] = {}
                for bn, t in bl.items():
                    dim = split_dim(self.state_specs[ln][bn], "dp")
                    if isinstance(t, Shards):
                        t = t.whole()
                    if dim is None:
                        out[ln][bn] = t.to(home)
                    else:
                        out[ln][bn] = Shards(
                            [b.to(d).clone() for b, d in
                             zip(split(t, n, dim)[off:off + k], devs)],
                            dim, first=off, parts=n)
            return out

        return OptState(iter=st.iter, history=place(st.history),
                        history2=place(st.history2))

    def shard_batch(self, batch: Dict[str, torch.Tensor], net=None
                    ) -> List[Dict[str, torch.Tensor]]:
        return shard_inputs(self.layout, batch, net)

    # -- the step ------------------------------------------------------------
    def _sub_grads(self, params: Params, sub: Dict[str, torch.Tensor],
                   names: List[Tuple[str, str]]):
        """One sub-batch of the dp step: each rank's forward and backward
        on its slice with leaves of its own, then the gradients summed
        over dp (tp blocks first summed, then joined).  The blobs of the
        gradient exchange's buckets are summed by its backward hooks,
        whose result is taken as it is, or else handed on unreduced
        (`RankGrads`) to its one exchange a step."""
        from ..ops.layers import flash_mesh
        net = self.train_net
        gs = self.grad_sync
        leaves = rank_params(self.layout, params, leaf=True)
        bucketed = gs.bucketed()
        hooks = (gs.attach(leaves)
                 if gs.use_hooks(max(1, int(self.param.iter_size))) else None)
        fwd_state: Dict[str, List[torch.Tensor]] = {}
        with flash_mesh(self.mesh):
            loss_graph, blobs = net.loss_ranks(
                hooks.params if hooks is not None else leaves,
                self.shard_batch(sub), train=True, generator=self.generator,
                state_out=fwd_state, mesh=self.mesh, before_layer=hooks)
        if hooks is not None:
            hooks.done()
        # this process's ranks' shares of the loss: over processes, the
        # sum of every process's (the outputs join likewise)
        loss = process_sum(loss_graph.detach(), self.mesh)
        flat = []
        for lv in leaves:
            for ln, bn in names:
                x = lv[ln][bn]
                flat.extend(x if isinstance(x, Shards) else (x,))
        got = torch.autograd.grad(loss_graph, flat, allow_unused=True)
        # the hooks' reductions issued without waiting (processes), done
        reduced = gs.finish() if hooks is not None else {}
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(flat, got)]
        per_rank = len(got) // len(leaves)
        ranks = [got[r * per_rank:(r + 1) * per_rank]
                 for r in range(len(leaves))]
        grads, i = [], 0
        for ln, bn in names:
            x = leaves[0][ln][bn]
            if isinstance(x, Shards):
                blocks = [all_reduce([g[i + j] for g in ranks], self.mesh,
                                     "dp")[0] for j in range(len(x))]
                grads.append(all_gather(blocks, x.dim).to(
                    params[ln][bn].device))
                i += len(x)
            elif (ln, bn) in bucketed:
                # reduced once: by the hook, or by the exchange
                if hooks is None:
                    grads.append(RankGrads([g[i] for g in ranks]))
                else:
                    grads.append(reduced.get((ln, bn), ranks[0][i]).to(
                        params[ln][bn].device))
                i += 1
            else:
                grads.append(all_reduce([g[i] for g in ranks], self.mesh,
                                        "dp")[0].to(params[ln][bn].device))
                i += 1
        outs = net.join_ranks([{n: b[n].detach() for n in net.output_blobs}
                               for b in blobs], net.output_blobs, self.mesh)
        return loss, outs, grads, fwd_state

    def loss_grads_and_state(self, params: Params,
                             inputs: Dict[str, torch.Tensor]):
        """Solver.loss_grads_and_state with the dp sub-batch step."""
        return self.solver.loss_grads_and_state(params, inputs,
                                                sub_grads=self._sub_grads)

    def loss_and_grads(self, params: Params,
                       inputs: Dict[str, torch.Tensor]):
        return self.loss_grads_and_state(params, inputs)[:3]

    @torch.no_grad()
    def apply_update(self, params: Params, grads: Params, state: OptState,
                     lr, scalars=None) -> None:
        """Solver.apply_update; under ZeRO-1 each dp rank updates its
        slice of a split blob."""
        self.solver.apply_update(params, grads, state, lr, scalars=scalars,
                                 blob_update=self._update_blob)

    def _update_blob(self, w, g, h, h2, local_lr, dm) -> None:
        if not isinstance(h, Shards):
            self.solver.update_blob(w, g, h, h2, local_lr, dm)
            return
        dim = h.dim
        ws, gs = split(w, h.parts, dim), split(g, h.parts, dim)
        slices = []
        for r in range(len(h)):
            dev = h[r].device
            w2, h_n, h2_n = self.solver.update_rule(
                ws[h.first + r].to(dev), gs[h.first + r].to(dev), h[r],
                h2[r], local_lr, dm)
            h[r].copy_(h_n)
            if h2_n is not None:
                h2[r].copy_(h2_n)
            slices.append(w2)
        # every process's slices, over the processes when they hold some
        w.copy_(all_gather_dp(slices, dim, self.mesh if h.spans else None))

    def train_step(self, params: Params, state: OptState,
                   inputs: Dict[str, torch.Tensor]):
        """One dp step of the global batch `inputs`, in place on params
        and state (Solver.train_step's contract)."""
        return take_step(self, params, state, inputs)

    def train_step_many(self, k: int):
        """k dp steps a block: on a card one CUDA graph (`GraphedSteps`
        captures the ranks' leaves, the all_reduce and the ZeRO slices),
        on the CPU k eager steps; over several processes k eager steps
        everywhere (a gloo collective cannot be captured), logged once."""
        if not self.mesh.spans:
            return steps_many(self, k)
        fn = self._many.get(k)
        if fn is None:
            if self.device.type == "cuda":
                _LOG.info("COS_STEPS_PER_LOOP=%d over %d processes: each "
                          "chunk runs its steps eagerly, without a CUDA "
                          "graph (a gloo collective cannot be captured)",
                          k, self.mesh.procs)
            fn = self._many[k] = functools.partial(eager_many, self, k)
        return fn

    def eval_step(self):
        """The validation forward of the TEST net under this layout: the
        same `BlobForward` the -test / -features path uses."""
        if self._eval is None:
            from ..serving.forward import BlobForward
            net = self.solver.test_net
            if net is None:
                raise ValueError("no TEST-phase net in this config")
            # over several processes each evaluates the whole replicated
            # batch on its own ranks
            layout = (MeshLayout(self.train_net, self.mesh.local())
                      if self.mesh.spans else self.layout)
            layout.check_batch(net)
            self._eval = BlobForward(net, layout=layout)(
                tuple(net.output_blobs))
        return self._eval

    def state_bytes(self, st: OptState) -> List[int]:
        """Optimizer-state bytes held by each dp rank (a split blob
        counts its slice on its rank, a whole one on every rank)."""
        n = self.mesh.shape["dp"]
        out = [0] * n
        for tree in (st.history, st.history2):
            for bl in tree.values():
                for t in bl.values():
                    for r in range(n):
                        x = t[r] if isinstance(t, Shards) else t
                        out[r] += x.numel() * x.element_size()
        return out

