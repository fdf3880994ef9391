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
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from ..net import Params
from ..ops.layers import flash_mesh
from ..solver import OptState, Solver, steps_many, take_step
from .comm import Shards, all_gather, all_reduce, split
from .gradsync import RankGrads
from .mesh import Mesh, MeshLayout, Spec, split_dim

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
        self.layout.check_batch()
        if mesh.shape["dp"] > 1:
            solver.train_net.batch_axes()   # refuses what dp cannot split
        self.tp_on = self.layout.tp_on
        if zero_dp is None:
            zero_dp = os.environ.get("COS_ZERO") == "1"
        self.zero_on = bool(zero_dp) and mesh.shape["dp"] > 1
        self.param_specs = self.layout.param_specs
        self.state_specs = (zero_state_specs(self.param_specs,
                                             self.layout.shapes,
                                             mesh.shape["dp"])
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
        return self.mesh.shape["dp"]

    def global_batch(self, per_device_batch: int) -> int:
        """per_device_batch × dp (the JAX package's helper)."""
        return per_device_batch * self.num_dp_ranks

    # -- placement ---------------------------------------------------------
    def init(self) -> Tuple[Params, OptState]:
        params, st = self.solver.init()
        return self.shard_params(params), self.shard_opt_state(st)

    def shard_params(self, params: Params) -> Params:
        return self.layout.place_params(params)

    def shard_opt_state(self, st: OptState) -> OptState:
        """The state on the mesh: under ZeRO-1 each split blob becomes
        its dp ranks' slices (`Shards`, each its own tensor on its
        rank's device), the rest on the home device."""
        devs = self.mesh.axis_devices("dp")
        home = devs[0]

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
                             zip(split(t, len(devs), dim), devs)], dim)
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
            loss, blobs = net.loss_ranks(
                hooks.params if hooks is not None else leaves,
                self.shard_batch(sub), train=True, generator=self.generator,
                state_out=fwd_state, mesh=self.mesh, before_layer=hooks)
        if hooks is not None:
            hooks.done()
        flat = []
        for lv in leaves:
            for ln, bn in names:
                x = lv[ln][bn]
                flat.extend(x if isinstance(x, Shards) else (x,))
        got = torch.autograd.grad(loss, flat, allow_unused=True)
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
                grads.append(ranks[0][i].to(params[ln][bn].device)
                             if hooks is not None
                             else RankGrads([g[i] for g in ranks]))
                i += 1
            else:
                grads.append(all_reduce([g[i] for g in ranks], self.mesh,
                                        "dp")[0].to(params[ln][bn].device))
                i += 1
        outs = net.join_ranks(blobs, net.output_blobs)
        return (loss.detach(), {n: v.detach() for n, v in outs.items()},
                grads, fwd_state)

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
        n = len(h)
        slices = []
        for r, (wr, gr) in enumerate(zip(split(w, n, dim),
                                         split(g, n, dim))):
            dev = h[r].device
            w2, h_n, h2_n = self.solver.update_rule(
                wr.to(dev), gr.to(dev), h[r], h2[r], local_lr, dm)
            h[r].copy_(h_n)
            if h2_n is not None:
                h2[r].copy_(h2_n)
            slices.append(w2)
        w.copy_(all_gather(slices, dim))

    def train_step(self, params: Params, state: OptState,
                   inputs: Dict[str, torch.Tensor]):
        """One dp step of the global batch `inputs`, in place on params
        and state (Solver.train_step's contract)."""
        return take_step(self, params, state, inputs)

    def train_step_many(self, k: int):
        """k dp steps a block: on a card one CUDA graph (`GraphedSteps`
        captures the ranks' leaves, the all_reduce and the ZeRO slices),
        on the CPU k eager steps."""
        return steps_many(self, k)

    def eval_step(self):
        """The validation forward of the TEST net under this layout: the
        same `BlobForward` the -test / -features path uses."""
        if self._eval is None:
            from ..serving.forward import BlobForward
            net = self.solver.test_net
            if net is None:
                raise ValueError("no TEST-phase net in this config")
            self.layout.check_batch(net)
            self._eval = BlobForward(net, layout=self.layout)(
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

