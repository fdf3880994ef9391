"""The gradient exchange of the dp ranks (COS_GRAD_SYNC): the counterpart
of `caffeonspark_tpu/parallel/gradsync.py`, with its names, its plan and
its byte model.

The reference's reason to exist was its gradient exchange (`P2PSync`
inside a node, `SocketSync` / `RDMASync` sharded across nodes).  Without
this module the port's dp step sums each blob's gradients over the ranks
with one `comm.all_reduce`, after the whole backward
(`ParallelSolver._sub_grads`).  Here the exchange is a layer of its own:

  COS_GRAD_SYNC=default   inert: no op is added, the step is the
                          per-blob all_reduce as before
  COS_GRAD_SYNC=bucket    the param blobs go into flat buckets of about
                          COS_GRAD_BUCKET_MB in reverse-backward order (the
                          order their gradients are final); a
                          `torch.autograd.Function` per bucket takes every
                          rank's leaves of the bucket, and its backward,
                          which autograd runs once the bucket's last
                          cotangent is ready, reduces the bucket there, in
                          the middle of the backward
  COS_GRAD_SYNC=quant     bucket, and the reduced flat is rounded through
                          COS_GRAD_WIRE_DTYPE (bfloat16 by default; int8
                          on a per-bucket max-abs scale, with stochastic
                          rounding); the optimizer sees the value cast
                          back to the gradient's dtype
  COS_GRAD_SYNC=hier      bucket, and the reduction is a reduce-scatter
                          (rank r sums slice r of the flat, padded to a
                          multiple of dp) followed by an all_gather
  COS_GRAD_SYNC=auto      default with no mesh or dp 1, else bucket.  The
                          JAX package picks hier when more than one
                          process holds the dp ranks; the port runs its
                          ranks in one process, so that branch cannot
                          arise until ROADMAP Queue 1 item 6c brings
                          several processes

What the wire rounds.  In the JAX package the bf16 cast precedes the
replication constraint on a value that is logically the global gradient
already, and XLA places the all-reduce.  On its 8 virtual CPU devices
the result at dp 8 equals "sum the ranks' f32 partials, then round to
bf16" on every element of the tiny net's fc_big weight (2,359,296
elements), and differs from "round each rank's partial to bf16, then
sum" on about a third of them.  So the port sums in the gradient's dtype
and rounds the sum: the sums run at accumulator precision and the cast
models the wire's payload.  int8 quantizes the reduced value too, with
one max-abs scale over the bucket's global flat (JAX docstring, "int8
quantizes the already-reduced value").  With one rank (no mesh) the
transform still rounds: `quant` on one device trains through the bf16 or
int8 round trip, as in the JAX package.

Once a step.  With hooks (`use_hooks`: COS_GRAD_OVERLAP not 0,
iter_size 1, no int8) each bucket is reduced by its hook, and
`ParallelSolver._sub_grads` takes that reduced gradient as it is.
Otherwise `exchange` runs once, in `Solver.loss_grads_and_state`, on the
gradient accumulated over the iter_size sub-batches: each dp rank keeps
its own sum (`RankGrads`) until then.  A gradient that is reduced twice
is dp times too large.

Stochastic rounding draws from `GradSync.generator` (a torch.Generator
of its own, so that Dropout's stream is the same in every mode, seeded
from the solver's seed mixed with a fixed salt, so that its numbers are
not Dropout's and the rounding noise does not follow the mask); a CUDA
graph of solver steps registers it (`solver.GraphedSteps`).  The int8
scale never leaves the device.

Blobs split over tp (their gradients are per block, not replicated) and
BatchNorm's running statistics (never optimized) stay out of the buckets
and keep the per-blob path.
"""

from __future__ import annotations

import math
import os
from typing import Dict, FrozenSet, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import torch

from . import comm

MODES = ("auto", "default", "bucket", "quant", "hier")
WIRE_DTYPES = ("bfloat16", "int8")

_DEFAULT_BUCKET_MB = 25.0     # DDP-style default; COS_GRAD_BUCKET_MB
_INT8_SCALE_BYTES = 4         # one f32 max-abs scale rides per bucket
# mixed into the seed of the stochastic-rounding stream, so that it never
# draws Dropout's numbers (the solver seeds both from random_seed + rank)
_ROUNDING_SALT = 0x6A09E667F3BCC908


def env_mode(environ: Optional[Mapping[str, str]] = None) -> str:
    env = os.environ if environ is None else environ
    m = env.get("COS_GRAD_SYNC", "default").strip().lower()
    if m not in MODES:
        raise ValueError(
            f"COS_GRAD_SYNC={m!r}: expected one of {'|'.join(MODES)}")
    return m


def env_bucket_mb(environ: Optional[Mapping[str, str]] = None) -> float:
    env = os.environ if environ is None else environ
    v = env.get("COS_GRAD_BUCKET_MB", "")
    return float(v) if v else _DEFAULT_BUCKET_MB


def env_wire_dtype(environ: Optional[Mapping[str, str]] = None
                   ) -> Optional[str]:
    env = os.environ if environ is None else environ
    v = env.get("COS_GRAD_WIRE_DTYPE", "").strip().lower()
    if v and v not in WIRE_DTYPES:
        raise ValueError(
            f"COS_GRAD_WIRE_DTYPE={v!r}: expected one of "
            f"{'|'.join(WIRE_DTYPES)}")
    return v or None


class Bucket(NamedTuple):
    """One exchange unit: blobs whose grads finalize together."""
    index: int
    entries: Tuple[Tuple[str, str], ...]    # (layer, blob) in fire order
    shapes: Tuple[Tuple[int, ...], ...]
    numel: int
    bytes_grad: int                          # at the grad dtype
    bytes_wire: int                          # at the wire dtype


class GradSyncPlan(NamedTuple):
    """Static exchange metadata: what goes on the wire, in what order,
    in what dtype (the transform's and the metrics `comm` block's)."""
    mode: str                                # resolved, never "auto"
    wire_dtype: Optional[str]                # None = grad dtype
    bucket_mb: float
    buckets: Tuple[Bucket, ...]
    total_numel: int
    total_bytes_grad: int
    total_bytes_wire: int
    skipped: Tuple[Tuple[str, str], ...]     # blobs left to the per-blob path

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def comm_info(self) -> dict:
        """The `comm` block of the PipelineMetrics JSON: per-step
        exchange traffic at a glance."""
        return {
            "mode": self.mode,
            "wire_dtype": self.wire_dtype or "grad",
            "bucket_mb": self.bucket_mb,
            "buckets": self.n_buckets,
            "bucket_bytes_wire": [b.bytes_wire for b in self.buckets],
            "exchanged_params": self.total_numel,
            "bytes_per_step_wire": self.total_bytes_wire,
            "bytes_per_step_dense_f32": self.total_numel * 4,
            "skipped_blobs": len(self.skipped),
        }

    def exposed_wire_bytes(self, local_size: int = 1,
                           hide_bytes: Optional[int] = None) -> int:
        """Modeled wire bytes per step that no backward compute hides.
        `default` serializes the whole dense exchange after the backward.
        The overlap modes hide buckets under the remaining backward,
        fully when `hide_bytes` is None, else up to that capacity, except
        the last-fired bucket (the first layer's: nothing is left to hide
        it under), the standard DDP overlap model.  `hier` divides every
        wire quantity by the modeled intra-host group size first: the
        slow cross-host hop carries 1/local of the bytes after the
        intra-host reduce-scatter."""
        div = max(1, int(local_size)) if self.mode == "hier" else 1
        total = -(-self.total_bytes_wire // div)
        if self.mode == "default":
            return total
        last = (-(-self.buckets[-1].bytes_wire // div)
                if self.buckets else 0)
        if hide_bytes is None:
            return last
        return max(last, total - int(hide_bytes))

    def tier_wire_bytes(self, local_size: int = 1,
                        hide_bytes: Optional[int] = None
                        ) -> Tuple[int, int]:
        """(intra_host, inter_host) modeled exposed wire bytes per step.
        Flat modes put every exposed byte on the slow inter-host link:
        (0, exposed).  `hier`'s inter-host leg carries the 1/local slice
        (`exposed_wire_bytes`), and its intra-host reduce-scatter and
        all_gather together move about twice the exposed single-link
        bytes over the fast local links; 0 when the host holds one
        rank."""
        inter = self.exposed_wire_bytes(local_size=local_size,
                                        hide_bytes=hide_bytes)
        if self.mode != "hier" or max(1, int(local_size)) <= 1:
            return (0, inter)
        intra = 2 * self.exposed_wire_bytes(local_size=1,
                                            hide_bytes=hide_bytes)
        return (intra, inter)

    @property
    def n_messages(self) -> int:
        """Wire messages per step (per-message latency floor term)."""
        return 1 if self.mode == "default" else self.n_buckets


def _wire_for(mode: str, wire_env: Optional[str]) -> Optional[str]:
    """quant defaults to bf16 wire; hier honors an explicit wire dtype
    but stays at grad dtype otherwise; bucket/default never recast."""
    if mode == "quant":
        return wire_env or "bfloat16"
    if mode == "hier":
        return wire_env
    return None


def build_plan(net, mode: str, *, bucket_mb: Optional[float] = None,
               wire_dtype: Optional[str] = None,
               skip_blobs: FrozenSet[Tuple[str, str]] = frozenset()
               ) -> GradSyncPlan:
    """Bucket the net's param blobs in reverse-backward order (the order
    their grads finalize: last compute layer first).  Reads no
    environment: GradSync resolves the knobs once and passes them in."""
    bucket_mb = _DEFAULT_BUCKET_MB if bucket_mb is None else bucket_mb
    wire = _wire_for(mode, wire_dtype)
    grad_itemsize = net.dtype.itemsize
    wire_itemsize = (1 if wire == "int8" else
                     2 if wire == "bfloat16" else grad_itemsize)
    stat = set(net.stat_param_layers())
    skipped: List[Tuple[str, str]] = []
    order: List[Tuple[str, str, Tuple[int, ...]]] = []
    for lp in reversed(net.compute_layers):
        specs = net.param_layout.get(lp.name)
        if not specs:
            continue
        for bname, shape, _ in reversed(specs):
            if lp.name in stat or (lp.name, bname) in skip_blobs:
                skipped.append((lp.name, bname))
            else:
                order.append((lp.name, bname, tuple(shape)))

    cap = max(1, int(bucket_mb * (1 << 20)))
    buckets: List[Bucket] = []
    cur: List[Tuple[str, str, Tuple[int, ...]]] = []
    cur_bytes = 0

    def _flush():
        nonlocal cur, cur_bytes
        if not cur:
            return
        numel = sum(math.prod(s) for _, _, s in cur)
        wire_b = numel * wire_itemsize + (
            _INT8_SCALE_BYTES if wire == "int8" else 0)
        buckets.append(Bucket(
            index=len(buckets),
            entries=tuple((ln, bn) for ln, bn, _ in cur),
            shapes=tuple(s for _, _, s in cur),
            numel=numel, bytes_grad=numel * grad_itemsize,
            bytes_wire=wire_b))
        cur, cur_bytes = [], 0

    for ln, bn, shape in order:
        n = math.prod(shape)
        if cur and cur_bytes + n * grad_itemsize > cap:
            _flush()
        cur.append((ln, bn, shape))
        cur_bytes += n * grad_itemsize
    _flush()

    total_numel = sum(b.numel for b in buckets)
    return GradSyncPlan(
        mode=mode, wire_dtype=wire, bucket_mb=float(bucket_mb),
        buckets=tuple(buckets), total_numel=total_numel,
        total_bytes_grad=total_numel * grad_itemsize,
        total_bytes_wire=sum(b.bytes_wire for b in buckets),
        skipped=tuple(skipped))


# ---------------------------------------------------------------------------
def quantize_int8(flat: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket symmetric int8: max-abs scale and stochastic rounding
    from `generator` (unbiased: E[q·scale] = flat), or round-to-nearest-
    even without one.  Returns (q_int8, f32 0-dim scale)."""
    from ..ops.kernels import quantize_int8 as q8
    return q8(flat, generator)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


class RankGrads(list):
    """The dp ranks' own gradients of one blob, in rank order, not yet
    reduced: what the dp step hands to `GradSync.exchange` when the
    exchange runs once, after the iter_size accumulation."""

    def __add__(self, other):
        return RankGrads([a + b for a, b in zip(self, other)])

    def __truediv__(self, n):
        return RankGrads([a / n for a in self])


class _BucketHook(torch.autograd.Function):
    """Identity over every rank's leaves of one bucket; its backward
    runs once the bucket's last cotangent is ready and returns the
    reduced (and, for quant, rounded) gradient to each rank's leaf."""

    @staticmethod
    def forward(ctx, gs, bucket, n_ranks, *leaves):
        ctx.gs, ctx.bucket, ctx.n_ranks = gs, bucket, n_ranks
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *cts):
        m = len(ctx.bucket.entries)
        ranks = [list(cts[r * m:(r + 1) * m]) for r in range(ctx.n_ranks)]
        out = ctx.gs._transform_bucket(ctx.bucket, ranks, None)
        return (None, None, None,
                *(g.to(c.device) for r in range(ctx.n_ranks)
                  for g, c in zip(out, ranks[r])))


class BucketHooks:
    """The backward hooks of one forward.  Each bucket's hook is applied
    just before the forward's first layer of the bucket (the layer of its
    last entry) reads its params.  PyTorch's autograd engine runs, of the
    nodes that are ready, the one made last in the forward; a hook made
    there runs as soon as the bucket's last cotangent is in, before the
    backward of the layers below it.  (Made before the whole forward, as
    the JAX package's `attach` wraps the params, every hook would run
    last.)"""

    def __init__(self, gs: "GradSync", rank_params: Sequence[Dict]):
        self.gs = gs
        self.params = [{ln: dict(bl) for ln, bl in p.items()}
                       for p in rank_params]
        self._opens: Dict[str, List[Bucket]] = {}
        for bucket in gs.plan.buckets:
            self._opens.setdefault(bucket.entries[-1][0], []).append(bucket)

    def __call__(self, layer: str) -> None:
        n = len(self.params)
        for bucket in self._opens.pop(layer, ()):
            keys = [(p, e) for p in self.params for e in bucket.entries]
            new = _BucketHook.apply(self.gs, bucket, n,
                                    *(p[ln][bn] for p, (ln, bn) in keys))
            if isinstance(new, torch.Tensor):
                new = (new,)
            for (p, (ln, bn)), v in zip(keys, new):
                p[ln][bn] = v

    def done(self) -> None:
        """Every bucket went through its hook (else a blob's gradient
        would leave the step unreduced)."""
        if self._opens:
            raise RuntimeError(
                "gradient-exchange hooks never applied: the forward did "
                f"not reach {sorted(self._opens)}")


class GradSync:
    """The exchange itself: bucketing, the wire transform and the
    reduction, applied by backward hooks (`attach`, per bucket in the
    middle of the backward) or to the finished gradients (`exchange`).
    Both paths run the same per-bucket transform.  Inert (`enabled`
    False) in `default` mode."""

    def __init__(self, net, *, mode: Optional[str] = None,
                 bucket_mb: Optional[float] = None,
                 wire_dtype: Optional[str] = None,
                 overlap: Optional[bool] = None, seed: int = 0):
        self.net = net
        self.requested = env_mode() if mode is None else mode
        if self.requested not in MODES:
            raise ValueError(f"grad-sync mode {self.requested!r}: "
                             f"expected one of {'|'.join(MODES)}")
        self._bucket_mb = (env_bucket_mb() if bucket_mb is None
                           else float(bucket_mb))
        self._wire_env = (env_wire_dtype() if wire_dtype is None
                          else wire_dtype)
        if overlap is None:
            overlap = os.environ.get("COS_GRAD_OVERLAP", "1") != "0"
        self.overlap = bool(overlap)
        self.seed = int(seed)
        self.mesh = None
        self._skip: FrozenSet[Tuple[str, str]] = frozenset()
        self._plan: Optional[GradSyncPlan] = None
        self._generator: Optional[torch.Generator] = None

    # -- topology ------------------------------------------------------
    def bind_mesh(self, mesh,
                  skip_blobs: FrozenSet[Tuple[str, str]] = frozenset()
                  ) -> "GradSync":
        """Called by ParallelSolver before any step: the mesh resolves
        `auto` and carries the reductions, and the tp-split blobs stay
        out of the buckets."""
        self.mesh = mesh
        self._skip = frozenset(skip_blobs)
        self._plan = None
        return self

    @property
    def mode(self) -> str:
        if self.requested != "auto":
            return self.requested
        dp = self.mesh.shape.get("dp", 1) if self.mesh is not None else 1
        # more than one process (the JAX package's hier branch) is
        # ROADMAP Queue 1 item 6c: the port's ranks share one process
        return "default" if dp <= 1 else "bucket"

    @property
    def enabled(self) -> bool:
        return self.mode != "default"

    @property
    def plan(self) -> GradSyncPlan:
        if self._plan is None or self._plan.mode != self.mode:
            self._plan = build_plan(self.net, self.mode,
                                    bucket_mb=self._bucket_mb,
                                    wire_dtype=self._wire_env,
                                    skip_blobs=self._skip)
        return self._plan

    @property
    def needs_rng(self) -> bool:
        return self.enabled and self.plan.wire_dtype == "int8"

    @property
    def generator(self) -> torch.Generator:
        """The stochastic-rounding stream, on the net's device: not
        Dropout's stream at the same seed."""
        if self._generator is None:
            self._generator = torch.Generator(
                device=self.net.device).manual_seed(
                    self.seed ^ _ROUNDING_SALT)
        return self._generator

    def use_hooks(self, iter_size: int) -> bool:
        """Backward hooks need a deterministic backward (no rng) and one
        exchange per optimizer step (iter_size == 1)."""
        return (self.enabled and self.overlap and iter_size <= 1
                and not self.needs_rng)

    def bucketed(self) -> FrozenSet[Tuple[str, str]]:
        """The blobs the exchange reduces (none when inert)."""
        if not self.enabled:
            return frozenset()
        return frozenset(e for b in self.plan.buckets for e in b.entries)

    # -- the per-bucket transform ---------------------------------------
    def _reduce(self, flats: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ranks' flats summed in rank order, on rank 0's device:
        one all_reduce, or hier's reduce_scatter and all_gather."""
        if len(flats) == 1:
            return flats[0]
        if self.mode == "hier":
            n = flats[0].numel()
            return comm.all_gather(
                comm.reduce_scatter(flats, self.mesh, "dp"), 0)[:n]
        return comm.all_reduce(flats, self.mesh, "dp")[0]

    def _transform_flat(self, flats: Sequence[torch.Tensor],
                        generator: Optional[torch.Generator]
                        ) -> torch.Tensor:
        flat = self._reduce(flats)
        wire, orig = self.plan.wire_dtype, flat.dtype
        if wire == "int8":
            q, scale = quantize_int8(flat, generator)
            return dequantize_int8(q, scale, orig)
        if wire == "bfloat16" and orig != torch.bfloat16:
            return flat.to(torch.bfloat16).to(orig)
        return flat

    def _transform_bucket(self, bucket: Bucket,
                          rank_leaves: Sequence[Sequence[torch.Tensor]],
                          generator: Optional[torch.Generator]
                          ) -> List[torch.Tensor]:
        """The bucket's reduced gradients from each rank's leaves (one
        list per rank, in the bucket's entry order)."""
        dev = rank_leaves[0][0].device
        flats = []
        for leaves in rank_leaves:
            parts = [g.reshape(-1) for g in leaves]
            flats.append((torch.cat(parts) if len(parts) > 1
                          else parts[0]).to(dev))
        flat = self._transform_flat(flats, generator)
        out, off = [], 0
        for shape in bucket.shapes:
            n = math.prod(shape)
            out.append(flat[off:off + n].view(shape))
            off += n
        return out

    # -- path 1: backward hooks (overlap) --------------------------------
    def attach(self, rank_params: Sequence[Dict]) -> "BucketHooks":
        """The ranks' params (copies of the dicts) whose buckets pass
        through their hooks as the forward reaches them: pass the result
        as `before_layer` to `Net.loss` / `Net.loss_ranks`, with its
        `params` as the params, then call `done()`."""
        return BucketHooks(self, rank_params)

    # -- path 2: finished-grad transform ---------------------------------
    def exchange(self, grads: Dict) -> Dict:
        """The same per-bucket transform on finished gradients ({layer:
        {blob: tensor}}; a dp step's bucketed blobs hold `RankGrads`):
        iter_size accumulation, int8 stochastic rounding (from
        `generator`), or COS_GRAD_OVERLAP=0."""
        if not self.enabled:
            return grads
        generator = self.generator if self.needs_rng else None
        out = {ln: dict(bl) for ln, bl in grads.items()}
        for bucket in self.plan.buckets:
            vals = [out[ln][bn] for ln, bn in bucket.entries]
            n = len(vals[0]) if isinstance(vals[0], RankGrads) else 1
            ranks = [[v[r] if isinstance(v, RankGrads) else v for v in vals]
                     for r in range(n)]
            new = self._transform_bucket(bucket, ranks, generator)
            for (ln, bn), v in zip(bucket.entries, new):
                out[ln][bn] = v
        return out


def make_gradsync(net, **kw) -> GradSync:
    return GradSync(net, **kw)
