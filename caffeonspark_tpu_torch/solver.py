"""Solver: Caffe SolverParameter semantics as an eager PyTorch train step.

The counterpart of `caffeonspark_tpu/solver.py` (caffe::Solver /
SGDSolver through `CaffeNet<Dtype>::train`):

    train_step(params, state, inputs) -> (loss, outputs)

runs the TRAIN-phase net forward, `torch.autograd.grad` for the
gradients (the across-channel LRN layers run their backward in the
hand-written K2/K4 kernels), then Caffe's update under `torch.no_grad()`,
in place on the parameter and history tensors.  Reproduced, operation
for operation as the JAX package computes them:

  * learning-rate policies fixed/step/exp/inv/multistep/poly/sigmoid
    (sgd_solver.cpp GetLearningRate), in float32;
  * clip_gradients by global L2 norm, against clip_gradients/iter_size
    (the accumulated sum is clipped in Caffe; the mean here);
  * L2/L1 regularization (weight_decay x decay_mult), then the update
    with lr x lr_mult;
  * solver types SGD / Nesterov / AdaGrad / RMSProp / AdaDelta / Adam;
  * iter_size gradient accumulation (sum over sub-batches / iter_size);
  * seeding: weights from random_seed (default 1701), dropout from a
    generator seeded random_seed + rank (CaffeNet.cpp:614-618).

`torch.optim` is not used: Caffe's momentum history holds the update,
not the gradient.  The history of each blob has the blob's dtype, or
the state dtype (`COS_STATE_DTYPE`, read once in `__init__`: bfloat16
stores SGD / Nesterov momentum in bf16; ignored with a warning for the
second-moment solvers, as in JAX solver.py:99-119).

Precision (`dtype`, `compute_dtype`: JAX solver.py:89-119): params,
gradients and histories keep their dtypes, and the update mirrors the
JAX package's type promotion op by op.  There the learning rate (and
Adam's correction) is a *strong* f32 0-dim array, so `lr * g` on a bf16
gradient computes in f32, while the Python floats (momentum, weight
decay, delta, the decay rates) are *weak*: they take the tensor's dtype
(0.9 becomes bf16's 0.8984375) and keep bf16 arithmetic.  PyTorch never
promotes a bf16 tensor for a 0-dim f32 tensor and computes with a
Python scalar at f32, so `_lr_mul`, `_bin` and `_w` make the rules
explicit (no-ops in f32).
"""

from __future__ import annotations

import functools
import gc
import logging
import operator
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .net import Net, Params
from .ops.layers import weak_scalar
from .proto.caffe import NetParameter, NetState, Phase, SolverParameter

SOLVER_TYPES = ("SGD", "NESTEROV", "ADAGRAD", "RMSPROP", "ADADELTA", "ADAM")
# the COS_STATE_DTYPE values (numpy dtype names, as JAX parses them)
STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}
_LOG = logging.getLogger(__name__)


@dataclass
class OptState:
    """Iteration counter + per-blob histories (`{layer: {blob: t}}`):
    history is the momentum / squared-gradient accumulator, history2 the
    second moment (Adam) or the update accumulator (AdaDelta)."""
    iter: int
    history: Params
    history2: Params


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def learning_rate(sp: SolverParameter, it: int) -> torch.Tensor:
    """Caffe GetLearningRate as a float32 0-dim tensor, computed in
    float32 as the JAX package computes it."""
    policy = sp.lr_policy or "fixed"
    base = sp.base_lr
    itf = _f32(float(it))
    if policy == "fixed":
        return _f32(base)
    if policy == "step":
        step = torch.floor(itf / max(1, sp.stepsize))
        return base * torch.pow(_f32(sp.gamma), step)
    if policy == "exp":
        return base * torch.pow(_f32(sp.gamma), itf)
    if policy == "inv":
        return base * torch.pow(1.0 + sp.gamma * itf, -sp.power)
    if policy == "multistep":
        steps = list(sp.stepvalue) or [1 << 30]
        current = sum(1 for s in steps if it >= s)
        return base * torch.pow(_f32(sp.gamma), _f32(float(current)))
    if policy == "poly":
        frac = torch.clamp(itf / max(1, sp.max_iter), 0.0, 1.0)
        return base * torch.pow(1.0 - frac, sp.power)
    if policy == "sigmoid":
        return base / (1.0 + torch.exp(-sp.gamma * (itf - sp.stepsize)))
    raise ValueError(f"unknown lr_policy {policy!r}")


def _zeros_like(params: Params, dtype=None) -> Params:
    return {ln: {bn: torch.zeros_like(t, dtype=dtype or t.dtype)
                 for bn, t in bl.items()}
            for ln, bl in params.items()}


def _lr_mul(lr: float, x: torch.Tensor) -> torch.Tensor:
    """`lr * x` with the learning rate a strong f32 operand, as in JAX:
    a bf16 `x` computes in f32."""
    return x.to(torch.promote_types(x.dtype, torch.float32)) * lr


def _w(v: float, x: torch.Tensor) -> float:
    """The Python float `v` as JAX's weak type makes it beside `x`:
    rounded to x's dtype."""
    return weak_scalar(v, x.dtype)


def _bin(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`op(a, b)` of two tensors in their promoted dtype (JAX's rule for
    two strong operands: bf16 with f32 computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return op(a.to(dt), b.to(dt))


def state_dtype_from_env(solver_type: str):
    """COS_STATE_DTYPE as a torch dtype, or None (each history in its
    blob's dtype).  A dtype narrower than 4 bytes is ignored with a
    warning for the second-moment solvers: their accumulators change by
    about 1e-3 relative a step, below a bf16 ulp."""
    env = os.environ.get("COS_STATE_DTYPE", "")
    if not env:
        return None
    if env not in STATE_DTYPES:
        raise ValueError(f"COS_STATE_DTYPE={env!r}: expected one of "
                         f"{sorted(STATE_DTYPES)}")
    dt = STATE_DTYPES[env]
    if dt.itemsize < 4 and solver_type not in ("SGD", "NESTEROV"):
        _LOG.warning("COS_STATE_DTYPE=%s ignored for solver type %s "
                     "(second-moment accumulators need >=f32)", env,
                     solver_type)
        return None
    return dt


class Solver:
    """Owns the TRAIN and TEST nets of a SolverParameter, the dropout
    generator and the update rule."""

    def __init__(self, solver_param: SolverParameter,
                 net_param: NetParameter, *, rank: int = 0,
                 dtype=torch.float32, compute_dtype=None,
                 state_dtype=None, device="cuda"):
        from .serving.forward import pin_f32_precision
        self.param = solver_param
        self.device = torch.device(device)
        # f32 training computes in f32: no TF32 in cuDNN or cuBLAS; bf16
        # GEMMs accumulate in f32
        pin_f32_precision()
        self.solver_type = (solver_param.type or "SGD").upper()
        if self.solver_type not in SOLVER_TYPES:
            raise ValueError(f"unknown solver type {self.solver_type!r} "
                             f"(have {list(SOLVER_TYPES)})")
        if state_dtype is None:
            state_dtype = state_dtype_from_env(self.solver_type)
        self.state_dtype = state_dtype

        train_state = NetState(phase=Phase.TRAIN)
        if solver_param.has("train_state"):
            train_state = solver_param.train_state.clone()
            train_state.phase = Phase.TRAIN
        self.train_net = Net(net_param, train_state, dtype=dtype,
                             device=self.device,
                             compute_dtype=compute_dtype)
        test_state = NetState(phase=Phase.TEST)
        if solver_param.test_state:
            test_state = solver_param.test_state[0].clone()
            test_state.phase = Phase.TEST
        try:
            self.test_net: Optional[Net] = Net(
                net_param, test_state, dtype=dtype, device=self.device,
                compute_dtype=compute_dtype)
            if not self.test_net.compute_layers:
                self.test_net = None
        except (ValueError, NotImplementedError):
            self.test_net = None

        seed = solver_param.random_seed
        if seed < 0:
            seed = 1701    # Caffe seeds from the clock; fixed for replay
        # identical weight init on every rank; only the dropout stream
        # is decorrelated by rank
        self.init_seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed) + rank)
        # the gradient exchange (COS_GRAD_SYNC, parallel/gradsync.py):
        # inert in `default` mode; ParallelSolver binds its mesh
        from .parallel.gradsync import make_gradsync
        self.grad_sync = make_gradsync(self.train_net, seed=int(seed) + rank)
        self._lr_mults, self._decay_mults = self._collect_mults()
        # the distinct lr_mult values: one update factor each a step
        self._mult_values = sorted({m for bl in self._lr_mults.values()
                                    for m in bl.values()})
        self._many: Dict[int, object] = {}

    # ------------------------------------------------------------------
    def _collect_mults(self) -> Tuple[Dict, Dict]:
        """Per-blob lr/decay multipliers from the layers' `param {}`."""
        lr_m: Dict[str, Dict[str, float]] = {}
        dc_m: Dict[str, Dict[str, float]] = {}
        net = self.train_net
        by_name = {lp.name: lp for lp in net.compute_layers}
        for lname, specs in net.param_layout.items():
            lp = by_name[lname]
            lr_m[lname], dc_m[lname] = {}, {}
            for i, (bname, _, _) in enumerate(specs):
                ps = lp.param[i] if i < len(lp.param) else None
                lr_m[lname][bname] = (ps.lr_mult if ps is not None
                                      and ps.has("lr_mult") else 1.0)
                dc_m[lname][bname] = (ps.decay_mult if ps is not None
                                      and ps.has("decay_mult") else 1.0)
        for lname in net.stat_param_layers():
            for bname in lr_m.get(lname, {}):
                lr_m[lname][bname] = 0.0
                dc_m[lname][bname] = 0.0
        return lr_m, dc_m

    # ------------------------------------------------------------------
    def init(self) -> Tuple[Params, OptState]:
        params = self.train_net.init(self.init_seed)
        return params, self.init_state(params)

    def init_state(self, params: Params) -> OptState:
        return OptState(iter=0,
                        history=_zeros_like(params, self.state_dtype),
                        history2=_zeros_like(params, self.state_dtype))

    # ------------------------------------------------------------------
    def loss_and_grads(self, params: Params,
                       inputs: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  Params]:
        """(loss, output blobs, grads) of one solver step's batch; params
        are left as they are (`loss_grads_and_state`)."""
        return self.loss_grads_and_state(params, inputs)[:3]

    def loss_grads_and_state(self, params: Params,
                             inputs: Dict[str, torch.Tensor],
                             sub_grads=None
                             ) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor], Params,
                                        Dict[str, List[torch.Tensor]]]:
        """(loss, output blobs, grads, forward state) of one solver
        step's batch: with iter_size > 1 the batch splits into iter_size
        sub-batches whose gradients are summed and divided by iter_size
        (loss and outputs are the sub-batch means).  Each sub-batch's
        forward reads the running statistics (BatchNorm) that the one
        before it wrote, as Caffe updates them on every forward (JAX
        solver.py threads them through its scan); the last forward's are
        returned, for the step to merge into `params` after the update
        (`Net.merge_forward_state`).  `params` are not written.
        `sub_grads(params, sub, names)` -> (loss, outputs, [grad per
        name], forward state) computes one sub-batch (`_sub_grads`; the
        data-parallel step passes its own).  The gradient exchange
        (`grad_sync`) runs once, on the accumulated gradients, unless its
        backward hooks ran it inside `sub_grads` (JAX solver.py:329-336,
        403-407)."""
        net = self.train_net
        sub_grads = sub_grads or self._sub_grads
        iter_size = max(1, int(self.param.iter_size))
        gs = self.grad_sync
        names = [(ln, bn) for ln, bl in params.items() for bn in bl]
        subs = [inputs]
        if iter_size > 1:
            # time-major (":T") inputs carry the batch on axis 1
            tmajor = {n for n, _, kind in net.input_specs
                      if kind.endswith(":T")}
            subs = []
            for i in range(iter_size):
                sub = {}
                for k, v in inputs.items():
                    ax = 1 if k in tmajor else 0
                    b = v.shape[ax]
                    if b % iter_size:
                        raise ValueError(f"batch {b} not divisible by "
                                         f"iter_size {iter_size} (input "
                                         f"{k!r})")
                    m = b // iter_size
                    sub[k] = v.narrow(ax, i * m, m)
                subs.append(sub)
        gsum = None
        loss_sum = None
        osum: Dict[str, torch.Tensor] = {}
        cur = params
        fwd_state: Dict[str, List[torch.Tensor]] = {}
        for sub in subs:
            loss, outs, grads, fwd_state = sub_grads(cur, sub, names)
            if fwd_state:       # the next sub-batch reads these statistics
                cur = {ln: dict(bl) for ln, bl in cur.items()}
                for ln, values in fwd_state.items():
                    # side-channel keys (HDF5Output) hold no params
                    for (bn, _, _), v in zip(net.param_layout.get(ln, ()),
                                             values):
                        cur[ln][bn] = v.to(params[ln][bn].dtype)
            gsum = grads if gsum is None else [a + b for a, b in
                                               zip(gsum, grads)]
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for n, v in outs.items():
                osum[n] = v if n not in osum else osum[n] + v
        if iter_size > 1:
            gsum = [g / iter_size for g in gsum]
            loss_sum = loss_sum / iter_size
            osum = {n: v / iter_size for n, v in osum.items()}
        grads_p: Params = {}
        for (ln, bn), g in zip(names, gsum):
            grads_p.setdefault(ln, {})[bn] = g
        if gs.enabled and not gs.use_hooks(iter_size):
            # one exchange an optimizer step, after the accumulation
            grads_p = gs.exchange(grads_p)
        return loss_sum, osum, grads_p, fwd_state

    def _sub_grads(self, params: Params, sub: Dict[str, torch.Tensor],
                   names: List[Tuple[str, str]]):
        """One sub-batch's (loss, output blobs, gradients in `names`'
        order, forward state): the net's loss on fresh leaves of
        `params`, differentiated by autograd (through the exchange's
        backward hooks when they are on)."""
        net = self.train_net
        leaves = {ln: {bn: t.detach().requires_grad_(True)
                       for bn, t in bl.items()}
                  for ln, bl in params.items()}
        hooks = None
        if self.grad_sync.use_hooks(max(1, int(self.param.iter_size))):
            hooks = self.grad_sync.attach([leaves])
        fwd_state: Dict[str, List[torch.Tensor]] = {}
        loss, blobs = net.loss(
            hooks.params[0] if hooks is not None else leaves, sub,
            train=True, generator=self.generator, state_out=fwd_state,
            before_layer=hooks)
        if hooks is not None:
            hooks.done()
        grads = torch.autograd.grad(
            loss, [leaves[ln][bn] for ln, bn in names], allow_unused=True)
        grads = [torch.zeros_like(params[ln][bn]) if g is None else g
                 for (ln, bn), g in zip(names, grads)]
        return (loss.detach(), {n: blobs[n].detach()
                                for n in net.output_blobs},
                grads, fwd_state)

    # ------------------------------------------------------------------
    def update_scalars(self, lr: torch.Tensor, it: int) -> List[float]:
        """The factor of each distinct lr_mult's update in the step from
        iteration `it` to it + 1, as exact f32 values: lr x lr_mult (f32,
        as JAX's lr * mult), and under Adam that times the bias
        correction sqrt(1 - b2^(it+1)) / (1 - b1^(it+1)), computed in f32
        as the JAX package computes it."""
        out = []
        it1 = _f32(float(it + 1))
        for mult in self._mult_values:
            local = float(lr * mult)
            if self.solver_type == "ADAM":
                b1, b2 = self.param.momentum, self.param.momentum2
                corr = (torch.sqrt(1.0 - torch.pow(_f32(b2), it1))
                        / (1.0 - torch.pow(_f32(b1), it1)))
                local = float(_f32(local) * corr)      # f32 product
            out.append(local)
        return out

    @torch.no_grad()
    def apply_update(self, params: Params, grads: Params, state: OptState,
                     lr: torch.Tensor, scalars=None, blob_update=None,
                     blob_sq=None) -> None:
        """Caffe's ApplyUpdate, in place on params and state: clip, then
        regularize, then the solver type's rule (JAX solver.py:222-303,
        in the same operation order).  `scalars` (update_scalars' values,
        one per distinct lr_mult) may be given instead of being computed
        from `lr` and state.iter: a CUDA graph passes a device row of
        them, filled before each replay, since a Python float would be
        frozen into the graph at its capture value.  `blob_update(w, g,
        h, h2, local_lr, decay_mult)` updates one blob in place
        (`update_blob`; ZeRO-1 passes one that updates each dp rank's
        slice); `blob_sq(layer, blob, g)`, Σ g² of a blob for the clip
        (a process holding part of a blob passes the sum over its
        peers)."""
        sp = self.param
        if scalars is None:
            scalars = self.update_scalars(lr, state.iter)
        slot = {m: i for i, m in enumerate(self._mult_values)}
        blob_update = blob_update or self.update_blob

        if sp.clip_gradients > 0:
            thresh = sp.clip_gradients / max(1, int(sp.iter_size))
            # the JAX package's leaf order: sorted layer, then blob names
            sq = blob_sq or (lambda ln, bn, g: torch.sum(g * g))
            gnorm = torch.sqrt(sum(sq(ln, bn, grads[ln][bn])
                                   for ln in sorted(grads)
                                   for bn in sorted(grads[ln])))
            scale = torch.where(gnorm > thresh,
                                _w(thresh, gnorm) / gnorm, 1.0)
            grads = {ln: {bn: g * scale for bn, g in bl.items()}
                     for ln, bl in grads.items()}

        for ln, bl in params.items():
            for bn, w in bl.items():
                # f32, as JAX's lr * mult (times Adam's correction)
                blob_update(w, grads[ln][bn], state.history[ln][bn],
                            state.history2[ln][bn],
                            scalars[slot[self._lr_mults[ln][bn]]],
                            self._decay_mults[ln][bn])
        state.iter += 1

    def update_blob(self, w: torch.Tensor, g: torch.Tensor,
                    h: torch.Tensor, h2: torch.Tensor, local_lr,
                    dm: float) -> None:
        """One blob's update in place; each blob and history keeps its own
        dtype."""
        w2, h_n, h2_n = self.update_rule(w, g, h, h2, local_lr, dm)
        w.copy_(w2)
        h.copy_(h_n)
        if h2_n is not None:
            h2.copy_(h2_n)

    def update_rule(self, w: torch.Tensor, g: torch.Tensor,
                    h: torch.Tensor, h2: torch.Tensor, local_lr,
                    dm: float):
        """(new w, new history, new history2 or None) of one blob:
        regularization, then the solver type's rule."""
        sp = self.param
        momentum = sp.momentum
        wd = sp.weight_decay
        t = self.solver_type
        add, sub, div = operator.add, operator.sub, operator.truediv
        if wd != 0.0 and dm != 0.0:
            r = torch.sign(w) if sp.regularization_type == "L1" else w
            g = g + _w(wd * dm, r) * r
        if t == "SGD":
            upd = _bin(add, _lr_mul(local_lr, g), _w(momentum, h) * h)
            return _bin(sub, w, upd), upd, None
        if t == "NESTEROV":
            h_n = _bin(add, _lr_mul(local_lr, g), _w(momentum, h) * h)
            upd = _bin(sub, _w(1 + momentum, h_n) * h_n,
                       _w(momentum, h) * h)
            return _bin(sub, w, upd), h_n, None
        if t == "ADAGRAD":
            h_n = _bin(add, h, g * g)
            return (_bin(sub, w, _bin(div, _lr_mul(local_lr, g),
                                      torch.sqrt(h_n) + _w(sp.delta, h_n))),
                    h_n, None)
        if t == "RMSPROP":
            h_n = _bin(add, _w(sp.rms_decay, h) * h,
                       _w(1 - sp.rms_decay, g) * g * g)
            return (_bin(sub, w, _bin(div, _lr_mul(local_lr, g),
                                      torch.sqrt(h_n) + _w(sp.delta, h_n))),
                    h_n, None)
        if t == "ADADELTA":
            h_n = _bin(add, _w(momentum, h) * h,
                       _w(1 - momentum, g) * g * g)
            upd = _bin(operator.mul, g, torch.sqrt(_bin(
                div, h2 + _w(sp.delta, h2), h_n + _w(sp.delta, h_n))))
            h2_n = _bin(add, _w(momentum, h2) * h2,
                        _w(1 - momentum, upd) * upd * upd)
            return _bin(sub, w, _lr_mul(local_lr, upd)), h_n, h2_n
        # ADAM
        b1, b2 = momentum, sp.momentum2
        h_n = _bin(add, _w(b1, h) * h, _w(1 - b1, g) * g)
        h2_n = _bin(add, _w(b2, h2) * h2, _w(1 - b2, g) * g * g)
        return (_bin(sub, w, _bin(div, _lr_mul(local_lr, h_n),
                                  torch.sqrt(h2_n) + _w(sp.delta, h2_n))),
                h_n, h2_n)

    # ------------------------------------------------------------------
    def train_step(self, params: Params, state: OptState,
                   inputs: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One solver iteration, in place on params and state.  Returns
        the loss (a device scalar, not synchronized) and the output
        blobs with `lr` added."""
        return take_step(self, params, state, inputs)

    def train_step_many(self, k: int):
        """`fn(params, state, stacked) -> (losses, outputs)`: k solver
        steps over a stacked (k, batch...) block (axis 0 the chunk axis;
        time-major inputs become (k, T, B, ...)), in place on params and
        state, like k `train_step` calls; `losses` and every output come
        back stacked (k, ...), `outputs["lr"][i]` being step i's learning
        rate (JAX solver.py:433-485, `build_train_step_many`).

        On a card the k steps are one CUDA graph (`GraphedSteps`):
        forward, gradients, clipping, iter_size accumulation and the
        update, replayed once a block.  On the CPU they are k eager
        `train_step` calls, the plain version.  Cached per k."""
        return steps_many(self, k)

    def eval_step_fn(self):
        """Validation forward, made by the serving path's
        `make_forward_fn` (serving/forward.py), as in the JAX package."""
        if self.test_net is None:
            raise ValueError("no TEST-phase net in this config")
        from .serving.forward import make_forward_fn
        return make_forward_fn(self.test_net,
                               tuple(self.test_net.output_blobs))


def take_step(stepper, params: Params, state: OptState,
              inputs: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One solver iteration of `stepper` (a Solver, or a ParallelSolver:
    anything with `param`, `loss_grads_and_state`, `apply_update` and
    `train_net`), in place on params and state."""
    lr = learning_rate(stepper.param, state.iter)
    loss, outputs, grads, fwd_state = stepper.loss_grads_and_state(
        params, inputs)
    stepper.apply_update(params, grads, state, lr)
    # the statistics' lr_mult and decay_mult are 0: the update left them
    # as they were, and the forward's new ones land now
    stepper.train_net.merge_forward_state(params, fwd_state)
    outputs["lr"] = lr
    return loss, outputs


def steps_many(stepper, k: int):
    """`stepper.train_step_many(k)`, cached in `stepper._many`: a
    `GraphedSteps` on a card, k eager steps on the CPU."""
    if k < 1:
        raise ValueError(f"steps-per-loop k must be >= 1, got {k}")
    fn = stepper._many.get(k)
    if fn is None:
        fn = stepper._many[k] = (GraphedSteps(stepper, k)
                                 if stepper.device.type == "cuda"
                                 else functools.partial(eager_many,
                                                        stepper, k))
    return fn


def eager_many(stepper, k: int, params: Params, state: OptState,
               stacked: Dict[str, torch.Tensor]):
    """k eager `train_step` calls over a stacked block."""
    losses, outs = [], []
    for i in range(k):
        loss, out = stepper.train_step(params, state,
                                       {n: v[i] for n, v in stacked.items()})
        losses.append(loss)
        outs.append(out)
    return torch.stack(losses), {n: torch.stack([o[n] for o in outs])
                                 for n in outs[0]}


class GraphedSteps:
    """k solver steps as one CUDA graph: `Solver.train_step_many` on a
    card.

    The first block of each input signature (shapes, dtypes and the
    attention's mesh) runs as k eager steps on the graph's stream: the
    warm-up that builds the kernels, picks cuDNN's algorithms and
    allocates the cuBLAS workspace before any capture, and a real chunk
    of the run.  The next block captures the k steps (a capture runs
    nothing, so params, state and the dropout generator do not move)
    and replays the graph; each later block is copied into the graph's
    static (k, ...) inputs and replayed.

    What a graph would freeze at its capture values is read from device
    buffers filled on the host before each replay: each step's update
    factors (`Solver.update_scalars`, the eager step's exact f32 values,
    so `x * factor` on the card gives the eager product).  The dropout
    generator, and the gradient exchange's under int8 stochastic
    rounding, are registered with the graph, which then advances their
    offsets by k steps' draws a replay, so the replays draw what k eager
    steps draw.  The kernels' launches recorded at capture count once a
    replay (`kernels.count_replays`).  The capture restricts this thread
    alone (`capture_error_mode="thread_local"`): the feeder, the pack
    pool and the stager keep running.  A failed capture raises: nothing
    runs eagerly in its place.  A graph is bound to the params and state
    tensors it was captured on; a block given other tensors is captured
    anew."""

    def __init__(self, solver: "Solver", k: int):
        self.solver = solver
        self.k = k
        self.stream = torch.cuda.Stream(solver.device)
        self._warm: set = set()
        self._graphs: Dict[tuple, dict] = {}
        self.captures = 0
        self.replays = 0

    @staticmethod
    def _key(stacked: Dict[str, torch.Tensor]) -> tuple:
        from .ops.layers import _mesh_stack
        return (tuple((n, tuple(v.shape), v.dtype)
                      for n, v in sorted(stacked.items())),
                tuple(id(m) for m in _mesh_stack()))

    @staticmethod
    def _ptrs(params: Params, state: OptState) -> tuple:
        # a ZeRO-1 state blob is a list of the dp ranks' slices
        return tuple(x.data_ptr() for tree in (params, state.history,
                                               state.history2)
                     for bl in tree.values() for t in bl.values()
                     for x in (t if isinstance(t, list) else (t,)))

    def __call__(self, params: Params, state: OptState,
                 stacked: Dict[str, torch.Tensor]):
        key = self._key(stacked)
        if key not in self._warm:
            cur = torch.cuda.current_stream(self.solver.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                losses, out = eager_many(self.solver, self.k, params, state,
                                         stacked)
            cur.wait_stream(self.stream)
            for t in (losses, *out.values()):
                if t.is_cuda:
                    t.record_stream(cur)
            self._warm.add(key)
            return losses, out
        ptrs = self._ptrs(params, state)
        g = self._graphs.get(key)
        if g is None or g["ptrs"] != ptrs:
            g = self._graphs[key] = self._capture(params, state, stacked,
                                                  ptrs)
        return self._replay(g, state, stacked)

    def _capture(self, params: Params, state: OptState,
                 stacked: Dict[str, torch.Tensor], ptrs: tuple) -> dict:
        from .ops import kernels as K
        s = self.solver
        static_in = {n: torch.empty_like(v) for n, v in stacked.items()}
        scalars = torch.zeros((self.k, len(s._mult_values)),
                              dtype=torch.float32, device=s.device)
        graph = torch.cuda.CUDAGraph()
        if any(lp.type == "Dropout" for lp in s.train_net.compute_layers):
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "COS_STEPS_PER_LOOP > 1 with Dropout needs "
                    "torch.cuda.CUDAGraph.register_generator_state (the "
                    f"dropout generator in the graph); torch "
                    f"{torch.__version__} has none")
            graph.register_generator_state(s.generator)
        if s.grad_sync.needs_rng:
            # int8 stochastic rounding draws k steps' worth a replay
            graph.register_generator_state(s.grad_sync.generator)
        it0 = state.iter
        # a CUDA graph that dies in a reference cycle is destroyed when
        # the cyclic collector runs, and a graph destroyed during this
        # capture invalidates it: collect now, and not during the capture
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the capture forbids unsafe CUDA calls on
            # this thread only; the ingest threads go on pinning host
            # memory and staging batches on their own streams meanwhile
            with K.captured_launches() as launches, \
                    torch.cuda.graph(graph, stream=self.stream,
                                     capture_error_mode="thread_local"):
                losses, outs = [], []
                for i in range(self.k):
                    loss, out, grads, fwd_state = s.loss_grads_and_state(
                        params, {n: v[i] for n, v in static_in.items()})
                    s.apply_update(params, grads, state, None,
                                   scalars=scalars[i])
                    s.train_net.merge_forward_state(params, fwd_state)
                    losses.append(loss)
                    outs.append(out)
                loss_out = torch.stack(losses)
                outputs = {n: torch.stack([o[n] for o in outs])
                           for n in outs[0]}
        finally:
            if gc_on:
                gc.enable()
            state.iter = it0          # the capture ran no step
        self.captures += 1
        return dict(graph=graph, inputs=static_in, scalars=scalars,
                    loss=loss_out, outputs=outputs, launches=launches,
                    ptrs=ptrs)

    def _replay(self, g: dict, state: OptState,
                stacked: Dict[str, torch.Tensor]):
        from .ops import kernels as K
        s = self.solver
        for n, v in stacked.items():
            g["inputs"][n].copy_(v)
        lrs = [learning_rate(s.param, state.iter + i) for i in range(self.k)]
        host = torch.tensor([s.update_scalars(lr, state.iter + i)
                             for i, lr in enumerate(lrs)],
                            dtype=torch.float32).pin_memory()
        g["scalars"].copy_(host, non_blocking=True)
        g["graph"].replay()
        K.count_replays(g["launches"])
        self.replays += 1
        state.iter += self.k
        outputs = {n: v.clone() for n, v in g["outputs"].items()}
        outputs["lr"] = torch.stack(lrs)
        return g["loss"].clone(), outputs
