"""Sequence parallelism: ring attention over the `sp` mesh axis — the
counterpart of `caffeonspark_tpu/parallel/sp.py`.

Sequences are sharded along time across the ranks of the `sp` axis, and
attention runs as a ring: each step every rank folds a partial
(online-softmax) attention against the K/V block it holds into its
carry, then hands that block to its ring neighbour (`ppermute`).

Where the JAX package writes a per-device body and lets shard_map run it
on every device, the port runs the same body for every rank in lockstep
on the host: `ring_attention` cuts the time axis into one block per rank
(`sp_shard_time`) and `_ring_attention_local` loops over the ranks at
each ring step.  A rank's tensors live on its mesh device; `ppermute`,
the one transport function, hands rank i's tensor to rank i + 1 with
`.to(device)`, a no-op when both ranks sit on one card.  When the sp
axis spans processes, a process holds sp ranks off .. off + k - 1 of
the global ring (`Mesh.offsets`): it runs the body for those, each
rank's causal positions and diagonal tests taken from its global index,
and `ppermute` hands its last rank's block to the next process on its
sp line (`comm.shift_line`, gloo).  Every process of the line holds the
whole replicated q, k and v: `ring_attention` takes its part of time
(`comm.take_line`) and joins the outputs over the line
(`comm.gather_line`), as `sp_shard_time` and the final `torch.cat`
join them in one process.

`flash=False` is the einsum ring, differentiated by autograd.
`flash=True` is the fused ring: `RingFlash` (equal extents) and
`RingFlashCross` (t_q != t_k), whose forwards fold each hop with K9
(`ops.kernels.flash_block_update`) and whose backwards are a second
ring pass, over K7/K8 (`flash_bwd_block`) for RingFlash and over einsum
pairs for RingFlashCross, as in the JAX package.  On a CUDA tensor the
kernels launch; on a CPU tensor their plain versions run.  The JAX
`flash="interpret"` has no counterpart, and neither has
`shard_map_nocheck`: the per-rank loop is the shard_map.

`attention` is the single-device reference (the parity oracle in
tests).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..ops import kernels as K
from .comm import gather_line, shift_line, take_line
from .mesh import Mesh

Tensors = List[torch.Tensor]


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


def ppermute(tensors: Sequence[torch.Tensor], mesh: Mesh,
             axis_name: str = "sp") -> Tensors:
    """The ring's one transport: rank i's tensor goes to rank (i + 1) % n
    of `axis_name`, on that rank's device (`lax.ppermute` with the
    permutation [(i, (i + 1) % n)]).  Differentiable; a no-op copy
    between ranks of one device.  `tensors` are this process's ranks';
    when the axis spans processes, its last rank's goes to the next
    process on the line and its first rank's comes from the previous
    one (`comm.shift_line`)."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    if not mesh.axis_spans(axis_name):
        return [tensors[(i - 1) % n].to(devs[i]) for i in range(n)]
    first = shift_line([tensors[-1]], mesh, axis_name)[0]
    return [first.to(devs[0])] + [tensors[i - 1].to(devs[i])
                                   for i in range(1, n)]


def ring_extent(mesh: Mesh, axis_name: str) -> "tuple[int, int]":
    """(ranks of the whole ring, this process's first rank's global
    index) along `axis_name`."""
    return mesh.totals[axis_name], mesh.offsets[axis_name]


def sp_shard_time(x: torch.Tensor, mesh: Mesh, *, time_axis: int = 2,
                  axis_name: str = "sp") -> Tensors:
    """Place an activation with its time axis sharded over `axis_name`:
    the list of per-rank blocks (contiguous), each on its rank's
    device."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    t = x.shape[time_axis]
    if t % n:
        raise ValueError(f"time extent {t} not divisible by the "
                         f"{axis_name} axis ({n} ranks)")
    return [blk.contiguous().to(dev)
            for blk, dev in zip(torch.chunk(x, n, dim=time_axis), devs)]


# ---------------------------------------------------------------------------
# the einsum ring
# ---------------------------------------------------------------------------

def _einsum_ring(qs: Tensors, ks: Tensors, vs: Tensors, mesh: Mesh,
                 axis_name: str, causal: bool) -> Tensors:
    """The einsum accumulate ring (JAX sp.py:98-133), differentiated by
    autograd: a carry of q's dtype starting at (-inf, 0, 0), a -inf
    causal mask on global positions, the isfinite guard.  `qs` are this
    process's ranks', global sp indices off ..; the ring has n."""
    n, off = ring_extent(mesh, axis_name)
    t_q, t_k = qs[0].shape[2], ks[0].shape[2]
    scale = 1.0 / math.sqrt(qs[0].shape[-1])

    def accumulate(idx, m, l, o, k_blk, v_blk, src):
        q = qs[idx]
        s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
        if causal:
            qpos = (off + idx) * t_q + torch.arange(t_q, device=q.device)
            kpos = src * t_k + torch.arange(t_k, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # guard fully-masked rows: exp against a finite max
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l_new = l * corr + torch.sum(p, dim=-1)
        o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   v_blk)
        return m_new, l_new, o_new

    carry = []
    for idx, q in enumerate(qs):
        m0 = torch.full(q.shape[:-1], -math.inf, dtype=q.dtype,
                        device=q.device)
        l0 = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
        o0 = torch.zeros_like(q)
        carry.append(accumulate(idx, m0, l0, o0, ks[idx], vs[idx],
                                off + idx))
    k_blk, v_blk = list(ks), list(vs)
    for step in range(1, n):
        k_blk = ppermute(k_blk, mesh, axis_name)
        v_blk = ppermute(v_blk, mesh, axis_name)
        carry = [accumulate(idx, *carry[idx], k_blk[idx], v_blk[idx],
                            (off + idx - step) % n)
                 for idx in range(len(qs))]
    return [(o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
            for q, (_, l, o) in zip(qs, carry)]


# ---------------------------------------------------------------------------
# the fused ring: K9 forward, K7/K8 (or einsum) backward
# ---------------------------------------------------------------------------

def _flash_ring_forward(qs: Tensors, ks: Tensors, vs: Tensors, mesh: Mesh,
                        axis_name: str, causal: bool
                        ) -> Tuple[Tensors, Tensors]:
    """The fused ring forward (the one copy of the ring loop): K/V blocks
    rotate, each hop folds into rank idx's f32 (m, l, acc) carry, started
    at (-inf, 0, 0), through K9 with the global offsets idx·t_q and
    src·t_k.  Causal runs skip the hops whose keys all lie after the
    rank's last query, (idx + 1)·t_q > src·t_k failing: n(n+1)/2 K9
    launches in all for equal extents.  idx is the global sp index (this
    process's ranks are off ..).  Returns the per-rank (out, lse),
    lse = m + log(l) (B, H, t_q) f32, the backward's residual."""
    n, off = ring_extent(mesh, axis_name)
    b, h, t_q, d = qs[0].shape
    t_k = ks[0].shape[2]
    bh = b * h
    qf = [q.reshape(bh, t_q, d) for q in qs]
    carry = [(torch.full((bh, t_q), -math.inf, dtype=torch.float32,
                         device=q.device),
              torch.zeros((bh, t_q), dtype=torch.float32, device=q.device),
              torch.zeros((bh, t_q, d), dtype=torch.float32,
                          device=q.device)) for q in qs]
    k_blk = [k.reshape(bh, t_k, d) for k in ks]
    v_blk = [v.reshape(bh, t_k, d) for v in vs]
    for step in range(n):
        if step:
            k_blk = ppermute(k_blk, mesh, axis_name)
            v_blk = ppermute(v_blk, mesh, axis_name)
        for i in range(len(qs)):
            idx = off + i
            src = (idx - step) % n
            # contributes iff the last q row can see the first k row
            if causal and not (idx + 1) * t_q > src * t_k:
                continue
            carry[i] = K.flash_block_update(
                qf[i], k_blk[i], v_blk[i], *carry[i], idx * t_q,
                src * t_k, causal)
    outs, lses = [], []
    for q, (m, l, acc) in zip(qs, carry):
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype)
                    .reshape(b, h, t_q, d))
        lses.append((m + torch.log(l_safe)).reshape(b, h, t_q))
    return outs, lses


class RingFlash(torch.autograd.Function):
    """Differentiable fused ring attention, equal shard extents: the
    custom VJP of the JAX package's `_make_ring_flash`.

    Forward: `_flash_ring_forward`, keeping per rank q, k, v, out and
    lse.  Backward, a second ring pass: each rank keeps its K/V resident
    while (q, dO, lse, delta, dq) rotate; at each hop the resident block
    contributes through K7/K8 (`flash_bwd_block`, partials in f32) —
    causal kernels for the diagonal pair, unmasked ones for a visitor
    q-group from a later shard (j > idx), none for an earlier one.  dk
    and dv accumulate at home in f32; dq co-rotates with its q-group and
    takes one last hop home.  The mesh and the residuals live in ctx,
    so the backward (which autograd may run on another thread) reads no
    global.  Called as apply(mesh, axis_name, causal, *qs, *ks, *vs);
    returns the n per-rank outputs."""

    @staticmethod
    def forward(ctx, mesh, axis_name, causal, *qkv):
        n = len(qkv) // 3       # this process's ranks
        qs, ks, vs = list(qkv[:n]), list(qkv[n:2 * n]), list(qkv[2 * n:])
        outs, lses = _flash_ring_forward(qs, ks, vs, mesh, axis_name,
                                         causal)
        ctx.mesh, ctx.axis_name, ctx.causal, ctx.n = (mesh, axis_name,
                                                      causal, n)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        n, mesh, axis_name = ctx.n, ctx.mesh, ctx.axis_name
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n]
                                  for i in range(5))
        ring, off = ring_extent(mesh, axis_name)
        b, h, t, d = qs[0].shape
        bh = b * h
        qf = [q.reshape(bh, t, d) for q in qs]
        kf = [k.reshape(bh, t, d) for k in ks]
        vf = [v.reshape(bh, t, d) for v in vs]
        dof = [do.reshape(bh, t, d).to(q.dtype).contiguous()
               for do, q in zip(dos, qs)]
        lsef = [lse.reshape(bh, t) for lse in lses]
        delta = [torch.sum(do.float() * out.reshape(bh, t, d).float(),
                           dim=-1) for do, out in zip(dof, outs)]

        def block(idx, vq, vdo, vlse, vdelta, diag):
            # f32 partials: a bf16 partial must not round before the sum
            return K.flash_bwd_block(vq, kf[idx], vf[idx], vdo, vlse,
                                     vdelta, causal=diag,
                                     out_dtype=torch.float32)

        # s = 0: the diagonal pair (visitor == home shard)
        dqv, dk, dv = map(list, zip(*(
            block(i, qf[i], dof[i], lsef[i], delta[i], ctx.causal)
            for i in range(n))))
        vq, vdo, vlse, vdelta = qf, dof, lsef, delta
        for s in range(1, ring):
            vq, vdo, vlse, vdelta, dqv = (ppermute(x, mesh, axis_name)
                                          for x in (vq, vdo, vlse, vdelta,
                                                    dqv))
            for idx in range(n):
                # the visiting q-group's home, by global index
                j = (off + idx - s) % ring
                # visitor attends this shard's K/V iff it sits later in
                # the global sequence (the diagonal was done at s = 0)
                if ctx.causal and not j > off + idx:
                    continue
                dqh, dkh, dvh = block(idx, vq[idx], vdo[idx], vlse[idx],
                                      vdelta[idx], False)
                dqv[idx] = dqv[idx] + dqh
                dk[idx] = dk[idx] + dkh
                dv[idx] = dv[idx] + dvh
        # dq co-rotated n - 1 times with its q-group: one more hop home
        dqv = ppermute(dqv, mesh, axis_name)
        shape = (b, h, t, d)
        grads = ([x.reshape(shape).to(q.dtype) for x, q in zip(dqv, qs)]
                 + [x.reshape(shape).to(k.dtype) for x, k in zip(dk, ks)]
                 + [x.reshape(shape).to(v.dtype) for x, v in zip(dv, vs)])
        return (None, None, None, *grads)


class RingFlashCross(RingFlash):
    """Differentiable fused ring attention for unequal shard extents
    (t_q != t_k): the custom VJP of the JAX package's
    `_make_ring_flash_cross`.

    Forward: RingFlash's K9 ring.  Backward: an einsum ring pass, not
    K7/K8 (they take square blocks): each hop rematerializes one (t_q,
    t_k) score block in f32 from the saved lse, masked with global
    positions (visitor q-group j's offset j·t_q against the home K
    offset idx·t_k), and skips a visitor whose last row sees none of
    the home keys.  The same choreography as RingFlash's backward.
    Called as apply(mesh, axis_name, causal, *qs, *ks, *vs)."""

    @staticmethod
    def backward(ctx, *dos):
        n, mesh, axis_name, causal = ctx.n, ctx.mesh, ctx.axis_name, \
            ctx.causal
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n]
                                  for i in range(5))
        ring, off = ring_extent(mesh, axis_name)
        t_q, t_k, d = qs[0].shape[2], ks[0].shape[2], qs[0].shape[3]
        scale = 1.0 / math.sqrt(d)
        kf = [k.float() for k in ks]
        vf = [v.float() for v in vs]
        do32 = [do.float() for do in dos]
        delta = [torch.sum(do * out.float(), dim=-1)
                 for do, out in zip(do32, outs)]

        def pair(idx, vq, vdo, vlse, vdelta, j):
            """Visitor q-group (home shard j) against the resident K/V of
            this process's rank idx (global off + idx): p from the saved
            lse, then ds -> (dq, dk, dv)."""
            home = off + idx
            if causal and not (j + 1) * t_q > home * t_k:
                return None
            q32 = vq.float()
            s = torch.einsum("bhqd,bhkd->bhqk", q32, kf[idx]) * scale
            p = torch.exp(s - vlse[..., None])
            if causal:
                qpos = j * t_q + torch.arange(t_q, device=vq.device)
                kpos = home * t_k + torch.arange(t_k, device=vq.device)
                p = torch.where(qpos[:, None] >= kpos[None, :], p, 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", vdo, vf[idx])
            ds = p * (dp - vdelta[..., None])
            return (torch.einsum("bhqk,bhkd->bhqd", ds, kf[idx]) * scale,
                    torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale,
                    torch.einsum("bhqk,bhqd->bhkd", p, vdo))

        def zeros(x, t):
            return torch.zeros(x.shape[:2] + (t, d), dtype=torch.float32,
                               device=x.device)

        dqv, dk, dv = [], [], []
        for idx in range(n):
            got = pair(idx, qs[idx], do32[idx], lses[idx], delta[idx],
                       off + idx)
            if got is None:
                got = (zeros(qs[idx], t_q), zeros(ks[idx], t_k),
                       zeros(ks[idx], t_k))
            dqv.append(got[0])
            dk.append(got[1])
            dv.append(got[2])
        vq, vdo, vlse, vdelta = list(qs), do32, list(lses), delta
        for s in range(1, ring):
            vq, vdo, vlse, vdelta, dqv = (ppermute(x, mesh, axis_name)
                                          for x in (vq, vdo, vlse, vdelta,
                                                    dqv))
            for idx in range(n):
                got = pair(idx, vq[idx], vdo[idx], vlse[idx], vdelta[idx],
                           (off + idx - s) % ring)
                if got is not None:
                    dqv[idx] = dqv[idx] + got[0]
                    dk[idx] = dk[idx] + got[1]
                    dv[idx] = dv[idx] + got[2]
        dqv = ppermute(dqv, mesh, axis_name)
        grads = ([x.to(q.dtype) for x, q in zip(dqv, qs)]
                 + [x.to(k.dtype) for x, k in zip(dk, ks)]
                 + [x.to(v.dtype) for x, v in zip(dv, vs)])
        return (None, None, None, *grads)


def _ring_attention_local(qs: Tensors, ks: Tensors, vs: Tensors, *,
                          mesh: Mesh, axis_name: str, causal: bool,
                          flash: bool = False) -> Tensors:
    """The per-shard body, run for every rank of `axis_name` in lockstep:
    qs, ks, vs are the ranks' LOCAL time blocks (B, H, T_local, D), one
    per rank, each on its rank's device; returns the ranks' outputs.
    `flash` picks the fused ring (K9 forward; RingFlash for equal
    extents, RingFlashCross otherwise) over the einsum ring."""
    if flash:
        fn = RingFlash if qs[0].shape[2] == ks[0].shape[2] else RingFlashCross
        return list(fn.apply(mesh, axis_name, bool(causal), *qs, *ks, *vs))
    return _einsum_ring(qs, ks, vs, mesh, axis_name, causal)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, *, causal: bool = False,
                   axis_name: str = "sp", flash: bool = False
                   ) -> torch.Tensor:
    """Sequence-parallel attention: (B, H, T, D) with T sharded over
    `axis_name`; returns the output, reassembled on q's device.

    flash: False (default, the einsum accumulate, differentiated by
    autograd) | True (the fused ring, differentiable: K9 hops forward,
    a second ring pass backward; see RingFlash / RingFlashCross).
    When the axis spans processes, q, k and v are every peer's whole
    replicated tensors: this process runs its ranks' time blocks and
    the output is joined over its line of processes."""
    n = mesh.totals[axis_name]
    for x in (q, k, v):
        if x.shape[2] % n:
            raise ValueError(f"time extent {x.shape[2]} not divisible by "
                             f"the {axis_name} axis ({n} ranks)")
    q, k, v = (take_line(x, 2, mesh, axis_name) for x in (q, k, v))
    outs = _ring_attention_local(
        sp_shard_time(q, mesh, axis_name=axis_name),
        sp_shard_time(k, mesh, axis_name=axis_name),
        sp_shard_time(v, mesh, axis_name=axis_name), mesh=mesh,
        axis_name=axis_name, causal=causal, flash=flash)
    return gather_line(torch.cat([o.to(q.device) for o in outs], dim=2),
                       2, mesh, axis_name)
