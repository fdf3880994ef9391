"""The port's hand-written CUDA kernels, their wrappers and their plain
PyTorch versions — the counterpart of caffeonspark_tpu/ops/pallas_kernels.py.

Five kernels serve the image nets' forward and backward, four the
transformer's attention:

  * `lrn_across_channels`            K1, csrc/lrn.cu `cos_lrn_fwd`
    (Caffe across-channel LRN, optional fused ReLU);
  * `lrn_across_channels_bwd`        K2, csrc/lrn.cu `cos_lrn_bwd`
    (its dx, recomputing the normalizer from x);
  * `bias_relu_lrn_across_channels`  K3, csrc/lrn.cu `cos_bias_relu_lrn_fwd`
    (the conv-stem epilogue lrn(relu(x + bias)); `lrn_plan` is K1's, K2's
    and K3's launch plan);
  * `bias_relu_lrn_across_channels_bwd`  K4, csrc/lrn.cu
    `cos_bias_relu_lrn_bwd` (its dx and d_bias, the channel sum of dx,
    in one pass; `k4_plan` is its launch plan);
  * `int8_matmul`                    K5, csrc/int8_matmul.cu
    (int8 x int8 -> int32, under `int8_inner_product`);
  * `flash_attention_fwd`            K6, csrc/flash_attn.cu
    `cos_flash_fwd` (blockwise attention: O and the row log-sum-exp);
  * `flash_attention_bwd_dq`         K7, `cos_flash_bwd_dq`;
  * `flash_attention_bwd_dkv`        K8, `cos_flash_bwd_dkv` (K7 and K8
    together are `flash_bwd_block`);
  * `flash_block_update`             K9, `cos_flash_block_update` (one
    ring-attention hop: a K/V block folded into the online-softmax
    carry, masked with global offsets; K6's forward body in its carry
    mode).

K6-K9 take any head width D: up to FLASH_MAX_D (256) their padded-width
kernels (`_check_flash`), above it their wide kernels, the `_wide` entry
points (`_check_flash_wide`: the same operand rules, no D limit).

`LRNAcrossChannels` and `BiasReluLRNAcrossChannels` are the autograd
Functions that pair K1 with K2 and K3 with K4; the net's LRN layer
calls them in every phase.  Each saves only its raw inputs (x, and the
bias), as the JAX package's custom VJPs do.  `FlashAttention` pairs K6
with K7/K8 for the MultiHeadAttention layer and saves q, k, v, O and
lse, the JAX custom VJP's residuals.  K9 has no Function of its own:
`parallel.sp.RingFlash` pairs it with K7/K8 over a ring of ranks.

Routing is by the tensor's device and nothing else: a CPU tensor (or a
shape-only "meta" tensor during Net construction) takes the plain
version; a CUDA tensor launches the kernel or raises.  There is no
fallback from a kernel to its plain version.

Each wrapper adds one to `launch_counts[name]` per kernel launch (and
to `launch_counts_by_dtype[(name, dtype)]`), so a run can show that its
main path went through the kernels, and in which mode.  Under CUDA graph
capture a wrapper runs in Python once while nothing launches; the
capture's counts are taken out of the totals (`captured_launches`) and
added back once per replay (`count_replays`).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

launch_counts: Dict[str, int] = {"lrn_across_channels": 0,
                                 "lrn_across_channels_bwd": 0,
                                 "bias_relu_lrn_across_channels": 0,
                                 "bias_relu_lrn_across_channels_bwd": 0,
                                 "int8_matmul": 0,
                                 "flash_attention_fwd": 0,
                                 "flash_attention_bwd_dq": 0,
                                 "flash_attention_bwd_dkv": 0,
                                 "flash_block_update": 0}
# the same launches by (kernel, dtype of its main operand), e.g.
# ("flash_attention_fwd", "bfloat16"): which modes a path ran
launch_counts_by_dtype: Dict[Tuple[str, str], int] = {}
_count_lock = threading.Lock()

_LRN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_DEVICES = ("cpu", "meta")


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0
        launch_counts_by_dtype.clear()


def _count(name: str, dtype: torch.dtype) -> None:
    key = (name, str(dtype).replace("torch.", ""))
    with _count_lock:
        launch_counts[name] += 1
        launch_counts_by_dtype[key] = launch_counts_by_dtype.get(key, 0) + 1


@contextlib.contextmanager
def captured_launches() -> Iterator[dict]:
    """Around a CUDA graph capture: yields a dict that holds, on exit,
    the launches the capture recorded (`counts`, `by_dtype`), and puts
    the totals back as they were before it (a capture runs nothing)."""
    with _count_lock:
        before = dict(launch_counts)
        before_dt = dict(launch_counts_by_dtype)
    rec: dict = {}
    try:
        yield rec
    finally:
        with _count_lock:
            rec["counts"] = {k: v - before[k]
                             for k, v in launch_counts.items()
                             if v != before[k]}
            rec["by_dtype"] = {k: v - before_dt.get(k, 0)
                               for k, v in launch_counts_by_dtype.items()
                               if v != before_dt.get(k, 0)}
            launch_counts.update(before)
            launch_counts_by_dtype.clear()
            launch_counts_by_dtype.update(before_dt)


def count_replays(rec: dict, times: int = 1) -> None:
    """Add a captured graph's launches (`captured_launches`) `times`
    times: one per replay."""
    with _count_lock:
        for k, v in rec.get("counts", {}).items():
            launch_counts[k] += v * times
        for k, v in rec.get("by_dtype", {}).items():
            launch_counts_by_dtype[k] = (launch_counts_by_dtype.get(k, 0)
                                         + v * times)


def _check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed "
                           f"(cudaError {status})")


def _route(x: torch.Tensor, name: str) -> bool:
    """True -> launch the kernel (CUDA); False -> plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type in _PLAIN_DEVICES:
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# K1 / K3: across-channel LRN forward (optionally relu, bias+relu)
# ---------------------------------------------------------------------------

def _window_sum(v: torch.Tensor, pad: int) -> torch.Tensor:
    """Sum over the symmetric channel window, in the TPU kernel's order:
    centre, then (-1, +1), (-2, +2), ... (zero-padded channels)."""
    if pad == 0:
        return v
    c = v.shape[1]
    vp = F.pad(v, (0, 0, 0, 0, pad, pad))
    acc = v
    for off in range(1, pad + 1):
        acc = acc + vp[:, pad - off:pad - off + c] \
            + vp[:, pad + off:pad + off + c]
    return acc


def lrn_plain(x: torch.Tensor, local_size: int, alpha: float, beta: float,
              k: float, fuse_relu: bool = False,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1/K3: y = x'·(k + α/n·Σ x'²)^−β with
    x' = x, relu(x), or relu(x + bias); f32 math for any I/O dtype."""
    xf = x.float()
    if bias is not None:
        xf = xf + bias.float().reshape(1, -1, 1, 1)
    if fuse_relu or bias is not None:
        xf = torch.clamp_min(xf, 0.0)
    scale = k + (alpha / local_size) * _window_sum(xf * xf,
                                                   local_size // 2)
    return (xf * torch.exp(-beta * torch.log(scale))).to(x.dtype)


def _check_lrn_input(name: str, x: torch.Tensor, local_size: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _LRN_DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not in "
                         f"{list(_LRN_DTYPES)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if local_size < 1:
        raise ValueError(f"{name}: local_size {local_size} < 1")


def lrn_across_channels(x: torch.Tensor, local_size: int = 5,
                        alpha: float = 1e-4, beta: float = 0.75,
                        k: float = 1.0,
                        fuse_relu: bool = False) -> torch.Tensor:
    """(N, C, H, W) -> Caffe LRN (alpha/local_size); with fuse_relu,
    lrn(relu(x)) in one pass.  Forward only: `LRNAcrossChannels` adds
    the backward.  On the card x may be a view that starts at any
    element."""
    name = "lrn_across_channels"
    if not _route(x, name):
        return lrn_plain(x, local_size, alpha, beta, k, fuse_relu)
    _check_lrn_input(name, x, local_size)
    n, c, h, w = x.shape
    relu = int(bool(fuse_relu))
    plan = _lrn_launch_plan(x, local_size, 1, relu)
    y = torch.empty_like(x)
    lib = cuda_build.library("lrn")
    with torch.cuda.device(x.device):
        status = lib.cos_lrn_fwd(
            x.data_ptr(), y.data_ptr(), n, c, h * w, int(local_size),
            alpha / local_size, -beta, k, relu, plan.tile, plan.run,
            _LRN_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_status(name, status)
    _count(name, x.dtype)
    return y


def bias_relu_lrn_across_channels(x: torch.Tensor, bias: torch.Tensor,
                                  local_size: int = 5, alpha: float = 1e-4,
                                  beta: float = 0.75,
                                  k: float = 1.0) -> torch.Tensor:
    """(N, C, H, W) raw conv output + (C,) bias -> lrn(relu(x + bias)),
    one fused pass (the bias is read as an f32 column).  On the card x
    may be a view that starts at any element."""
    name = "bias_relu_lrn_across_channels"
    if not _route(x, name):
        return lrn_plain(x, local_size, alpha, beta, k, bias=bias)
    _check_lrn_input(name, x, local_size)
    n, c, h, w = x.shape
    if bias.shape != (c,) or bias.device != x.device:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} on "
                         f"{bias.device} for {c} channels on {x.device}")
    plan = _lrn_launch_plan(x, local_size, 3, 1)
    b = bias.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    lib = cuda_build.library("lrn")
    with torch.cuda.device(x.device):
        status = lib.cos_bias_relu_lrn_fwd(
            x.data_ptr(), b.data_ptr(), y.data_ptr(), n, c, h * w,
            int(local_size), alpha / local_size, -beta, k, plan.tile,
            plan.run, _LRN_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_status(name, status)
    _count(name, x.dtype)
    return y


# ---------------------------------------------------------------------------
# K2 / K4: across-channel LRN backward, and the autograd Functions
# ---------------------------------------------------------------------------

def lrn_bwd_plain(x: torch.Tensor, dy: torch.Tensor, local_size: int,
                  alpha: float, beta: float, k: float,
                  fuse_relu: bool = False,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K2/K4, formula for formula as the TPU
    kernels `_lrn_bwd_kernel` / `_lrn_bwd_kernel_bias`: with x' = x,
    relu(x) or relu(x + bias) and s = k + α/n·Σ x'² recomputed,
    dx = dy·s^−β − (2αβ/n)·x'·Σ_W(dy·x'·s^−β/s), zero where x' ≤ 0 when
    a ReLU is fused; f32 math for any I/O dtype."""
    xr = x.float()
    if bias is not None:
        xr = xr + bias.float().reshape(1, -1, 1, 1)
    relu = fuse_relu or bias is not None
    xx = torch.clamp_min(xr, 0.0) if relu else xr
    d = dy.float()
    pad = local_size // 2
    s = k + (alpha / local_size) * _window_sum(xx * xx, pad)
    s_nb = torch.exp(-beta * torch.log(s))
    u = d * xx * s_nb / s
    dx = d * s_nb - (2.0 * alpha * beta / local_size) * xx \
        * _window_sum(u, pad)
    if relu:
        dx = torch.where(xr > 0.0, dx, 0.0)
    return dx.to(x.dtype)


def bias_relu_lrn_bwd_plain(x: torch.Tensor, bias: torch.Tensor,
                            dy: torch.Tensor, local_size: int = 5,
                            alpha: float = 1e-4, beta: float = 0.75,
                            k: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: (dx, d_bias) of lrn(relu(x + bias)).  dx is
    also d(x + bias), and d_bias is the f32 channel sum of dx as stored
    (in bf16 the rounded values, as the JAX VJP sums it), in the bias's
    dtype."""
    dx = lrn_bwd_plain(x, dy, local_size, alpha, beta, k, bias=bias)
    return dx, dx.float().sum(dim=(0, 2, 3)).to(bias.dtype)


def _check_grad_input(name: str, x: torch.Tensor, dy: torch.Tensor) -> None:
    if dy.shape != x.shape or dy.dtype != x.dtype \
            or dy.device != x.device:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if not dy.is_contiguous():
        raise ValueError(f"{name}: dy must be contiguous")


def lrn_across_channels_bwd(x: torch.Tensor, dy: torch.Tensor,
                            local_size: int = 5, alpha: float = 1e-4,
                            beta: float = 0.75, k: float = 1.0,
                            fuse_relu: bool = False) -> torch.Tensor:
    """dx of `lrn_across_channels(x, ...)` for the upstream gradient dy
    (K2); the normalizer and the ReLU mask are recomputed from x.  On the
    card x and dy may be views that start at any element."""
    name = "lrn_across_channels_bwd"
    if not _route(x, name):
        return lrn_bwd_plain(x, dy, local_size, alpha, beta, k, fuse_relu)
    _check_lrn_input(name, x, local_size)
    _check_grad_input(name, x, dy)
    n, c, h, w = x.shape
    relu = int(bool(fuse_relu))
    plan = _lrn_launch_plan(x, local_size, 2, relu)
    dx = torch.empty_like(x)
    lib = cuda_build.library("lrn")
    with torch.cuda.device(x.device):
        status = lib.cos_lrn_bwd(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, h * w,
            int(local_size), alpha / local_size, -beta, -beta - 1.0, k,
            2.0 * alpha * beta / local_size, relu, plan.tile, plan.run,
            _LRN_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_status(name, status)
    _count(name, x.dtype)
    return dx


# The LRN kernels' launch plans.  A block of each kernel owns one sample,
# a tile of spatial positions (one a thread) and a run of channels; a run
# reads halo channels of x past each end (K1 and K3 pad, K2 and K4
# 2 * pad), and its shortest length is K4_MIN_RUN (or C).  K4's tile is
# K4_TILE (csrc/lrn.cu k4::kTile); K1-K3 take theirs from LRN_TILES
# (csrc/lrn.cu `staged::of_dtype`) and walk LRN_STAGE channels a stage.
K4_TILE = 128
K4_MIN_RUN = 8
LRN_TILES = (64, 96, 128)
LRN_PAD_SHARE = 0.15      # the share of a tile's slots a plane may leave idle
LRN_STAGE = 8
# K1-K3 by the number csrc/lrn.cu's `staged::kernel` takes
LRN_KERNELS = {1: "lrn_across_channels", 2: "lrn_across_channels_bwd",
               3: "bias_relu_lrn_across_channels"}


class K4Plan(NamedTuple):
    tiles: int      # K4_TILE-wide tiles of a sample's H*W
    run: int        # channels a block writes (the last run may be shorter)
    runs: int       # runs of C
    blocks: int     # N * tiles * runs
    waves: float    # blocks over the card's resident blocks


class LRNPlan(NamedTuple):
    tile: int       # positions a block (one of LRN_TILES)
    tiles: int      # tiles of a sample's H*W
    run: int        # channels a block writes (the last run may be shorter)
    runs: int       # runs of C
    blocks: int     # N * tiles * runs
    waves: float    # blocks over the card's resident blocks


def _cut_runs(name: str, shape, tiles: int, wave: int, steps,
              tail: float = 1.0) -> Tuple[int, int, int]:
    """(run, runs, blocks) of an LRN kernel's plan: the channel runs are
    cut until N x tiles x runs fills at least one whole wave of `wave`
    blocks (where a run of K4_MIN_RUN channels still can), and among
    those cuts the one of least estimated time is kept: the steps of all
    blocks over the blocks the card runs at once, plus `tail` times the
    steps of one block (the last blocks run alone); `steps(run)` is a
    block's, so short runs pay in halo and long ones in that tail."""
    n, c = int(shape[0]), int(shape[1])
    best = None
    for cut in range(1, c // min(c, K4_MIN_RUN) + 1):
        run = -(-c // cut)
        runs = -(-c // run)
        blocks = n * tiles * runs
        t = steps(run)
        key = (blocks < wave, blocks * t / wave + tail * t, runs)
        if best is None or key < best[0]:
            best = (key, run, runs, blocks)
    _, run, runs, blocks = best
    if blocks > 2**31 - 1:
        raise ValueError(f"{name}: {tuple(shape)} needs {blocks} blocks, "
                         "more than 2^31 - 1")
    return run, runs, blocks


def _check_plan(name: str, shape, local_size: int, sms: int,
                *blocks_per_sm: int) -> Tuple[int, int, int, int]:
    n, c, h, w = (int(v) for v in shape)
    if min(n, c, h * w, local_size, sms, *blocks_per_sm) < 1:
        occ = blocks_per_sm[0] if len(blocks_per_sm) == 1 else blocks_per_sm
        raise ValueError(f"{name}: no plan for {tuple(shape)}, local_size "
                         f"{local_size}, {sms} SMs x {occ} blocks")
    return n, c, h, w


@functools.lru_cache(maxsize=256)
def k4_plan(shape: Tuple[int, int, int, int], local_size: int, sms: int,
            blocks_per_sm: int) -> K4Plan:
    """The launch plan of K4 for an (N, C, H, W) input on a card of `sms`
    SMs that holds `blocks_per_sm` of its blocks each: `_cut_runs`' runs
    for a block of run + 4 pad steps.  Refuses a sample's C*H*W of 2^31
    elements or more (the kernel's 32-bit offsets)."""
    name = "bias_relu_lrn_across_channels_bwd"
    n, c, h, w = _check_plan(name, shape, local_size, sms, blocks_per_sm)
    if c * h * w >= 2**31:
        raise ValueError(f"{name}: a sample's C*H*W is {c * h * w} elements; "
                         "the kernel takes fewer than 2^31")
    pad = local_size // 2
    tiles = -(-h * w // K4_TILE)
    wave = sms * blocks_per_sm
    run, runs, blocks = _cut_runs(name, shape, tiles, wave,
                                  lambda run: run + 4 * pad)
    return K4Plan(tiles, run, runs, blocks, blocks / wave)


def lrn_tile(hw: int) -> int:
    """K1-K3's tile for an H*W plane: the widest of LRN_TILES that leaves
    under LRN_PAD_SHARE of its slots idle, else the one that leaves the
    fewest (the widest of equals): 13x13 = 169 takes two tiles of 96
    (12 % idle; 128 would leave 34 %), 27x27 six of 128, 55x55 24."""
    def idle(t):
        slots = -(-hw // t) * t
        return (slots - hw) / slots
    fits = [t for t in LRN_TILES if idle(t) < LRN_PAD_SHARE]
    if fits:
        return max(fits)
    return min(LRN_TILES, key=lambda t: (idle(t), -t))


@functools.lru_cache(maxsize=512)
def lrn_plan(shape: Tuple[int, int, int, int], local_size: int, sms: int,
             occupancy: Tuple[int, ...], kernel: int) -> LRNPlan:
    """The launch plan of K1, K2 or K3 (`kernel` 1, 2, 3) for an (N, C, H,
    W) input on a card of `sms` SMs that holds occupancy[i] blocks of
    the kernel at tile LRN_TILES[i] each: `lrn_tile`'s tile and
    `_cut_runs`' runs, a block's steps being its run and both halos (K1
    and K3 pad a side, K2 2 pad) in whole stages of LRN_STAGE channels.
    K2's tail counts half: its halo steps take the normalizer too, and on
    the H100 its longer runs measured faster (scripts/lrn_variants.py)."""
    name = LRN_KERNELS[kernel]
    if len(occupancy) != len(LRN_TILES):
        raise ValueError(f"{name}: occupancy {occupancy} is not one a tile "
                         f"of {LRN_TILES}")
    n, c, h, w = _check_plan(name, shape, local_size, sms, *occupancy)
    halo = (2 if kernel == 2 else 1) * (local_size // 2)
    tile = lrn_tile(h * w)
    tiles = -(-h * w // tile)
    wave = sms * occupancy[LRN_TILES.index(tile)]
    run, runs, blocks = _cut_runs(
        name, shape, tiles, wave,
        lambda run: -(-(run + 2 * halo) // LRN_STAGE) * LRN_STAGE,
        tail=0.5 if kernel == 2 else 1.0)
    return LRNPlan(tile, tiles, run, runs, blocks, blocks / wave)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _k4_blocks_per_sm(index: int, local_size: int, dtype_code: int) -> int:
    with torch.cuda.device(index):
        got = cuda_build.library("lrn").cos_bias_relu_lrn_bwd_occupancy(
            local_size, dtype_code, 1)
    if got <= 0:
        raise RuntimeError("bias_relu_lrn_across_channels_bwd: occupancy "
                           f"query failed (cudaError {-got})")
    return got


@functools.lru_cache(maxsize=None)
def _lrn_blocks_per_sm(index: int, kernel: int, local_size: int, tile: int,
                       dtype_code: int, relu: int) -> int:
    with torch.cuda.device(index):
        got = cuda_build.library("lrn").cos_lrn_occupancy(
            kernel, local_size, tile, dtype_code, relu)
    if got <= 0:
        raise RuntimeError(f"{LRN_KERNELS[kernel]}: occupancy query failed "
                           f"(cudaError {-got})")
    return got


def _lrn_launch_plan(x: torch.Tensor, local_size: int, kernel: int,
                     relu: int) -> LRNPlan:
    """`lrn_plan` for a CUDA tensor, from the card's SM count and the
    kernel variant's occupancy at each tile (the register-ring kernels by
    pad up to 5, the runtime-window kernel above), each read once a
    device and variant and kept."""
    idx = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    ls, code = min(int(local_size), 13), _LRN_DTYPES[x.dtype]
    occupancy = tuple(_lrn_blocks_per_sm(idx, kernel, ls, t, code, relu)
                      for t in LRN_TILES)
    return lrn_plan(tuple(x.shape), int(local_size), _sm_count(idx),
                    occupancy, kernel)


def _k4_card(device: torch.device, local_size: int,
             dtype: torch.dtype) -> Tuple[int, int]:
    """(SMs, K4 blocks an SM holds) of the card, each read once a device
    and kernel variant (the register-ring kernels by pad up to 5, the
    runtime-window kernel above) and kept."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    return (_sm_count(idx),
            _k4_blocks_per_sm(idx, min(local_size, 13), _LRN_DTYPES[dtype]))


def bias_relu_lrn_across_channels_bwd(x: torch.Tensor, bias: torch.Tensor,
                                      dy: torch.Tensor, local_size: int = 5,
                                      alpha: float = 1e-4,
                                      beta: float = 0.75,
                                      k: float = 1.0
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, d_bias) of `bias_relu_lrn_across_channels(x, bias, ...)` (K4):
    dx, which is also the gradient with respect to x + bias, and its
    (N, H, W) sum, in one pass of the kernel.  The kernel writes one f32
    partial sum a (sample, tile, channel) to a scratch buffer, and a
    second small kernel sums them in a fixed order: every call gives the
    same bytes.  On the card x and dy must start on 16 bytes (the
    kernel's copy unit); a view that does not is refused by name."""
    name = "bias_relu_lrn_across_channels_bwd"
    if not _route(x, name):
        return bias_relu_lrn_bwd_plain(x, bias, dy, local_size, alpha, beta,
                                       k)
    _check_lrn_input(name, x, local_size)
    _check_grad_input(name, x, dy)
    n, c, h, w = x.shape
    if bias.shape != (c,) or bias.device != x.device:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} on "
                         f"{bias.device} for {c} channels on {x.device}")
    for what, t in (("x", x), ("dy", dy)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} starts at {t.data_ptr():#x}, "
                             "not on the 16 bytes the kernel copies from")
    plan = k4_plan(tuple(x.shape), int(local_size),
                   *_k4_card(x.device, local_size, x.dtype))
    b = bias.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    partial = torch.empty((c, n * plan.tiles), dtype=torch.float32,
                          device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    lib = cuda_build.library("lrn")
    with torch.cuda.device(x.device):
        status = lib.cos_bias_relu_lrn_bwd(
            x.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), db.data_ptr(), n, c, h * w, int(local_size),
            alpha / local_size, -beta, -beta - 1.0, k,
            2.0 * alpha * beta / local_size, plan.tiles, plan.run,
            _LRN_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_status(name, status)
    _count(name, x.dtype)
    return dx, db.to(bias.dtype)


class LRNAcrossChannels(torch.autograd.Function):
    """lrn(x) (or lrn(relu(x))): forward K1, backward K2.  Saves only x;
    the backward recomputes the normalizer from it."""

    @staticmethod
    def forward(ctx, x, local_size, alpha, beta, k, fuse_relu):
        ctx.save_for_backward(x)
        ctx.args = (local_size, alpha, beta, k, fuse_relu)
        return lrn_across_channels(x, local_size, alpha, beta, k, fuse_relu)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dx = lrn_across_channels_bwd(x, dy.contiguous(), *ctx.args)
        return dx, None, None, None, None, None


class BiasReluLRNAcrossChannels(torch.autograd.Function):
    """lrn(relu(x + bias)): forward K3, backward K4, which gives dx and
    d_bias (the f32 channel sum of dx) in one pass.  Saves the raw x and
    the bias."""

    @staticmethod
    def forward(ctx, x, bias, local_size, alpha, beta, k):
        ctx.save_for_backward(x, bias)
        ctx.args = (local_size, alpha, beta, k)
        return bias_relu_lrn_across_channels(x, bias, local_size, alpha,
                                             beta, k)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        # K4 copies from 16-byte words: a contiguous narrow of a larger
        # gradient (a channel Concat's backward at a batch of 1) can start
        # off them, and takes a fresh copy here
        x, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, dy.contiguous()))
        dx, db = bias_relu_lrn_across_channels_bwd(x, bias, dy, *ctx.args)
        return dx, db, None, None, None, None


# ---------------------------------------------------------------------------
# K5: int8 x int8 -> int32 (serving InnerProduct)
# ---------------------------------------------------------------------------

def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version of K5.  float64 products and sums of int8 values
    are exact integers (|sum| <= 127^2·K < 2^53 for any K below 5e11),
    so this is the exact int32 result on every device."""
    return torch.matmul(xq.to(torch.float64),
                        wq.to(torch.float64).T).to(torch.int32)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8ᵀ -> (M, N) int32, any M, N, K."""
    name = "int8_matmul"
    if not _route(xq, name):
        return int8_matmul_plain(xq, wq)
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(xq.shape)} x "
                         f"{tuple(wq.shape)} do not contract")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"{name}: dtypes {xq.dtype}, {wq.dtype} "
                         "(need int8)")
    if wq.device != xq.device:
        raise ValueError(f"{name}: operands on {xq.device} and "
                         f"{wq.device}")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    m, kk = xq.shape
    n = wq.shape[0]
    if m * n == 0 or kk == 0:
        raise ValueError(f"{name}: empty operand")
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    lib = cuda_build.library("int8_matmul")
    with torch.cuda.device(xq.device):
        status = lib.cos_int8_matmul(
            xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, n, kk,
            torch.cuda.current_stream(xq.device).cuda_stream)
    _check_status(name, status)
    _count(name, xq.dtype)
    return out


def quantize_int8(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 on a max-abs scale, round-to-nearest-
    even, or with `generator` stochastic rounding (floor(x/scale + u),
    u uniform in [0, 1): gradsync's `quantize_int8` with an rng).
    Returns (int8 tensor, f32 0-dim scale).  The scale divides as a
    tensor on the input's device: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which can round differently."""
    f = x.to(torch.float32)
    c127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(f.abs().max(), 1e-30) / c127
    y = f / scale
    if generator is None:
        y = torch.round(y)
    else:
        y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       dtype=torch.float32,
                                       device=y.device))
    q = torch.clamp(y, -127.0, 127.0)
    return q.to(torch.int8), scale


def int8_inner_product(x: torch.Tensor, w: torch.Tensor, *,
                       transpose: bool = False,
                       w_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Quantized InnerProduct forward: y ≈ x @ wᵀ (Caffe layout; x @ w
    with `transpose`), int8 operands on per-tensor max-abs scales, int32
    accumulation, output in x's dtype.  A float `w` quantizes per call;
    an int8 `w` is the publish-time resident weight and needs its
    `w_scale`.  The activation quantizes per call."""
    wn = w.T if transpose else w                  # (N, K)
    xq, sx = quantize_int8(x)
    if wn.dtype == torch.int8:
        if w_scale is None:
            raise ValueError("int8_inner_product: pre-quantized int8 "
                             "weight needs its publish-time w_scale")
        wqn, sw = wn, torch.as_tensor(w_scale, dtype=torch.float32,
                                      device=x.device)
    else:
        wqn, sw = quantize_int8(wn)
    acc = int8_matmul(xq, wqn.contiguous())
    return (acc.to(torch.float32) * (sx * sw)).to(x.dtype)


# ---------------------------------------------------------------------------
# K6 / K7 / K8: flash attention forward and backward
# ---------------------------------------------------------------------------

FLASH_NEG = -1e30        # the TPU kernels' finite mask value (_NEG_INF)
FLASH_MAX_D = 256


def _causal_mask(s: torch.Tensor) -> torch.Tensor:
    """Scores with key c hidden from query r < c by the finite -1e30."""
    t_q, t_k = s.shape[-2], s.shape[-1]
    keep = torch.ones((t_q, t_k), dtype=torch.bool, device=s.device).tril()
    return torch.where(keep, s, FLASH_NEG)


def flash_attention_plain(qf: torch.Tensor, kf: torch.Tensor,
                          vf: torch.Tensor, causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6 on (B·H, T, D): (O in q's dtype, lse (B·H, T)
    f32) at full width in f32, with the TPU kernel's finite -1e30 causal
    mask and its final O = acc / l, lse = m + log l."""
    scale = 1.0 / math.sqrt(qf.shape[-1])
    s = torch.matmul(qf.float(), kf.float().transpose(-1, -2)) * scale
    if causal:
        s = _causal_mask(s)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.matmul(p, vf.float()) / l
    return out.to(qf.dtype), (m + torch.log(l))[..., 0]


def _flash_bwd_scores_plain(qf, kf, vf, dof, lse, delta, causal):
    """f32 operands, P and dS of the TPU backward kernels
    (pallas_kernels.py:509-519 and 549-557): p = exp(s - lse),
    ds = p·(dO·Vᵀ - delta)·scale."""
    scale = 1.0 / math.sqrt(qf.shape[-1])
    q, k, v, do = (x.float() for x in (qf, kf, vf, dof))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        s = _causal_mask(s)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return q, k, do, p, ds


def flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal: bool = False,
                       out_dtype=None) -> torch.Tensor:
    """Plain version of K7: dq = dS·K."""
    _, k, _, _, ds = _flash_bwd_scores_plain(qf, kf, vf, dof, lse, delta,
                                             causal)
    return torch.matmul(ds, k).to(out_dtype or qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal: bool = False,
                        out_dtype=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: dk = dSᵀ·q, dv = Pᵀ·dO."""
    q, _, do, p, ds = _flash_bwd_scores_plain(qf, kf, vf, dof, lse, delta,
                                              causal)
    return (torch.matmul(ds.transpose(-1, -2), q).to(out_dtype or kf.dtype),
            torch.matmul(p.transpose(-1, -2), do).to(out_dtype or vf.dtype))


def flash_bwd_block_plain(qf, kf, vf, dof, lse, delta, *, causal: bool,
                          out_dtype=None):
    """Plain version of `flash_bwd_block` (K7 and K8 together), formula
    for formula as pallas_kernels.py:509-522 and 549-558."""
    q, k, do, p, ds = _flash_bwd_scores_plain(qf, kf, vf, dof, lse, delta,
                                              causal)
    return (torch.matmul(ds, k).to(out_dtype or qf.dtype),
            torch.matmul(ds.transpose(-1, -2), q).to(out_dtype or kf.dtype),
            torch.matmul(p.transpose(-1, -2), do).to(out_dtype or vf.dtype))


def _check_flash_wide(name: str, qf: torch.Tensor, *others: torch.Tensor,
                      stats: Tuple[torch.Tensor, ...] = ()) -> None:
    """The launch check of the wide kernels (the `cos_flash_*_wide` entry
    points): (B·H, T, D) operands of one dtype, device and shape,
    contiguous, any D; the row statistics (B·H, T) f32 contiguous."""
    if qf.dim() != 3 or qf.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty (B*H, T, D), got "
                         f"{tuple(qf.shape)}")
    if qf.dtype not in _LRN_DTYPES:
        raise ValueError(f"{name}: dtype {qf.dtype} not in "
                         f"{list(_LRN_DTYPES)}")
    for x in (qf,) + others:
        if x.shape != qf.shape or x.dtype != qf.dtype \
                or x.device != qf.device:
            raise ValueError(f"{name}: operand {tuple(x.shape)} {x.dtype} "
                             f"on {x.device} does not match q "
                             f"{tuple(qf.shape)} {qf.dtype} on {qf.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for x in stats:
        if x.shape != qf.shape[:2] or x.dtype != torch.float32 \
                or x.device != qf.device or not x.is_contiguous():
            raise ValueError(f"{name}: row statistics must be contiguous "
                             f"f32 {tuple(qf.shape[:2])} on {qf.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def _check_flash(name: str, qf: torch.Tensor, *others: torch.Tensor,
                 stats: Tuple[torch.Tensor, ...] = ()) -> None:
    """The launch check of the padded-width kernels (the `cos_flash_*`
    entry points): the wide check's operand rules and D <= FLASH_MAX_D."""
    if qf.dim() == 3 and qf.shape[-1] > FLASH_MAX_D:
        raise ValueError(f"{name}: head dim {qf.shape[-1]} > "
                         f"{FLASH_MAX_D}")
    _check_flash_wide(name, qf, *others, stats=stats)


def _flash_route(qf: torch.Tensor, entry: str):
    """The entry point's name for q's head width (the padded-width
    kernels up to FLASH_MAX_D, the wide ones above) and its launch
    check."""
    if qf.dim() == 3 and qf.shape[-1] > FLASH_MAX_D:
        return entry + "_wide", _check_flash_wide
    return entry, _check_flash


def _flash_out_dtype(name: str, qf: torch.Tensor, out_dtype) -> torch.dtype:
    dt = out_dtype or qf.dtype
    if dt not in _LRN_DTYPES:
        raise ValueError(f"{name}: out_dtype {dt} not in "
                         f"{list(_LRN_DTYPES)}")
    return dt


def flash_attention_fwd(qf: torch.Tensor, kf: torch.Tensor,
                        vf: torch.Tensor, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on (B·H, T, D): (O in q's dtype, lse (B·H, T) f32), any T >= 1,
    any D (the wide kernel above FLASH_MAX_D), f32 or bf16."""
    name = "flash_attention_fwd"
    if not _route(qf, name):
        return flash_attention_plain(qf, kf, vf, causal)
    entry, check = _flash_route(qf, "cos_flash_fwd")
    check(name, qf, kf, vf)
    bh, t, d = qf.shape
    out = torch.empty_like(qf)
    lse = torch.empty((bh, t), dtype=torch.float32, device=qf.device)
    with torch.cuda.device(qf.device):
        status = getattr(cuda_build.library("flash_attn"), entry)(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, d, 1.0 / math.sqrt(d), int(bool(causal)),
            _LRN_DTYPES[qf.dtype],
            torch.cuda.current_stream(qf.device).cuda_stream)
    _check_status(name, status)
    _count(name, qf.dtype)
    return out, lse


def flash_attention_bwd_dq(qf, kf, vf, dof, lse, delta,
                           causal: bool = False,
                           out_dtype=None) -> torch.Tensor:
    """K7: dq of flash attention from the saved lse and
    delta = Σ_d dO∘O, in `out_dtype` (default q's)."""
    name = "flash_attention_bwd_dq"
    if not _route(qf, name):
        return flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal,
                                  out_dtype)
    entry, check = _flash_route(qf, "cos_flash_bwd_dq")
    check(name, qf, kf, vf, dof, stats=(lse, delta))
    dt = _flash_out_dtype(name, qf, out_dtype)
    bh, t, d = qf.shape
    dq = torch.empty((bh, t, d), dtype=dt, device=qf.device)
    with torch.cuda.device(qf.device):
        status = getattr(cuda_build.library("flash_attn"), entry)(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, d,
            1.0 / math.sqrt(d), int(bool(causal)), _LRN_DTYPES[qf.dtype],
            _LRN_DTYPES[dt], torch.cuda.current_stream(qf.device).cuda_stream)
    _check_status(name, status)
    _count(name, qf.dtype)
    return dq


def flash_attention_bwd_dkv(qf, kf, vf, dof, lse, delta,
                            causal: bool = False, out_dtype=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: (dk, dv) of flash attention, in `out_dtype` (default k's)."""
    name = "flash_attention_bwd_dkv"
    if not _route(qf, name):
        return flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal,
                                   out_dtype)
    entry, check = _flash_route(qf, "cos_flash_bwd_dkv")
    check(name, qf, kf, vf, dof, stats=(lse, delta))
    dt = _flash_out_dtype(name, qf, out_dtype)
    bh, t, d = qf.shape
    dk = torch.empty((bh, t, d), dtype=dt, device=qf.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(qf.device):
        status = getattr(cuda_build.library("flash_attn"), entry)(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, d, 1.0 / math.sqrt(d), int(bool(causal)),
            _LRN_DTYPES[qf.dtype], _LRN_DTYPES[dt],
            torch.cuda.current_stream(qf.device).cuda_stream)
    _check_status(name, status)
    _count(name, qf.dtype)
    return dk, dv


def flash_bwd_block(qf, kf, vf, dof, lse, delta, *, causal: bool,
                    out_dtype=None):
    """dq, dk, dv of one attention block from the saved statistics: K7,
    then K8 (the JAX function of this name, without its TPU block and
    interpret arguments).  All operands (B·H, T, D) / (B·H, T);
    `causal` masks with local positions; `out_dtype` overrides the
    gradients' dtype (float32 for callers that accumulate bf16 parts)."""
    dq = flash_attention_bwd_dq(qf, kf, vf, dof, lse, delta, causal,
                                out_dtype)
    dk, dv = flash_attention_bwd_dkv(qf, kf, vf, dof, lse, delta, causal,
                                     out_dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q·kᵀ/√D)·v on (B, H, T, D), optional causal mask: forward
    K6, backward K7 + K8.  Saves q, k, v, O and lse (flattened to
    (B·H, T, D) / (B·H, T)), the JAX custom VJP's residuals; delta =
    Σ_d dO∘O is one f32 PyTorch expression outside the kernels, as XLA
    computes it outside the TPU kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, h, t, d = q.shape
        qf, kf, vf = (x.reshape(b * h, t, d).contiguous() for x in (q, k, v))
        out, lse = flash_attention_fwd(qf, kf, vf, causal)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.causal = causal
        return out.reshape(b, h, t, d)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        dof = do.reshape(qf.shape).to(qf.dtype).contiguous()
        delta = torch.sum(dof.float() * out.float(), dim=-1)
        dq, dk, dv = flash_bwd_block(qf, kf, vf, dof, lse, delta,
                                     causal=ctx.causal)
        shape = do.shape
        return dq.reshape(shape), dk.reshape(shape), dv.reshape(shape), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused blockwise attention, (B, H, T, D) -> (B, H, T, D), through
    `FlashAttention` (K6, backward K7/K8 on the card; their plain
    versions for a CPU or meta tensor), at any T."""
    return FlashAttention.apply(q, k, v, causal)


# ---------------------------------------------------------------------------
# K9: flash block update (one ring-attention hop)
# ---------------------------------------------------------------------------

def flash_block_update_plain(q: torch.Tensor, k_blk: torch.Tensor,
                             v_blk: torch.Tensor, m: torch.Tensor,
                             l: torch.Tensor, acc: torch.Tensor,
                             q_off: int, k_off: int, causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of K9 over the whole hop, formula for formula as the
    TPU kernel's `_online_softmax_step` (pallas_kernels.py:436-455): with
    `causal`, key c is hidden from query r by the finite -1e30 unless
    q_off + r >= k_off + c; m' = max(m, rowmax s), m_safe = (m' <= -5e29
    ? 0 : m'), p = exp(s - m_safe), corr = exp(m - m_safe), l' = l·corr
    + rowsum p, acc' = acc·corr + p·v.  q (BH, Tq, D) and k_blk, v_blk
    (BH, Tk, D) in f32 or bf16; the carry (m, l (BH, Tq), acc (BH, Tq,
    D)) and the results in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k_blk.float().transpose(-1, -2)) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k_blk.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, FLASH_NEG)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    m_safe = torch.where(m_new <= FLASH_NEG * 0.5, 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(m - m_safe)
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.matmul(p, v_blk.float())
    return m_new, l_new, acc_new


def flash_block_update(q: torch.Tensor, k_blk: torch.Tensor,
                       v_blk: torch.Tensor, m: torch.Tensor,
                       l: torch.Tensor, acc: torch.Tensor, q_off: int,
                       k_off: int, causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9: fold the rotating block (k_blk, v_blk) (BH, Tk, D) into the
    online-softmax carry of the fixed queries q (BH, Tq, D), returning
    the new (m, l, acc).  q_off and k_off are the blocks' global time
    offsets (host integers: no hop synchronizes the device), used for
    the causal mask.  Any Tq, Tk >= 1 and any D (the wide kernel above
    FLASH_MAX_D); q, k_blk, v_blk f32
    or bf16 of one dtype; the carry is always f32, as the ring passes
    it, and any other carry dtype is refused."""
    name = "flash_block_update"
    for x in (m, l, acc):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the (m, l, acc) carry must be "
                             f"float32, got {x.dtype}")
    if not _route(q, name):
        return flash_block_update_plain(q, k_blk, v_blk, m, l, acc, q_off,
                                        k_off, causal)
    entry, check = _flash_route(q, "cos_flash_block_update")
    check(name, q, stats=(m, l))
    check(name, k_blk, v_blk)
    bh, t_q, d = q.shape
    t_k = k_blk.shape[1]
    if k_blk.shape[0] != bh or k_blk.shape[2] != d \
            or k_blk.dtype != q.dtype or k_blk.device != q.device:
        raise ValueError(f"{name}: block {tuple(k_blk.shape)} "
                         f"{k_blk.dtype} on {k_blk.device} does not fit q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if acc.shape != q.shape or acc.device != q.device \
            or not acc.is_contiguous():
        raise ValueError(f"{name}: acc must be contiguous f32 "
                         f"{tuple(q.shape)} on {q.device}, got "
                         f"{tuple(acc.shape)} on {acc.device}")
    m_out = torch.empty_like(m)
    l_out = torch.empty_like(l)
    acc_out = torch.empty_like(acc)
    with torch.cuda.device(q.device):
        status = getattr(cuda_build.library("flash_attn"), entry)(
            q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
            acc_out.data_ptr(), bh, t_q, t_k, d, 1.0 / math.sqrt(d),
            int(q_off), int(k_off), int(bool(causal)), _LRN_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _check_status(name, status)
    _count(name, q.dtype)
    return m_out, l_out, acc_out
