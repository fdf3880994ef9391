"""Caffe layer semantics as PyTorch functions (the image nets and the
transformer language model).

Each layer type registers:
  * ``param_specs(lp, bottom_shapes)`` -> list of (blob_name, shape,
    filler) for its learnable blobs (Caffe blob order, so `.caffemodel`
    import/export maps 1:1), and
  * ``apply(ctx, lp, params, bottoms)`` -> list of top tensors.

Layout is NCHW at layer boundaries, as in the JAX package, so the two
compare like with like.  Caffe behaviours reproduced: pooling ceil-mode
output sizing with tail-window clipping, the AVE divisor = window ∩
padded region, LRN ACROSS_CHANNELS with alpha/local_size,
SoftmaxWithLoss VALID normalization + ignore_label.

BatchNorm writes its running statistics to `Ctx.state_out` at TRAIN
(Caffe's batch_norm_layer.cpp moving averages), which the net merges
into its params after the step.  The recurrent layers (LSTM, RNN) are
time-major and cont-gated, a Python loop over the time steps whose
products go to cuBLAS through `torch.matmul`, as the JAX package's
`lax.scan` leaves them to XLA.

The across-channel LRN (plain, relu-fused, bias+relu-fused) goes
through the autograd Functions of `ops.kernels` (K1/K2, K3/K4), the
int8 InnerProduct to K5 and MultiHeadAttention's attention to the flash
kernels (K6, backward K7/K8), or, under a mesh that shards time over
sp (`flash_mesh`), to the ring (K9, backward K7/K8).  Convolutions go
to cuDNN through `torch.nn.functional.conv2d` and the attention
projections to `torch.matmul`, as the JAX package left them to XLA.
Every other op is differentiable through autograd.  `Ctx.train` picks
Caffe's TRAIN semantics (Dropout draws its keep-mask, STOCHASTIC
pooling its picks, from `Ctx.generator`) or TEST semantics (Dropout is
the identity, STOCHASTIC pooling the activation-weighted mean).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..parallel import sp
from ..parallel.comm import Shards, all_gather, all_reduce
from ..proto.caffe import (BlobProto, EltwiseOp, FillerParameter,
                           LayerParameter, NormalizationMode, NormRegion,
                           PoolMethod)
from . import kernels as K


@dataclass
class Ctx:
    """Per-call context threaded through layer application."""
    # Caffe's TRAIN phase (Dropout active) and the generator its random
    # draws come from (on the net's device)
    train: bool = False
    generator: Optional[torch.Generator] = None
    # forward state: {layer: [tensors]} written by a layer whose params
    # the forward itself updates (BatchNorm's running statistics, in
    # its param blob order), detached from the graph; the caller merges
    # them (Net.merge_forward_state)
    state_out: Dict[str, List[torch.Tensor]] = field(default_factory=dict)
    layer_name: str = ""
    # LRN layer names whose op applies relu in-kernel (net.py's
    # COS_FUSE_RELU_LRN peephole)
    fused_relu_lrn: frozenset = frozenset()
    # conv-stem bias fusion (net.py peephole): conv layers whose bias add
    # is deferred into the consuming LRN kernel, and the LRN layers that
    # receive that bias as params[0]
    defer_bias: frozenset = frozenset()
    bias_lrn: frozenset = frozenset()
    # per-blob dequant scales of quantized-resident serving weights
    # ({layer: {blob: f32 0-dim tensor}}, serving/quant.py)
    qscales: Optional[Dict] = None
    # constants a layer reads, made once where the net is built
    # ({layer: [tensors]}, `LayerOp.setup`): never a host-to-device copy
    # inside a step
    consts: Dict[str, List[torch.Tensor]] = field(default_factory=dict)
    # data parallelism (Net.forward_ranks): the dp rank the layer runs
    # for, of `ranks`, and the batch axis of each of its bottoms; over
    # several processes (`procs` of them, each with `ranks` ranks) this
    # process's first rank is global dp rank `rank_offset`
    rank: int = 0
    ranks: int = 1
    procs: int = 1
    rank_offset: int = 0
    bottom_axes: tuple = ()
    mesh: Optional[object] = None   # the ranks' Mesh (all_reduce)
    # a layer's global draw, cut into the ranks' slices (`rand`)
    _draws: Dict[str, List[torch.Tensor]] = field(default_factory=dict)

    def qscale(self, bname: str):
        if not self.qscales:
            return None
        return self.qscales.get(self.layer_name, {}).get(bname)

    def bottom_axis(self, i: int) -> Optional[int]:
        """The batch axis of bottom i across dp ranks (None: one rank, or
        a blob that does not follow the batch)."""
        return self.bottom_axes[i] if i < len(self.bottom_axes) else None

    @property
    def spans(self) -> bool:
        """More than one dp rank over every process."""
        return self.ranks * self.procs > 1

    def rand(self, shape, device) -> torch.Tensor:
        """Uniform [0, 1) of `shape` from `generator`.  Across dp ranks,
        rank 0 draws the whole batch's numbers once (the rank's shape
        with its batch axis times every process's ranks) and each rank
        takes its slice at its global dp coordinate: dp N draws what dp
        1 draws on the same global batch, over one process or several
        (each process's generator is seeded alike and draws the whole
        batch)."""
        ax = self.bottom_axis(0)
        if not self.spans or ax is None:
            return torch.rand(shape, generator=self.generator,
                              device=device)
        if self.rank == 0:
            n = self.ranks * self.procs
            full = list(shape)
            full[ax] *= n
            self._draws[self.layer_name] = list(torch.chunk(
                torch.rand(full, generator=self.generator, device=device),
                n, dim=ax))[self.rank_offset:self.rank_offset + self.ranks]
        return self._draws[self.layer_name][self.rank].to(device)


@functools.lru_cache(maxsize=256)
def weak_scalar(v: float, dtype: torch.dtype) -> float:
    """A Python float as JAX's weak typing makes it beside a tensor of
    `dtype`: rounded to that dtype (0.7 beside bf16 is 0.69921875).
    PyTorch computes with a Python scalar at its op math's precision
    instead, so a layer that mirrors JAX rounds the scalar first; in
    f32 this changes nothing."""
    return float(torch.tensor(float(v), dtype=dtype))


def stable_hash(name: str) -> int:
    """Process-independent name hash (per-layer filler seeds)."""
    return zlib.crc32(name.encode("utf-8"))


@dataclass
class LayerOp:
    name: str
    apply: Callable
    param_specs: Callable = field(default=lambda lp, shapes: [])
    is_loss: bool = False
    is_data: bool = False
    # the layer keeps running statistics (its params, updated by the
    # forward and never by the solver) and computes in the net's dtype
    # whatever its compute dtype (BatchNorm)
    f32_stats: bool = False
    # bottoms the layer reads as integer indices (token ids, labels):
    # never cast to the compute dtype, whose 8-bit mantissa holds
    # integers exactly only up to 256
    index_bottoms: tuple = ()
    # setup(lp, device) -> [tensors]: constants read once where the net
    # is built (InfogainLoss's matrix), handed back in `Ctx.consts`
    setup: Optional[Callable] = None
    # apply_ranks(ctx, lp, [params], [bottoms]) -> [tops] per dp rank: a
    # layer whose result couples the batch (BatchNorm's statistics, the
    # losses' normalizers, Accuracy) sees every rank at once
    apply_ranks: Optional[Callable] = None
    # the tops are each rank's share of one value (a loss, an accuracy):
    # the global value is their sum
    shares: bool = False

    def run(self, ctx, lp, rank_params, rank_bottoms) -> list:
        """Every dp rank's tops: one rank's through `apply`, several
        through `apply_ranks` at once, else `apply` rank by rank."""
        if not ctx.spans:
            return [self.apply(ctx, lp, rank_params[0], rank_bottoms[0])]
        if self.apply_ranks is not None:
            return self.apply_ranks(ctx, lp, rank_params, rank_bottoms)
        tops = []
        for r, (prm, bots) in enumerate(zip(rank_params, rank_bottoms)):
            ctx.rank = r
            tops.append(self.apply(ctx, lp, prm, bots))
        ctx.rank = 0
        return tops


_REGISTRY: Dict[str, LayerOp] = {}


def register(name: str, *, params=None, is_loss=False, is_data=False,
             f32_stats=False, index_bottoms=(), setup=None, ranks=False,
             batch_mean=False, shares=False):
    """Register `fn` as the op of layer type `name`.  `ranks`: fn takes
    every dp rank's params and bottoms at once (a list per rank) and
    returns each rank's tops, for a layer whose result couples the
    batch; one rank's call is fn on lists of one.  `batch_mean`: fn is a
    loss averaged over its first bottom's leading extent, whose ranks'
    shares are rescaled to the whole batch (`_mean_loss_ranks`)."""
    def deco(fn):
        apply, apply_ranks = fn, None
        if ranks:
            apply_ranks = fn

            def apply(ctx, lp, params, bottoms):
                return fn(ctx, lp, [params], [bottoms])[0]
        elif batch_mean:
            apply_ranks = _mean_loss_ranks(fn)
        _REGISTRY[name] = LayerOp(name, apply, params or (lambda lp, s: []),
                                  is_loss=is_loss, is_data=is_data,
                                  f32_stats=f32_stats,
                                  index_bottoms=tuple(index_bottoms),
                                  setup=setup, apply_ranks=apply_ranks,
                                  shares=shares or batch_mean)
        return fn
    return deco


def _mean_loss_ranks(fn):
    """apply_ranks of a loss normalised by its first bottom's leading
    extent N: a rank's loss times N_rank / N_global is its share of the
    global batch's loss (1/dp when axis 0 is the batch axis)."""
    def ranks(ctx, lp, params, bottoms):
        ns = [b[0].shape[0] for b in bottoms]
        total = sum(ns) * ctx.procs if ctx.bottom_axis(0) == 0 else ns[0]
        return [[fn(ctx, lp, prm, b)[0] * (n / total)]
                for prm, b, n in zip(params, bottoms, ns)]
    return ranks


def _whole(t):
    """A param blob whole: a tp-split one joined (all_gather)."""
    return t.whole() if isinstance(t, Shards) else t


def _tp_products(x: torch.Tensor, w, transpose: bool = False
                 ) -> torch.Tensor:
    """x @ w.T (x @ w when `transpose`).  A weight split over tp
    (`parallel.comm.Shards`, from `MeshLayout`) gives each tp rank its
    column block of the product, on its device; an all_gather joins the
    blocks."""
    if not isinstance(w, Shards):
        return torch.matmul(x, w) if transpose else torch.matmul(x, w.T)
    return all_gather([torch.matmul(x.to(wj.device), wj) if transpose
                       else torch.matmul(x.to(wj.device), wj.T)
                       for wj in w], dim=-1)


def get_op(type_name: str) -> LayerOp:
    if type_name not in _REGISTRY:
        raise NotImplementedError(
            f"layer type {type_name!r} not supported by the PyTorch port")
    return _REGISTRY[type_name]


def _filler(msg, default_type="constant") -> FillerParameter:
    if isinstance(msg, FillerParameter):
        return msg
    return FillerParameter(type=default_type)


# ---------------------------------------------------------------------------
# data layers — net inputs; shapes resolved by the net compiler
# ---------------------------------------------------------------------------

def _data_layer(ctx, lp, params, bottoms):
    raise RuntimeError("data layers are net inputs; never applied")


for _t in ("MemoryData", "CoSData", "Input", "Data", "HDF5Data",
           "DummyData", "ImageData"):
    register(_t, is_data=True)(_data_layer)


@register("HDF5Output", ranks=True)
def _hdf5_output(ctx, lp, params, bottoms):
    """hdf5_output_layer.cpp: an output sink.  A forward writes no file
    (a CUDA graph could not replay it): the whole batch's bottoms, the
    dp ranks' joined on their batch axes (`Ctx.bottom_axis`), detached,
    go to `ctx.state_out["hdf5_output:<name>"]`, and the caller writes
    them (data/hdf5.py `collect_hdf5_outputs`, `write_hdf5_outputs`)."""
    out = []
    for i in range(len(bottoms[0])):
        vals = [b[i].detach() for b in bottoms]
        ax = ctx.bottom_axis(i)
        out.append(all_gather(vals, ax) if ax is not None else vals[0])
    ctx.state_out["hdf5_output:" + ctx.layer_name] = out
    return [[] for _ in bottoms]


# ---------------------------------------------------------------------------
# Convolution / InnerProduct
# ---------------------------------------------------------------------------

def _conv_geometry(cp):
    def pair(rep, h, w, default):
        if cp.has(h) or cp.has(w):
            if not (cp.has(h) and cp.has(w)):
                raise ValueError(f"{h} and {w} must be set together")
            return (int(getattr(cp, h)), int(getattr(cp, w)))
        v = getattr(cp, rep)
        if isinstance(v, list):
            if len(v) == 0:
                return (default, default)
            if len(v) == 1:
                return (int(v[0]), int(v[0]))
            return (int(v[0]), int(v[1]))
        return (int(v), int(v))

    kernel = pair("kernel_size", "kernel_h", "kernel_w", None)
    if kernel[0] is None:
        raise ValueError("convolution_param needs kernel_size or "
                         "kernel_h/kernel_w")
    stride = pair("stride", "stride_h", "stride_w", 1)
    pad = pair("pad", "pad_h", "pad_w", 0)
    dil = cp.dilation
    dilation = ((int(dil[0]), int(dil[-1] if len(dil) > 1 else dil[0]))
                if dil else (1, 1))
    return kernel, stride, pad, dilation


def _conv_params(lp, shapes):
    cp = lp.convolution_param
    (kh, kw), _, _, _ = _conv_geometry(cp)
    c_in = shapes[0][1]
    group = max(1, cp.group)
    specs = [("weight", (cp.num_output, c_in // group, kh, kw),
              _filler(cp.weight_filler if cp.has("weight_filler")
                      else None))]
    if cp.bias_term:
        specs.append(("bias", (cp.num_output,),
                      _filler(cp.bias_filler if cp.has("bias_filler")
                              else None)))
    return specs


@register("Convolution", params=_conv_params)
def _conv(ctx, lp, params, bottoms):
    cp = lp.convolution_param
    _, stride, pad, dilation = _conv_geometry(cp)
    out = F.conv2d(bottoms[0], params[0], stride=stride, padding=pad,
                   dilation=dilation, groups=max(1, cp.group))
    if cp.bias_term and ctx.layer_name not in ctx.defer_bias:
        # defer_bias: the bias add (and relu+LRN) runs in the consuming
        # LRN layer's fused epilogue (net.py stem peephole)
        out = out + params[1].reshape(1, -1, 1, 1)
    return [out]


def _deconv_params(lp, shapes):
    cp = lp.convolution_param
    (kh, kw), _, _, _ = _conv_geometry(cp)
    c_in = shapes[0][1]
    group = max(1, cp.group)
    # Caffe's Deconvolution weight blob: (C_in, N/group, kh, kw)
    specs = [("weight", (c_in, cp.num_output // group, kh, kw),
              _filler(cp.weight_filler if cp.has("weight_filler")
                      else None))]
    if cp.bias_term:
        specs.append(("bias", (cp.num_output,),
                      _filler(cp.bias_filler if cp.has("bias_filler")
                              else None)))
    return specs


@register("Deconvolution", params=_deconv_params)
def _deconv(ctx, lp, params, bottoms):
    """Caffe's deconvolution, the gradient of a convolution with respect
    to its input: output size s·(i−1) + d·(k−1) + 1 − 2p.  Caffe's
    weight blob (C_in, C_out/g, kh, kw) is `conv_transpose2d`'s own
    layout, so the blob goes to cuDNN as it is."""
    cp = lp.convolution_param
    _, stride, pad, dilation = _conv_geometry(cp)
    out = F.conv_transpose2d(bottoms[0], params[0], stride=stride,
                             padding=pad, dilation=dilation,
                             groups=max(1, cp.group))
    if cp.bias_term:
        out = out + params[1].reshape(1, -1, 1, 1)
    return [out]


def _ip_params(lp, shapes):
    ip = lp.inner_product_param
    k = math.prod(shapes[0][ip.axis:])
    shape = (k, ip.num_output) if ip.transpose else (ip.num_output, k)
    specs = [("weight", shape,
              _filler(ip.weight_filler if ip.has("weight_filler")
                      else None))]
    if ip.bias_term:
        specs.append(("bias", (ip.num_output,),
                      _filler(ip.bias_filler if ip.has("bias_filler")
                              else None)))
    return specs


@register("InnerProduct", params=_ip_params)
def _inner_product(ctx, lp, params, bottoms):
    ip = lp.inner_product_param
    x = bottoms[0]
    lead = tuple(x.shape[:ip.axis])
    x2 = x.reshape(math.prod(lead), -1)
    w = params[0]
    if w.dtype == torch.int8:
        # quantized-RESIDENT serving weight (serving/quant.py): quantized
        # once at publish, consumed by the int8 kernel with its scale
        y = K.int8_inner_product(x2, w, transpose=bool(ip.transpose),
                                 w_scale=ctx.qscale("weight"))
    else:
        y = _tp_products(x2, w, bool(ip.transpose))
    if ip.bias_term:
        y = y + _whole(params[1])
    return [y.reshape(lead + (ip.num_output,))]


def _embed_params(lp, shapes):
    ep = lp.embed_param
    specs = [("weight", (ep.input_dim, ep.num_output),
              _filler(ep.weight_filler if ep.has("weight_filler") else None))]
    if ep.bias_term:
        specs.append(("bias", (ep.num_output,),
                      _filler(ep.bias_filler if ep.has("bias_filler")
                              else None)))
    return specs


@register("Embed", params=_embed_params, index_bottoms=(0,))
def _embed(ctx, lp, params, bottoms):
    """Rows of the (input_dim, num_output) table at the bottom's values,
    cast to integers (float token ids from the data layer); a table
    split over tp looks up each rank's columns."""
    ids = bottoms[0].to(torch.int64)
    w = params[0]
    if isinstance(w, Shards):
        out = all_gather([F.embedding(ids.to(wj.device), wj) for wj in w],
                         dim=-1)
    else:
        out = F.embedding(ids, w)
    if lp.embed_param.bias_term:
        out = out + params[1]
    return [out]


# ---------------------------------------------------------------------------
# Pooling (Caffe ceil-mode + divisor semantics)
# ---------------------------------------------------------------------------

def pool_output_dim(size: int, kernel: int, stride: int, pad: int) -> int:
    out = int(math.ceil((size + 2 * pad - kernel) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def _ave_divisor(size: int, kernel: int, stride: int, pad: int, out: int,
                 like: torch.Tensor) -> torch.Tensor:
    """Per-output-position count of window elements inside the
    symmetric padded region [0, size + 2*pad) (Caffe's AVE divisor), in
    `like`'s dtype on its device.  Computed there from an arange: a host
    list copied to the card would be a host-to-device copy, which a CUDA
    graph capture refuses."""
    start = torch.arange(out, device=like.device) * stride
    return (torch.clamp(start + kernel, max=size + 2 * pad)
            - start).to(like.dtype)


@register("Pooling")
def _pooling(ctx, lp, params, bottoms):
    pp = lp.pooling_param
    x = bottoms[0]
    n, c, h, w = x.shape
    if pp.global_pooling:
        kh, kw = h, w
        sh = sw = 1
        ph = pw = 0
    else:
        for a, b in (("kernel_h", "kernel_w"), ("stride_h", "stride_w"),
                     ("pad_h", "pad_w")):
            if pp.has(a) != pp.has(b):
                raise ValueError(f"pooling_param: {a} and {b} must be set "
                                 "together")
        kh = int(pp.kernel_h) if pp.has("kernel_h") else int(pp.kernel_size)
        kw = int(pp.kernel_w) if pp.has("kernel_w") else int(pp.kernel_size)
        if kh == 0 or kw == 0:
            raise ValueError("pooling_param needs kernel_size or "
                             "kernel_h/kernel_w")
        sh = int(pp.stride_h) if pp.has("stride_h") else int(pp.stride)
        sw = int(pp.stride_w) if pp.has("stride_w") else int(pp.stride)
        ph = int(pp.pad_h) if pp.has("pad_h") else int(pp.pad)
        pw = int(pp.pad_w) if pp.has("pad_w") else int(pp.pad)
    oh = pool_output_dim(h, kh, sh, ph)
    ow = pool_output_dim(w, kw, sw, pw)
    # explicit asymmetric padding so the ceil-mode tail window exists
    eh = max(0, (oh - 1) * sh + kh - h - ph)
    ew = max(0, (ow - 1) * sw + kw - w - pw)
    if pp.pool == PoolMethod.MAX:
        xp = F.pad(x, (pw, ew, ph, eh), value=-math.inf)
        out = F.max_pool2d(xp, (kh, kw), (sh, sw))
    elif pp.pool == PoolMethod.AVE:
        xp = F.pad(x, (pw, ew, ph, eh))
        s = F.avg_pool2d(xp, (kh, kw), (sh, sw), divisor_override=1)
        div_h = _ave_divisor(h, kh, sh, ph, oh, x)
        div_w = _ave_divisor(w, kw, sw, pw, ow, x)
        out = s / (div_h.reshape(1, 1, -1, 1) * div_w.reshape(1, 1, 1, -1))
    elif pp.pool == PoolMethod.STOCHASTIC:
        out = _stochastic_pool(ctx, x, (kh, kw), (sh, sw), (ph, eh, pw, ew),
                               (oh, ow))
    else:
        raise NotImplementedError(f"pooling method {pp.pool}")
    return [out]


def _stochastic_pool(ctx, x, kernel, stride, pads, out_hw):
    """Caffe's PoolForward{Train,Test} (pooling_layer.cu) for
    non-negative (post-ReLU) activations.  TRAIN picks one element of
    each window with probability value / Σ window, drawn from
    `ctx.generator` (so a CUDA graph that registers the generator
    replays fresh draws), the gradient going to the picked element;
    TEST is the activation-weighted mean Σa² / Σa (0 for a window
    summing to 0).  The zero padding of the ceil-mode tail is never
    picked unless the whole window is zero.  The pick's arithmetic is
    f32, as the JAX package's: in bf16 a running sum can round below
    u·Σ and bias the draw toward the window's first element."""
    n, c = x.shape[0], x.shape[1]
    (kh, kw), (sh, sw), (ph, eh, pw, ew), (oh, ow) = (kernel, stride, pads,
                                                      out_hw)
    xp = F.pad(x, (pw, ew, ph, eh))
    if ctx.train:
        if ctx.generator is None:
            raise ValueError(f"STOCHASTIC pooling {ctx.layer_name!r} at "
                             "TRAIN needs a generator (Ctx.generator)")
        p = F.unfold(xp, (kh, kw), stride=(sh, sw)).reshape(
            n, c, kh * kw, oh, ow)
        cum = torch.cumsum(p.to(torch.float32), dim=2)
        total = cum[:, :, -1]
        u = ctx.rand(total.shape, x.device) * (1.0 - 1e-7) + 1e-7
        # the first window index whose running sum reaches u·Σ
        idx = (cum >= (u * total).unsqueeze(2)).to(torch.int32).argmax(
            dim=2, keepdim=True)
        return torch.gather(p, 2, idx).squeeze(2)
    xf = xp.to(torch.float32)
    total = F.avg_pool2d(xf, (kh, kw), (sh, sw), divisor_override=1)
    sq = F.avg_pool2d(xf * xf, (kh, kw), (sh, sw), divisor_override=1)
    return torch.where(total > 0,
                       sq / torch.where(total > 0, total, 1.0),
                       0.0).to(x.dtype)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

@register("ReLU")
def _relu(ctx, lp, params, bottoms):
    slope = lp.relu_param.negative_slope
    x = bottoms[0]
    if slope:
        return [torch.where(x > 0, x, weak_scalar(slope, x.dtype) * x)]
    return [torch.relu(x)]


def _prelu_params(lp, shapes):
    n = 1 if lp.prelu_param.channel_shared else shapes[0][1]
    f = (lp.prelu_param.filler if lp.prelu_param.has("filler")
         else FillerParameter(type="constant", value=0.25))
    return [("slope", (n,), f)]


@register("PReLU", params=_prelu_params)
def _prelu(ctx, lp, params, bottoms):
    x = bottoms[0]
    a = params[0].reshape((1, -1) + (1,) * (x.dim() - 2))
    return [torch.where(x > 0, x, a * x)]


@register("ELU")
def _elu(ctx, lp, params, bottoms):
    x = bottoms[0]
    a = weak_scalar(lp.elu_param.alpha, x.dtype)
    return [torch.where(x > 0, x, a * (torch.exp(x) - 1.0))]


@register("Sigmoid")
def _sigmoid(ctx, lp, params, bottoms):
    return [torch.sigmoid(bottoms[0])]


@register("TanH")
def _tanh(ctx, lp, params, bottoms):
    return [torch.tanh(bottoms[0])]


@register("AbsVal")
def _absval(ctx, lp, params, bottoms):
    return [torch.abs(bottoms[0])]


@register("BNLL")
def _bnll(ctx, lp, params, bottoms):
    x = bottoms[0]
    return [torch.where(x > 0, x + torch.log1p(torch.exp(-x)),
                        torch.log1p(torch.exp(x)))]


def _affine(p, x):
    """shift + scale · x, the Python scalars rounded to x's dtype."""
    return (weak_scalar(p.shift, x.dtype)
            + weak_scalar(p.scale, x.dtype) * x)


@register("Power")
def _power(ctx, lp, params, bottoms):
    p = lp.power_param
    y = _affine(p, bottoms[0])
    if p.power != 1.0:
        y = torch.pow(y, weak_scalar(p.power, y.dtype))
    return [y]


@register("Exp")
def _exp(ctx, lp, params, bottoms):
    p = lp.exp_param
    x = _affine(p, bottoms[0])
    if p.base > 0:
        return [torch.pow(weak_scalar(p.base, x.dtype), x)]
    return [torch.exp(x)]


@register("Log")
def _log(ctx, lp, params, bottoms):
    p = lp.log_param
    y = torch.log(_affine(p, bottoms[0]))
    if p.base > 0:
        y = y / weak_scalar(math.log(p.base), y.dtype)
    return [y]


@register("Threshold")
def _threshold(ctx, lp, params, bottoms):
    x = bottoms[0]
    t = weak_scalar(lp.threshold_param.threshold, x.dtype)
    return [(x > t).to(x.dtype)]


@register("Dropout")
def _dropout(ctx, lp, params, bottoms):
    ratio = lp.dropout_param.dropout_ratio
    x = bottoms[0]
    if not ctx.train or ratio == 0.0:
        return [x]             # TEST phase: the identity
    if ctx.generator is None:
        raise ValueError(f"Dropout {ctx.layer_name!r} at TRAIN needs a "
                         "generator (Ctx.generator)")
    keep = 1.0 - ratio
    mask = ctx.rand(x.shape, x.device) < keep
    return [torch.where(mask, x / weak_scalar(keep, x.dtype), 0.0)]


@register("Eltwise")
def _eltwise(ctx, lp, params, bottoms):
    p = lp.eltwise_param
    op = p.operation
    if op == EltwiseOp.PROD:
        y = bottoms[0]
        for b in bottoms[1:]:
            y = y * b
    elif op == EltwiseOp.SUM:
        coeffs = p.coeff if p.coeff else [1.0] * len(bottoms)
        if len(coeffs) != len(bottoms):
            raise ValueError(
                f"Eltwise SUM: {len(coeffs)} coeffs for "
                f"{len(bottoms)} bottoms (must match)")
        y = weak_scalar(coeffs[0], bottoms[0].dtype) * bottoms[0]
        for c, b in zip(coeffs[1:], bottoms[1:]):
            y = y + weak_scalar(c, b.dtype) * b
    else:  # MAX
        y = bottoms[0]
        for b in bottoms[1:]:
            y = torch.maximum(y, b)
    return [y]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@register("LRN")
def _lrn(ctx, lp, params, bottoms):
    p = lp.lrn_param
    x = bottoms[0]
    n = int(p.local_size)
    alpha, beta, k = p.alpha, p.beta, p.k
    if lp.name in ctx.bias_lrn:
        # conv-stem epilogue (net.py bias peephole): the producing conv's
        # bias arrives as params[0]; bias + relu + LRN in one kernel (K3,
        # backward K4), and the bias gradient flows back to the conv
        return [K.BiasReluLRNAcrossChannels.apply(
            x.contiguous(), params[0], n, alpha, beta, k)]
    if p.norm_region == NormRegion.ACROSS_CHANNELS:
        # K1 (backward K2); net.py's ReLU->LRN peephole routed the
        # pre-activation here
        return [K.LRNAcrossChannels.apply(x.contiguous(), n, alpha, beta,
                                          k, lp.name in ctx.fused_relu_lrn)]
    # WITHIN_CHANNEL: spatial window average of squares (plain)
    pad = n // 2
    s = F.avg_pool2d(F.pad(x * x, (pad, pad, pad, pad)), (n, n), (1, 1),
                     divisor_override=1)
    scale = k + (alpha / (n * n)) * s
    return [x / torch.pow(scale, beta)]


@register("MVN")
def _mvn(ctx, lp, params, bottoms):
    p = lp.mvn_param
    x = bottoms[0]
    axes = (1, 2, 3) if p.across_channels else (2, 3)
    y = x - torch.mean(x, dim=axes, keepdim=True)
    if p.normalize_variance:
        var = torch.mean(y * y, dim=axes, keepdim=True)
        y = y / (torch.sqrt(var) + weak_scalar(p.eps, y.dtype))
    return [y]


def _bn_params(lp, shapes):
    c = shapes[0][1]
    zero = FillerParameter(type="constant", value=0.0)
    return [("mean", (c,), zero), ("variance", (c,), zero),
            ("count", (1,), zero)]


def _bn_use_global(p, train: bool) -> bool:
    """The stored statistics: use_global_stats when given, else at
    TEST."""
    return p.use_global_stats if p.has("use_global_stats") else not train


def _bn_normalize(p, x, mean, var):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean.reshape(shape))
            / torch.sqrt(var.reshape(shape) + weak_scalar(p.eps, x.dtype)))


def _bn_moving(ctx, p, params, mean, var, m):
    """The moving sums the batch mode writes to `ctx.state_out`."""
    mean_b, var_b, count = params
    maf = p.moving_average_fraction
    bias_corr = m / (m - 1.0) if m > 1 else 1.0
    with torch.no_grad():
        ctx.state_out[ctx.layer_name] = [
            mean_b * weak_scalar(maf, mean_b.dtype) + mean,
            var_b * weak_scalar(maf, var_b.dtype)
            + var * weak_scalar(bias_corr, var.dtype),
            count * weak_scalar(maf, count.dtype) + 1.0]


def _rank_means(ctx, xs, axes):
    """The whole batch's mean over `axes` from the dp ranks' slices
    `xs`: each rank's mean weighted by its share of the count, then
    all-reduced (one rank: its own mean)."""
    counts = [x.shape[0] * math.prod(x.shape[2:]) for x in xs]
    m = sum(counts) * ctx.procs
    parts = [torch.mean(x, dim=axes) * (c / m) if c != m
             else torch.mean(x, dim=axes) for x, c in zip(xs, counts)]
    return all_reduce(parts, ctx.mesh, "dp"), m


@register("BatchNorm", params=_bn_params, f32_stats=True, ranks=True)
def _batch_norm(ctx, lp, params, bottoms):
    """Caffe's BatchNorm: normalize by the batch's statistics over N and
    the spatial axes (TRAIN), or by the stored ones scaled by 1/count
    (`use_global_stats`, TEST by default).  In the batch mode the
    statistics are the whole batch's across dp ranks, as the JAX package
    computes them on the global batch (`_rank_means`), and the moving
    sums stored * maf + batch mean, stored * maf + batch variance *
    m/(m-1) (Caffe keeps the unbiased variance; m = N*H*W) and
    count * maf + 1 go to `ctx.state_out`, once.
    Python scalars round to the blob's dtype first, as JAX's weak types
    make them."""
    p = lp.batch_norm_param
    xs = [b[0] for b in bottoms]
    if _bn_use_global(p, ctx.train):
        out = []
        for x, (mean_b, var_b, count) in zip(xs, params):
            scale = torch.where(count[0] == 0, 1.0, 1.0 / count[0])
            out.append([_bn_normalize(p, x, mean_b * scale,
                                      var_b * scale)])
        return out
    axes = (0,) + tuple(range(2, xs[0].dim()))
    means, m = _rank_means(ctx, xs, axes)
    squares, _ = _rank_means(ctx, [torch.square(x) for x in xs], axes)
    var_s = [sq - torch.square(mu) for sq, mu in zip(squares, means)]
    _bn_moving(ctx, p, params[0], means[0], var_s[0], m)
    return [[_bn_normalize(p, x, mu, v)]
            for x, mu, v in zip(xs, means, var_s)]


def _scale_params(lp, shapes):
    p = lp.scale_param
    bf = (p.bias_filler if p.has("bias_filler")
          else FillerParameter(type="constant", value=0.0))
    if len(shapes) > 1:
        # two bottoms: the multiplier is bottom[1]; only the optional
        # bias is learned (shaped like bottom[1])
        return [("bias", tuple(shapes[1]), bf)] if p.bias_term else []
    axis = p.axis if p.axis >= 0 else len(shapes[0]) + p.axis
    shape = (shapes[0][axis:] if p.num_axes == -1
             else shapes[0][axis:axis + p.num_axes])
    f = p.filler if p.has("filler") else FillerParameter(type="constant",
                                                        value=1.0)
    specs = [("scale", tuple(shape), f)]
    if p.bias_term:
        specs.append(("bias", tuple(shape), bf))
    return specs


@register("Scale", params=_scale_params)
def _scale(ctx, lp, params, bottoms):
    """y = x * scale (+ bias), the scale broadcast from `axis` over its
    `num_axes` axes; with two bottoms the scale is bottom[1]."""
    p = lp.scale_param
    x = bottoms[0]
    g = bottoms[1] if len(bottoms) > 1 else params[0]
    bias = None
    if p.bias_term:
        bias = params[0] if len(bottoms) > 1 else params[1]
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    y = x * _broadcast_at(g, axis, x.dim())
    if bias is not None:
        y = y + _broadcast_at(bias, axis, x.dim())
    return [y]


def _broadcast_at(v, axis, ndim):
    """`v` reshaped to broadcast over an ndim tensor from `axis` on."""
    shape = [1] * ndim
    for i, d in enumerate(v.shape):
        shape[axis + i] = d
    return v.reshape(shape)


def _bias_params(lp, shapes):
    p = lp.bias_param
    axis = p.axis if p.axis >= 0 else len(shapes[0]) + p.axis
    shape = (shapes[0][axis:] if p.num_axes == -1
             else shapes[0][axis:axis + p.num_axes])
    f = p.filler if p.has("filler") else FillerParameter(type="constant")
    return [("bias", tuple(shape), f)]


@register("Bias", params=_bias_params)
def _bias(ctx, lp, params, bottoms):
    """y = x + b, b broadcast from `axis`; with two bottoms b is
    bottom[1] (the blob is then not used)."""
    p = lp.bias_param
    x = bottoms[0]
    b = bottoms[1] if len(bottoms) > 1 else params[0]
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    return [x + _broadcast_at(b, axis, x.dim())]


def _parameter_params(lp, shapes):
    shape = tuple(int(d) for d in lp.parameter_param.shape.dim)
    return [("param", shape, FillerParameter(type="constant"))]


@register("Parameter", params=_parameter_params)
def _parameter(ctx, lp, params, bottoms):
    """parameter_layer.hpp: the top is a learnable blob of the given
    shape."""
    return [params[0]]


@register("BatchReindex", index_bottoms=(1,))
def _batch_reindex(ctx, lp, params, bottoms):
    """batch_reindex_layer.cpp: top = bottom[0][bottom[1]] along axis 0
    (the gradient scatter-adds back into the first bottom)."""
    x, idx = bottoms
    return [torch.index_select(x, 0, idx.to(torch.int64).reshape(-1))]


@register("SPP")
def _spp(ctx, lp, params, bottoms):
    """Spatial pyramid pooling (spp_layer.cpp): level i pools into 2^i x
    2^i bins with kernel = stride = ceil(dim / bins) and Caffe's
    symmetric pad (kernel·bins − dim + 1) / 2, through the Pooling layer
    itself; the flattened levels are joined on the channel axis."""
    p = lp.spp_param
    x = bottoms[0]
    n, _, h, w = x.shape
    if not p.has("pyramid_height") or p.pyramid_height < 1:
        raise ValueError("spp_param.pyramid_height must be >= 1")
    if p.pool not in (PoolMethod.MAX, PoolMethod.AVE):
        raise NotImplementedError("SPP: MAX and AVE pooling only")
    outs = []
    for i in range(int(p.pyramid_height)):
        bins = 2 ** i
        kh, kw = -(-h // bins), -(-w // bins)
        pool_lp = LayerParameter(name=f"{lp.name}_level{i}", type="Pooling")
        pp = pool_lp.pooling_param
        pp.pool = p.pool
        pp.kernel_h, pp.kernel_w = kh, kw
        pp.stride_h, pp.stride_w = kh, kw
        pp.pad_h = (kh * bins - h + 1) // 2
        pp.pad_w = (kw * bins - w + 1) // 2
        outs.append(_pooling(ctx, pool_lp, [], [x])[0].reshape(n, -1))
    return [torch.cat(outs, dim=1)]


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------

@register("Flatten")
def _flatten(ctx, lp, params, bottoms):
    p = lp.flatten_param
    x = bottoms[0]
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    end = p.end_axis if p.end_axis >= 0 else x.dim() + p.end_axis
    return [x.reshape(tuple(x.shape[:axis]) + (-1,)
                      + tuple(x.shape[end + 1:]))]


@register("Split")
def _split(ctx, lp, params, bottoms):
    return [bottoms[0] for _ in lp.top]


@register("Concat")
def _concat(ctx, lp, params, bottoms):
    """Bottoms joined along `axis`, or the legacy `concat_dim` when only
    that is set."""
    p = lp.concat_param
    axis = p.axis if p.has("axis") or not p.has("concat_dim") \
        else int(p.concat_dim)
    return [torch.cat(bottoms, dim=axis)]


@register("Reshape")
def _reshape(ctx, lp, params, bottoms):
    """Caffe's Reshape: `shape` replaces the axes [axis, axis +
    num_axes), a 0 copying the bottom's extent and a -1 inferred."""
    p = lp.reshape_param
    x = bottoms[0]
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    end = x.dim() if p.num_axes == -1 else axis + p.num_axes
    mid = [x.shape[axis + i] if d == 0 else int(d)
           for i, d in enumerate(p.shape.dim)]
    return [x.reshape(list(x.shape[:axis]) + mid + list(x.shape[end:]))]


@register("Slice")
def _slice(ctx, lp, params, bottoms):
    p = lp.slice_param
    x = bottoms[0]
    axis = p.axis
    n_top = len(lp.top)
    if p.slice_point:
        points = [0] + [int(q) for q in p.slice_point] + [x.shape[axis]]
    else:
        if x.shape[axis] % n_top != 0:
            raise ValueError(
                f"Slice: axis size {x.shape[axis]} not divisible by "
                f"{n_top} tops (set slice_point explicitly)")
        step = x.shape[axis] // n_top
        points = [i * step for i in range(n_top + 1)]
    return [x.narrow(axis, points[i], points[i + 1] - points[i])
            for i in range(n_top)]


@register("Tile")
def _tile(ctx, lp, params, bottoms):
    p = lp.tile_param
    x = bottoms[0]
    reps = [1] * x.dim()
    reps[p.axis] = int(p.tiles)
    return [x.repeat(reps)]


@register("Reduction")
def _reduction(ctx, lp, params, bottoms):
    """SUM (1), ASUM (2), SUMSQ (3) or MEAN (4) over the axes from
    `axis` on, times `coeff`."""
    p = lp.reduction_param
    x = bottoms[0]
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    flat = x.reshape(tuple(x.shape[:axis]) + (-1,))
    op = p.operation
    if op == 1:
        y = torch.sum(flat, dim=-1)
    elif op == 2:
        y = torch.sum(torch.abs(flat), dim=-1)
    elif op == 3:
        y = torch.sum(flat * flat, dim=-1)
    else:
        y = torch.mean(flat, dim=-1)
    return [weak_scalar(p.coeff, y.dtype) * y]


@register("Crop")
def _crop(ctx, lp, params, bottoms):
    """bottom[0] cut to bottom[1]'s extent on the axes from `axis` on,
    each starting at its offset (the last offset repeats)."""
    p = lp.crop_param
    x, ref = bottoms
    axis = p.axis if p.axis >= 0 else x.dim() + p.axis
    offsets = list(p.offset) or [0]
    for i in range(axis, x.dim()):
        off = offsets[i - axis] if i - axis < len(offsets) else offsets[-1]
        x = x.narrow(i, int(off), ref.shape[i])
    return [x]


@register("Silence")
def _silence(ctx, lp, params, bottoms):
    return []


@register("ArgMax")
def _argmax(ctx, lp, params, bottoms):
    """The top_k indices (as f32) along `axis`, or their values with
    `out_max_val`; without `axis`, over each item, with `out_max_val`
    the (N, 2, k) pairs of indices and values."""
    p = lp.argmax_param
    x = bottoms[0]
    k = int(p.top_k)
    if p.has("axis"):
        axis = p.axis if p.axis >= 0 else x.dim() + p.axis
        vals, idxs = torch.topk(torch.movedim(x, axis, -1), k, dim=-1)
        out = vals if p.out_max_val else idxs.to(torch.float32)
        return [torch.movedim(out, -1, axis)]
    vals, idxs = torch.topk(x.reshape(x.shape[0], -1), k, dim=-1)
    if p.out_max_val:
        return [torch.stack([idxs.to(torch.float32),
                             vals.to(torch.float32)], dim=1)]
    return [idxs.to(torch.float32).reshape(x.shape[0], 1, k)]


# ---------------------------------------------------------------------------
# attention (time-major, like the recurrent layers)
# ---------------------------------------------------------------------------

def _mha_params(lp, shapes):
    ap = lp.attention_param
    d_model = math.prod(shapes[0][2:]) if len(shapes[0]) > 2 else 1
    h = int(ap.num_heads)
    hd = int(ap.head_dim)
    wf = _filler(ap.weight_filler if ap.has("weight_filler") else None,
                 "xavier")
    return [("W_qkv", (3 * h * hd, d_model), wf),
            ("W_o", (d_model, h * hd), wf)]


# the dispatch's meshes, per thread: a training step's mesh never
# reaches a serving thread
_FLASH_STATE = threading.local()


def _mesh_stack() -> list:
    st = _FLASH_STATE
    if not hasattr(st, "meshes"):
        st.meshes = []
    return st.meshes


@contextlib.contextmanager
def flash_mesh(mesh):
    """Route the attention dispatch over `mesh` for the duration (on this
    thread).  When the mesh shards TIME (an sp axis), the attention is
    the differentiable fused ring (parallel.sp), so prototxt-driven
    sequence-parallel training gets ring + flash without hand-rolled
    steps."""
    meshes = _mesh_stack()
    meshes.append(mesh)
    try:
        yield
    finally:
        meshes.pop()


def _attention_dispatch(q, k, v, *, causal: bool, dp_rank: int = 0):
    """Attention on (B, H, T, hd), the counterpart of the JAX dispatch.
    Under `flash_mesh` the call runs on dp rank `dp_rank`'s rows of the
    batch: its tp ranks take one block of H / tp heads each (the whole
    head axis when tp does not divide it), and each block is
      * with an sp axis: the fused ring over that rank's sp ranks,
        `parallel.sp.ring_attention(flash=True)` — K9 forward, K7/K8
        backward on the card, their plain versions on the CPU (T must
        divide over sp: the ring raises otherwise, and the processor
        refuses such a -mesh at startup);
      * otherwise: `FlashAttention` (K6, K7/K8);
    so the kernels launch once per (B/dp, H/tp) block, as the JAX
    package's shard_map runs them per device.  An all_gather joins the
    head blocks.  Without a mesh: `FlashAttention` on the whole tensor.
    One deliberate difference: the JAX route falls back to einsum
    attention when T or the local extent T / sp does not suit the TPU
    kernels' blocks; here the kernels run at any T, so the card never
    runs O(T²) plain attention."""
    meshes = _mesh_stack()
    if not meshes:
        return K.flash_attention(q, k, v, causal)
    mesh = meshes[-1]
    row = mesh.sub(dp=dp_rank) if mesh.shape["dp"] > 1 else mesh
    tp = row.shape["tp"]
    n_tp = tp if tp > 1 and q.shape[1] % tp == 0 else 1
    h = q.shape[1] // n_tp
    outs = []
    for j in range(n_tp):
        blk = row.sub(tp=j) if tp > 1 else row
        dev = blk.devices.flat[0]
        qj, kj, vj = (x[:, j * h:(j + 1) * h].to(dev) for x in (q, k, v))
        if blk.shape["sp"] > 1:
            outs.append(sp.ring_attention(qj, kj, vj, blk, causal=causal,
                                          flash=True))
        else:
            outs.append(K.flash_attention(qj, kj, vj, causal))
    return all_gather(outs, dim=1)


@register("MultiHeadAttention", params=_mha_params)
def _mha(ctx, lp, params, bottoms):
    """Multi-head self-attention on time-major (T, B, D) input: the
    W_qkv projection, attention on (B, H, T, hd) through
    `_attention_dispatch`, the W_o projection.  Without a mesh the
    dispatch takes its single-device branch: the flash kernels for a
    CUDA tensor at any T (they mask their own ragged tail, so no CUDA
    path runs O(T²) plain attention), their plain versions behind the
    same autograd Function for a CPU or meta tensor."""
    ap = lp.attention_param
    x = bottoms[0]
    t_steps, batch = x.shape[0], x.shape[1]
    h, hd = int(ap.num_heads), int(ap.head_dim)
    xf = x.reshape(t_steps, batch, -1)
    qkv = torch.matmul(xf, params[0].T).reshape(t_steps, batch, 3, h, hd)
    # (B, H, T, hd)
    q, k, v = (torch.movedim(qkv[:, :, i], (0, 1, 2), (2, 0, 1))
               for i in range(3))
    o = _attention_dispatch(q, k, v, causal=bool(ap.causal),
                            dp_rank=ctx.rank)
    # back to (T, B, H*hd)
    o = torch.movedim(o, (0, 1, 2), (1, 2, 0)).reshape(t_steps, batch,
                                                       h * hd)
    return [torch.matmul(o, params[1].T)]


# ---------------------------------------------------------------------------
# softmax / loss / metrics
# ---------------------------------------------------------------------------

@register("Softmax")
def _softmax(ctx, lp, params, bottoms):
    return [torch.softmax(bottoms[0], dim=lp.softmax_param.axis)]


def _loss_normalizer(norm_mode, valid_count, batch, full):
    if norm_mode == NormalizationMode.FULL:
        return full
    if norm_mode == NormalizationMode.BATCH_SIZE:
        return batch
    if norm_mode == NormalizationMode.NONE:
        return 1.0
    return torch.clamp_min(valid_count, 1.0) \
        if torch.is_tensor(valid_count) else max(valid_count, 1.0)


def _softmax_loss_terms(lp, scores, labels):
    """(Σ nll, valid count, normalization mode, scores.shape[0], label
    count) of SoftmaxWithLoss: the loss is Σ nll over its normalizer."""
    axis = lp.softmax_param.axis if lp.has("softmax_param") else 1
    logp = torch.log_softmax(scores, dim=axis)
    outer = tuple(scores.shape[:axis])
    inner = tuple(scores.shape[axis + 1:])
    lbl = labels.to(torch.int64).reshape(outer + inner)
    lp_msg = lp.loss_param
    has_ignore = lp.has("loss_param") and lp_msg.has("ignore_label")
    ignore = lp_msg.ignore_label if has_ignore else -1
    safe_lbl = torch.where(lbl == ignore, torch.zeros_like(lbl), lbl) \
        if has_ignore else lbl
    nll = -torch.gather(logp, axis, safe_lbl.unsqueeze(axis)).squeeze(axis)
    full = math.prod(outer + inner)
    if has_ignore:
        mask = (lbl != ignore).to(scores.dtype)
        nll = nll * mask
        valid = torch.sum(mask)
    else:
        valid = float(full)
    # legacy loss_param.normalize: true -> VALID, false -> BATCH_SIZE
    if lp.has("loss_param") and not lp_msg.has("normalization") \
            and lp_msg.has("normalize"):
        norm_mode = (NormalizationMode.VALID if lp_msg.normalize
                     else NormalizationMode.BATCH_SIZE)
    elif lp.has("loss_param"):
        norm_mode = lp_msg.normalization
    else:
        norm_mode = NormalizationMode.VALID
    return torch.sum(nll), valid, norm_mode, scores.shape[0], full


def _global_count(values, mesh):
    """A count summed over dp ranks: tensors all-reduced, floats (counts
    of the ranks' equal slices) added, times the processes."""
    if torch.is_tensor(values[0]):
        return all_reduce(list(values), mesh, "dp")[0]
    return float(sum(values)) * (mesh.procs if mesh is not None else 1)


@register("SoftmaxWithLoss", is_loss=True, index_bottoms=(1,), ranks=True,
          shares=True)
def _softmax_loss(ctx, lp, params, bottoms):
    """Each dp rank's Σ nll over the whole batch's normalizer (VALID:
    the valid counts summed over the ranks), so the ranks' shares sum
    to the loss of the global batch."""
    terms = [_softmax_loss_terms(lp, b[0], b[1]) for b in bottoms]
    norm_mode = terms[0][2]
    valid = _global_count([t[1] for t in terms], ctx.mesh)
    full = sum(t[4] for t in terms) * ctx.procs
    batch = (sum(t[3] for t in terms) * ctx.procs
             if ctx.bottom_axis(0) == 0 else terms[0][3])
    denom = _loss_normalizer(norm_mode, valid, batch, full)
    return [[t[0] / (denom.to(t[0].device) if torch.is_tensor(denom)
                     else denom)] for t in terms]


@register("EuclideanLoss", is_loss=True, batch_mean=True)
def _euclidean_loss(ctx, lp, params, bottoms):
    a, b = bottoms
    diff = a - b
    return [torch.sum(diff * diff) / (2.0 * a.shape[0])]


@register("SigmoidCrossEntropyLoss", is_loss=True, batch_mean=True)
def _sce_loss(ctx, lp, params, bottoms):
    x, t = bottoms
    # stable: max(x, 0) - x·t + log(1 + exp(-|x|))
    loss = (torch.clamp_min(x, 0) - x * t
            + torch.log1p(torch.exp(-torch.abs(x))))
    return [torch.sum(loss) / x.shape[0]]


@register("ContrastiveLoss", is_loss=True, batch_mean=True)
def _contrastive_loss(ctx, lp, params, bottoms):
    """contrastive_loss_layer.cpp: 1/(2N) Σ [y·d² + (1−y)·max(margin −
    d, 0)²], d = ‖a − b‖ over each item's features, y = 1 for a similar
    pair; legacy_version takes max(margin − d², 0) instead."""
    p = lp.contrastive_loss_param
    a, b, y = bottoms
    n = a.shape[0]
    y = y.reshape(n).to(a.dtype)
    diff = (a - b).reshape(n, -1)
    dist_sq = torch.sum(diff * diff, dim=1)
    margin = weak_scalar(p.margin, a.dtype)
    if p.legacy_version:
        mismatch = torch.clamp_min(margin - dist_sq, 0.0)
    else:
        d = torch.sqrt(torch.clamp_min(dist_sq, 1e-12))
        m = torch.clamp_min(margin - d, 0.0)
        mismatch = m * m
    return [torch.sum(y * dist_sq + (1.0 - y) * mismatch) / (2.0 * n)]


@register("HingeLoss", is_loss=True, index_bottoms=(1,), batch_mean=True)
def _hinge_loss(ctx, lp, params, bottoms):
    """Σ max(0, 1 + s·x) / N with s = −1 at each item's label and +1
    elsewhere; squared under norm L2."""
    x, y = bottoms
    n, c = x.shape[0], x.shape[1]
    onehot = F.one_hot(y.to(torch.int64).reshape(n), c).to(x.dtype)
    sign = 1.0 - 2.0 * onehot.reshape((n, c) + (1,) * (x.dim() - 2))
    margin = torch.clamp_min(1.0 + sign * x, 0.0)
    if lp.hinge_loss_param.norm == 2:
        return [torch.sum(margin * margin) / n]
    return [torch.sum(margin) / n]


@register("MultinomialLogisticLoss", is_loss=True, index_bottoms=(1,),
          batch_mean=True)
def _mll_loss(ctx, lp, params, bottoms):
    """−log p[label] on an already softmaxed bottom."""
    probs, labels = bottoms
    n = probs.shape[0]
    lbl = labels.to(torch.int64).reshape(n, 1)
    p = torch.gather(probs.reshape(n, -1), 1, lbl)
    return [-torch.sum(torch.log(torch.clamp_min(p, 1e-20))) / n]


def _infogain_setup(lp, device):
    """The infogain matrix of `infogain_loss_param.source` (a BINARYPROTO
    blob), read once on the net's device, f32 as the JAX package keeps
    it; none when the layer takes it as bottom[2] or has no source."""
    if not (lp.has("infogain_loss_param")
            and lp.infogain_loss_param.source) or len(lp.bottom) > 2:
        return []
    with open(lp.infogain_loss_param.source, "rb") as f:
        bp = BlobProto.from_binary(f.read())
    return [torch.tensor(list(bp.data), dtype=torch.float32, device=device)]


@register("InfogainLoss", is_loss=True, index_bottoms=(1,),
          setup=_infogain_setup, batch_mean=True)
def _infogain_loss(ctx, lp, params, bottoms):
    """−(1/N) Σ_n Σ_k H[label_n, k] · log p_nk.  H is bottom[2], else the
    `source` matrix read where the net was built (`Ctx.consts`), else
    the identity (MultinomialLogisticLoss)."""
    probs, labels = bottoms[0], bottoms[1]
    n = probs.shape[0]
    k = probs.reshape(n, -1).shape[1]
    # read here only when the layer runs outside a Net
    consts = ctx.consts.get(ctx.layer_name) or _infogain_setup(
        lp, probs.device)
    if len(bottoms) > 2:
        h = bottoms[2].reshape(k, k)
    elif consts:
        h = consts[0].to(probs.device).reshape(k, k)
    else:
        h = torch.eye(k, dtype=probs.dtype, device=probs.device)
    lbl = labels.to(torch.int64).reshape(n)
    logp = torch.log(torch.clamp_min(probs.reshape(n, k), 1e-20))
    return [-torch.sum(h[lbl] * logp) / n]


def _accuracy_terms(lp, scores, labels):
    """(correct, mask or None) of Accuracy, in the scores' dtype."""
    p = lp.accuracy_param
    axis = p.axis
    k = int(p.top_k)
    outer = tuple(scores.shape[:axis])
    inner = tuple(scores.shape[axis + 1:])
    lbl = labels.to(torch.int64).reshape(outer + inner)
    has_ignore = lp.has("accuracy_param") and p.has("ignore_label")
    moved = torch.movedim(scores, axis, -1)
    if k == 1:
        correct = torch.argmax(moved, dim=-1) == lbl
    else:
        topi = torch.topk(moved, k, dim=-1).indices
        correct = torch.any(topi == lbl.unsqueeze(-1), dim=-1)
    correct = correct.to(scores.dtype)
    mask = (lbl != p.ignore_label).to(scores.dtype) if has_ignore else None
    return correct, mask


@register("Accuracy", index_bottoms=(1,), ranks=True, shares=True)
def _accuracy(ctx, lp, params, bottoms):
    """Each dp rank's correct count over the whole batch's count (valid
    labels under ignore_label), so the ranks' shares sum to the global
    batch's accuracy."""
    terms = [_accuracy_terms(lp, b[0], b[1]) for b in bottoms]
    if terms[0][1] is None:
        total = sum(c.numel() for c, _ in terms) * ctx.procs
        return [[torch.mean(c) * (c.numel() / total) if c.numel() != total
                 else torch.mean(c)] for c, _ in terms]
    count = torch.clamp_min(_global_count(
        [torch.sum(m) for _, m in terms], ctx.mesh), 1.0)
    return [[torch.sum(c * m) / count.to(c.device)] for c, m in terms]


# ---------------------------------------------------------------------------
# recurrent layers (time-major (T, B, ·), cont-gated: Caffe's
# RecurrentLayer)
# ---------------------------------------------------------------------------

def _lstm_params(lp, shapes):
    rp = lp.recurrent_param
    n = int(rp.num_output)
    d = math.prod(shapes[0][2:]) if len(shapes[0]) > 2 else 1
    wf = _filler(rp.weight_filler if rp.has("weight_filler") else None)
    bf = _filler(rp.bias_filler if rp.has("bias_filler") else None)
    specs = [("W_xc", (4 * n, d), wf), ("b_c", (4 * n,), bf),
             ("W_hc", (4 * n, n), wf)]
    # bottoms: x, cont[, x_static][, h_0, c_0 (expose_hidden)]
    n_state = 2 if rp.expose_hidden else 0
    if len(shapes) - n_state > 2:
        ds = math.prod(shapes[2][1:])
        specs.append(("W_xc_static", (4 * n, ds), wf))
    return specs


def _recurrent_start(x, cont, bottoms, si, n, expose):
    """(x as (T, B, D), cont as (T, B, 1) in x's dtype, h_0, c_0): the
    exposed states from bottoms[si], [si + 1], else zeros made on the
    device (no host-to-device copy, so a CUDA graph captures the
    layer)."""
    t_steps, batch = x.shape[0], x.shape[1]
    xf = x.reshape(t_steps, batch, -1)
    cont_f = cont.reshape(t_steps, batch, 1).to(xf.dtype)
    if expose:
        return (xf, cont_f, bottoms[si].reshape(batch, n).to(xf.dtype),
                bottoms[si + 1].reshape(batch, n).to(xf.dtype))
    zero = xf.new_zeros((batch, n))
    return xf, cont_f, zero, zero


@register("LSTM", params=_lstm_params)
def _lstm(ctx, lp, params, bottoms):
    """Caffe's LSTMLayer: x (T, B, D), cont (T, B) in {0, 1} (an
    integer cont is cast to x's dtype); cont gates both h_{t-1} and
    c_{t-1} (a sequence restart zeroes the state); gate order i, f, o,
    g.  The input projection of all T steps is one (T·B, D) x (D, 4N)
    product (plus the static input's (B, Ds) x (Ds, 4N), broadcast over
    T); each step then does one (B, N) x (N, 4N) product, sigmoid on
    i, f, o and tanh on g in one call each, c = f·c + i·g, h = o·tanh(c).
    The carry is in the compute dtype, as the JAX scan's.

    expose_hidden: the bottoms gain h_0, c_0 ((1, B, N) or (B, N))
    after any static input, the tops h_T, c_T as (1, B, N), for
    chunked sequences and O(T) incremental decoding."""
    rp = lp.recurrent_param
    n = int(rp.num_output)
    expose = bool(rp.expose_hidden)
    has_static = len(params) > 3
    xf, cont_f, h, c = _recurrent_start(
        bottoms[0], bottoms[1], bottoms, 3 if has_static else 2, n, expose)
    t_steps, batch = xf.shape[0], xf.shape[1]
    w_xc, b_c, w_hc = params[0], params[1], params[2]
    xproj = _tp_products(xf.reshape(t_steps * batch, -1), w_xc).reshape(
        t_steps, batch, 4 * n) + b_c
    if has_static:
        xproj = xproj + _tp_products(bottoms[2].reshape(batch, -1),
                                     params[3])
    w_hc_t = w_hc.T
    hs = []
    for t in range(t_steps):
        gates = xproj[t] + torch.matmul(h * cont_f[t], w_hc_t)
        ifo = torch.sigmoid(gates[:, :3 * n])
        g = torch.tanh(gates[:, 3 * n:])
        c = ifo[:, n:2 * n] * (c * cont_f[t]) + ifo[:, :n] * g
        h = ifo[:, 2 * n:] * torch.tanh(c)
        hs.append(h)
    out = torch.stack(hs)
    if expose:
        return [out, h.reshape(1, batch, n), c.reshape(1, batch, n)]
    return [out]


def _rnn_params(lp, shapes):
    rp = lp.recurrent_param
    n = int(rp.num_output)
    d = math.prod(shapes[0][2:]) if len(shapes[0]) > 2 else 1
    wf = _filler(rp.weight_filler if rp.has("weight_filler") else None)
    bf = _filler(rp.bias_filler if rp.has("bias_filler") else None)
    return [("W_xh", (n, d), wf), ("b_h", (n,), bf), ("W_hh", (n, n), wf),
            ("W_ho", (n, n), wf), ("b_o", (n,), bf)]


@register("RNN", params=_rnn_params)
def _rnn(ctx, lp, params, bottoms):
    """Caffe's RNNLayer: h_t = tanh(W_hh (cont_t·h_{t-1}) + W_xh x_t +
    b_h), o_t = tanh(W_ho h_t + b_o); the input projection of all T
    steps in one product."""
    n = int(lp.recurrent_param.num_output)
    xf, cont_f, h, _ = _recurrent_start(bottoms[0], bottoms[1], bottoms, 2,
                                        n, False)
    t_steps, batch = xf.shape[0], xf.shape[1]
    w_xh, b_h, w_hh, w_ho, b_o = params
    xproj = _tp_products(xf.reshape(t_steps * batch, -1), w_xh).reshape(
        t_steps, batch, n) + b_h
    w_hh_t, w_ho_t = w_hh.T, w_ho.T
    outs = []
    for t in range(t_steps):
        h = torch.tanh(xproj[t] + torch.matmul(h * cont_f[t], w_hh_t))
        outs.append(torch.tanh(torch.matmul(h, w_ho_t) + b_o))
    return [torch.stack(outs)]
