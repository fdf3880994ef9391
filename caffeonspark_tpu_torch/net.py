"""Net compiler: NetParameter (+ NetState) -> a PyTorch net.

The counterpart of `caffeonspark_tpu/net.py`.  Construction filters the
layers by phase/stage/level rules, resolves the data-layer inputs, runs
the ReLU->LRN and conv-bias peepholes, and infers every blob's shape by
running the layers on "meta" tensors (no memory, no compute).  Then:

  * ``Net.init(seed)``              -> params {layer: {blob: tensor}}
  * ``Net(params, inputs)``         -> {blob: tensor} (the forward;
    ``train=True`` with a generator gives Caffe's TRAIN semantics)
  * ``Net.loss(params, inputs)``    -> (weighted loss, blobs), the
    scalar the solver differentiates with autograd
  * ``Net.forward_ranks`` / ``Net.loss_ranks`` -> the same for dp ranks,
    each on its slice of the batch, layer by layer across the ranks
    (parallel/dp.py), and ``Net.join_ranks`` -> their global blobs

Both take a `state_out` dict that collects the forward state: the new
running statistics of each BatchNorm at TRAIN, which
`merge_forward_state` copies into the params in place, and the bottoms
of each HDF5Output under "hdf5_output:<layer>" (data/hdf5.py
`collect_hdf5_outputs`), which it skips.

Mixed precision (`compute_dtype`, JAX net.py:272-284, :699-750): params
stay in `dtype` while each layer casts its floating params and bottoms
to `compute_dtype`, so the gradients come back in `dtype` through
autograd of the cast.  One departure from the reference: a bottom that
a layer reads as an index (`LayerOp.index_bottoms`: Embed's ids, the
losses' and Accuracy's labels) is never cast, since bf16 rounds integers
above 256 (the JAX package sends id 257 to row 256); `index_inputs`
names the net inputs that reach such a bottom, which a caller feeding
bf16 batches keeps in their own dtype.

Parameters live outside the module, keyed `{layer: {blob: tensor}}` as
in the JAX package, so a serving registry can swap versions under one
net and the solver can update them in place.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .ops import layers as L
from .parallel.comm import Shards, all_gather_dp, process_sum
from .proto.caffe import (LayerParameter, NetParameter, NetState,
                          NetStateRule, NormRegion, Phase, TopBlobType)

Params = Dict[str, Dict[str, torch.Tensor]]


def _cast(p, dtype):
    """A param blob (or its tp blocks) in `dtype`."""
    if isinstance(p, Shards):
        return p.map(lambda t: t.to(dtype))
    return p.to(dtype)


def state_meets_rule(rule: NetStateRule, state: NetState) -> bool:
    if rule.has("phase") and rule.phase != state.phase:
        return False
    if rule.has("min_level") and state.level < rule.min_level:
        return False
    if rule.has("max_level") and state.level > rule.max_level:
        return False
    stages = set(state.stage)
    for s in rule.stage:
        if s not in stages:
            return False
    for s in rule.not_stage:
        if s in stages:
            return False
    return True


def layer_included(lp: LayerParameter, state: NetState) -> bool:
    if lp.include:
        return any(state_meets_rule(r, state) for r in lp.include)
    if lp.exclude:
        return not any(state_meets_rule(r, state) for r in lp.exclude)
    return True


def _peek_db_dims(lp: LayerParameter) -> Tuple[int, int, int]:
    """First-record (C, H, W) of a Data layer's LMDB or LevelDB database;
    (3, 0, 0) when the database is not readable at graph-build time (a
    deploy net parsed away from its data), as in the JAX package."""
    from .data.source import _strip_scheme, first_datum_dims, open_db
    try:
        with open_db(_strip_scheme(lp.data_param.source),
                     lp.data_param.backend) as r:
            dims = first_datum_dims(r)
    except (OSError, ValueError):
        dims = None
    return dims or (3, 0, 0)


def _cos_top_shape(top, batch: int) -> Tuple[int, ...]:
    """Shape of one CoSData top (cos_data_layer.cpp:10-47 semantics)."""
    if top.transpose:
        # time-major (T, B) layout for sequence inputs
        return (int(top.channels), batch)
    axes = top.sample_num_axes
    t = top.type
    if t in (TopBlobType.ENCODED_IMAGE_WITH_DIM, TopBlobType.ENCODED_IMAGE,
             TopBlobType.RAW_IMAGE):
        c = int(top.out_channels or top.channels)
        h = int(top.out_height or top.height)
        w = int(top.out_width or top.width)
        if top.transform_param.crop_size:
            h = w = int(top.transform_param.crop_size)
        return (batch, c, h, w)
    if axes == 1:
        return (batch, int(top.channels))
    if axes == 0:
        return (batch,)
    return (batch, int(top.channels), int(top.height), int(top.width))


def data_layer_input_specs(lp: LayerParameter
                           ) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(blob_name, shape, kind) for each top of a data layer; kind is
    'data', 'label' or 'int' (integer-valued CoSData tops), with ':T'
    appended for a time-major (T, B) top.  A `Data` layer's geometry
    comes from its database's first record, as Caffe's DataLayer sizes
    its tops."""
    t = lp.type
    if t == "MemoryData":
        p = lp.memory_data_param
        b = int(p.batch_size)
        shape = (b, int(p.channels), int(p.height), int(p.width))
        if lp.transform_param.crop_size:
            cs = int(lp.transform_param.crop_size)
            shape = (b, int(p.channels), cs, cs)
        specs = [(lp.top[0], shape, "data")]
        if len(lp.top) > 1:
            specs.append((lp.top[1], (b,), "label"))
        return specs
    if t == "CoSData":
        p = lp.cos_data_param
        b = int(p.batch_size)
        return [(top.name, _cos_top_shape(top, b),
                 ("int" if top.type in (TopBlobType.INT,
                                        TopBlobType.INT_ARRAY) else "data")
                 + (":T" if top.transpose else ""))
                for top in p.top]
    if t == "Input":
        shapes = list(lp.input_param.shape)
        if len(shapes) == 1 and len(lp.top) > 1:
            shapes = shapes * len(lp.top)
        if len(shapes) != len(lp.top):
            raise ValueError(f"Input layer {lp.name!r}: {len(shapes)} "
                             f"shapes for {len(lp.top)} tops")
        return [(name, tuple(int(d) for d in shp.dim), "data")
                for name, shp in zip(lp.top, shapes)]
    if t == "Data":
        p = lp.data_param
        b = int(p.batch_size)
        cs = int(p.crop_size or lp.transform_param.crop_size or 0)
        c, h, w = _peek_db_dims(lp)
        if cs:
            h = w = cs
        specs = [(lp.top[0], (b, c, h or 1, w or 1), "data")]
        if len(lp.top) > 1:
            specs.append((lp.top[1], (b,), "label"))
        return specs
    if t == "HDF5Data":
        # hdf5_data_layer.cpp sizes the tops from the first listed file:
        # probed when the list is readable, else shapeless
        p = lp.hdf5_data_param
        if p.source and os.path.exists(p.source):
            from .data.hdf5 import hdf5_top_shapes
            shapes = hdf5_top_shapes(p.source, list(lp.top),
                                     int(p.batch_size))
            return [(name, shapes[name],
                     "label" if name == "label" else "data")
                    for name in lp.top]
        return [(name, (), "data") for name in lp.top]
    if t == "ImageData":
        # image_data_layer.cpp: a (path label) list; the tops' shapes
        # need new_height / new_width or a crop
        p = lp.image_data_param
        b = int(p.batch_size)
        c = 3 if p.is_color else 1
        cs = int(lp.transform_param.crop_size or 0)
        h = cs or int(p.new_height)
        w = cs or int(p.new_width)
        if not h or not w:
            raise ValueError(
                f"ImageData layer {lp.name!r}: set new_height/new_width "
                "(or transform_param.crop_size): static shapes required")
        specs = [(lp.top[0], (b, c, h, w), "data")]
        if len(lp.top) > 1:
            specs.append((lp.top[1], (b,), "label"))
        return specs
    if t == "DummyData":
        # a shape only: the caller supplies the inputs, as in the JAX
        # package (no filler)
        p = lp.dummy_data_param
        out = []
        for i, name in enumerate(lp.top):
            if p.shape:
                shp = p.shape[min(i, len(p.shape) - 1)]
                out.append((name, tuple(int(d) for d in shp.dim), "data"))
            else:
                idx = min(i, len(p.num) - 1) if p.num else 0
                out.append((name, (int(p.num[idx]), int(p.channels[idx]),
                                   int(p.height[idx]), int(p.width[idx])),
                            "data"))
        return out
    raise NotImplementedError(f"data layer {t} not in the PyTorch port")


def fusable_relu_for_lrn(layers: Sequence[LayerParameter],
                         lrn_lp: LayerParameter
                         ) -> Optional[LayerParameter]:
    """The ReLU layer the ReLU->LRN peephole would absorb into `lrn_lp`,
    or None.  Eligible: `lrn_lp` is a 1-bottom ACROSS_CHANNELS LRN whose
    bottom's last producer is a plain ReLU (negative_slope 0, no loss
    weight, 1 bottom / 1 top) consumed by nothing but the LRN."""
    if (lrn_lp.type != "LRN" or len(lrn_lp.bottom) != 1
            or lrn_lp.lrn_param.norm_region
            != NormRegion.ACROSS_CHANNELS):
        return None
    prod, pi = None, -1
    found = False
    for j, l2 in enumerate(layers):
        if l2 is lrn_lp:
            found = True
            break
        if lrn_lp.bottom[0] in l2.top:
            prod, pi = l2, j
    if not found or prod is None or prod.type != "ReLU":
        return None
    if len(prod.bottom) != 1 or len(prod.top) != 1:
        return None
    if float(getattr(prod.relu_param, "negative_slope", 0.0) or 0.0):
        return None
    if any(float(w) for w in prod.loss_weight):
        return None
    consumers = [l2 for j, l2 in enumerate(layers)
                 if j > pi and prod.top[0] in l2.bottom]
    if consumers != [lrn_lp]:
        return None
    return prod


def prefuse_conv_bias_eligible(layers: Sequence[LayerParameter],
                               lrn_lp: LayerParameter,
                               relu_lp: LayerParameter) -> bool:
    """Would the conv feeding `relu_lp` get its bias deferred into
    `lrn_lp` once the relu is fused away?  True when that producer is a
    bias_term Convolution whose top feeds nothing but the relu chain
    (for an in-place relu the LRN also reads the name)."""
    conv, ci = None, -1
    for j, l2 in enumerate(layers):
        if l2 is relu_lp:
            break
        if relu_lp.bottom[0] in l2.top:
            conv, ci = l2, j
    if (conv is None or conv.type != "Convolution"
            or not conv.convolution_param.bias_term):
        return False
    others = [l2 for j, l2 in enumerate(layers)
              if j > ci and conv.top[0] in l2.bottom
              and l2 is not relu_lp]
    return others in ([], [lrn_lp])


class Net(nn.Module):
    """A phase-filtered network; `forward(params, inputs)` runs it.

    Peepholes, read once here from the environment:
      * COS_FUSE_RELU_LRN=1 — a ReLU feeding an across-channel LRN runs
        inside the LRN kernel (K1 with fuse_relu); the ReLU's top is then
        not materialized;
      * COS_FUSE_BIAS_RELU_LRN=1 — the above, and the producing conv's
        bias add joins too (K3): the conv emits its raw output and the
        LRN receives the conv's bias as params[0].  The conv's top then
        holds UNBIASED activations, so do not extract features from it.
    """

    def __init__(self, net_param: NetParameter,
                 state: Optional[NetState] = None,
                 dtype=torch.float32, device="cuda", compute_dtype=None):
        super().__init__()
        self.net_param = net_param
        self.state = state or NetState(phase=Phase.TRAIN)
        self.name = net_param.name
        self.dtype = dtype
        # params stay `dtype`; each layer computes in `compute_dtype`
        self.compute_dtype = compute_dtype or dtype
        self.device = torch.device(device)
        self.layers: List[LayerParameter] = [
            lp for lp in net_param.layer if layer_included(lp, self.state)]

        # --- net inputs ----------------------------------------------------
        self.input_specs: List[Tuple[str, Tuple[int, ...], str]] = []
        if net_param.input:     # legacy net-level inputs (deploy prototxts)
            for i, name in enumerate(net_param.input):
                if net_param.input_shape:
                    shp = tuple(int(d)
                                for d in net_param.input_shape[i].dim)
                else:
                    shp = tuple(int(d)
                                for d in net_param.input_dim[4 * i:4 * i + 4])
                self.input_specs.append((name, shp, "data"))
        for lp in self.layers:
            if L.get_op(lp.type).is_data:
                self.input_specs.extend(data_layer_input_specs(lp))
        self.compute_layers = [lp for lp in self.layers
                               if not L.get_op(lp.type).is_data]

        # --- ReLU->LRN and conv-bias peepholes ----------------------------
        self.fused_relu_lrn: frozenset = frozenset()
        self.fused_bias_lrn: Dict[str, str] = {}      # lrn -> conv
        env_relu = os.environ.get("COS_FUSE_RELU_LRN") == "1"
        env_bias = os.environ.get("COS_FUSE_BIAS_RELU_LRN") == "1"
        if env_relu or env_bias:
            fused: set = set()
            self.compute_layers = self._fuse_relu_lrn(self.compute_layers,
                                                      fused)
            self.fused_relu_lrn = frozenset(fused)
            if env_bias:
                self.fused_bias_lrn = self._fuse_conv_bias()
        self._bias_lrn_set = frozenset(self.fused_bias_lrn)
        self._defer_bias = frozenset(self.fused_bias_lrn.values())
        # constants read once here, never inside a step (LayerOp.setup)
        self.layer_consts: Dict[str, List[torch.Tensor]] = {}
        for lp in self.compute_layers:
            setup = L.get_op(lp.type).setup
            if setup is not None:
                consts = setup(lp, self.device)
                if consts:
                    self.layer_consts[lp.name] = consts

        # --- shape inference on meta tensors + param layout ---------------
        self.param_layout: Dict[str, List[Tuple[str, Tuple[int, ...],
                                                object]]] = {}
        self.blob_shapes = self._infer_shapes(
            {name: tuple(shape) for name, shape, _ in self.input_specs},
            layout=self.param_layout)
        self._batch_axes: Optional[Dict[str, Optional[int]]] = None

        # --- net outputs: tops never consumed ------------------------------
        consumed = {b for lp in self.compute_layers for b in lp.bottom}
        produced: List[str] = [n for n, _, _ in self.input_specs]
        for lp in self.compute_layers:
            for t in lp.top:
                if t not in produced:
                    produced.append(t)
        self.output_blobs = [n for n in produced if n not in consumed]
        # loss weight per top: loss_weight when given, else 1 for a loss
        # layer's tops and 0 for the rest (JAX net.py:467-478)
        self.loss_weights: Dict[str, float] = {}
        for lp in self.compute_layers:
            op = L.get_op(lp.type)
            for i, t in enumerate(lp.top):
                if i < len(lp.loss_weight):
                    w = float(lp.loss_weight[i])
                else:
                    w = 1.0 if op.is_loss else 0.0
                if w:
                    self.loss_weights[t] = w
        self.index_inputs = self._index_inputs()

    def _infer_shapes(self, blob_shapes: Dict[str, Tuple[int, ...]],
                      layout: Optional[Dict] = None
                      ) -> Dict[str, Tuple[int, ...]]:
        """Every blob's shape from the inputs' (`blob_shapes`, extended
        in place), by running the layers on meta tensors; `layout`, when
        given, receives the param layout."""
        dtype = self.dtype
        for lp in self.compute_layers:
            op = L.get_op(lp.type)
            for b in lp.bottom:
                if b not in blob_shapes:
                    raise ValueError(
                        f"layer {lp.name!r} ({lp.type}) consumes unknown "
                        f"blob {b!r}; produced so far: "
                        f"{sorted(blob_shapes)}")
            bshapes = [blob_shapes[b] for b in lp.bottom]
            specs = [(n, tuple(int(x) for x in s), f)
                     for (n, s, f) in op.param_specs(lp, bshapes)]
            if specs and layout is not None:
                layout[lp.name] = specs
            meta = [torch.empty(s, dtype=dtype, device="meta")
                    for (_, s, _) in specs]
            if lp.name in self.fused_bias_lrn:
                conv = self.fused_bias_lrn[lp.name]
                bshape = next(s for (n2, s, _) in self.param_layout[conv]
                              if n2 == "bias")
                meta = [torch.empty(bshape, dtype=dtype,
                                    device="meta")] + meta
            bottoms = [torch.empty(s, dtype=dtype, device="meta")
                       for s in bshapes]
            ctx = self._ctx()
            ctx.layer_name = lp.name
            for name, top in zip(lp.top, op.apply(ctx, lp, meta, bottoms)):
                blob_shapes[name] = tuple(top.shape)
        return blob_shapes

    def input_batch_axes(self) -> Dict[str, int]:
        """The batch axis of each net input: 1 for a time-major (T, B, ·)
        input, else 0.  The one rule of where dp splits an input."""
        return {name: 1 if kind.endswith(":T") else 0
                for name, _, kind in self.input_specs}

    def batch_axes(self) -> Dict[str, Optional[int]]:
        """The batch axis of every blob (None: the blob does not grow
        with the batch, a loss or a parameter-like top), found once by a
        second meta pass at twice the inputs' batch (axis 1 of a
        time-major input).  A layer that reduces over the batch without
        seeing every dp rank (`LayerOp.apply_ranks`) is refused here, by
        name: its dp ranks would each reduce a slice."""
        if self._batch_axes is not None:
            return self._batch_axes
        doubled = {}
        in_axes = self.input_batch_axes()
        for name, shape, _ in self.input_specs:
            ax = in_axes[name]
            shape = tuple(shape)
            if len(shape) > ax:
                shape = shape[:ax] + (2 * shape[ax],) + shape[ax + 1:]
            doubled[name] = shape
        try:
            twice = self._infer_shapes(doubled)
        except (RuntimeError, ValueError) as e:
            raise ValueError(f"net {self.name!r}: its blobs' shapes do not "
                             f"follow the batch, so dp cannot split it "
                             f"({e})") from e
        axes: Dict[str, Optional[int]] = {}
        for name, one in self.blob_shapes.items():
            two = twice.get(name, one)
            diff = [i for i, (a, b) in enumerate(zip(one, two)) if a != b]
            axes[name] = (diff[0] if len(one) == len(two) and len(diff) == 1
                          and two[diff[0]] == 2 * one[diff[0]] else None)
            if len(one) != len(two) or len(diff) > 1:
                raise ValueError(f"net {self.name!r}: blob {name!r} is "
                                 f"{one} at the batch and {two} at twice "
                                 "it: dp cannot split it")
        for lp in self.compute_layers:
            op = L.get_op(lp.type)
            if op.apply_ranks is not None or op.shares:
                continue
            if any(axes.get(b) is not None for b in lp.bottom) and \
                    any(axes.get(t) is None for t in lp.top):
                raise ValueError(
                    f"layer {lp.name!r} ({lp.type}) reduces over the batch: "
                    "the port splits no such layer over dp ranks")
        self._batch_axes = axes
        return axes

    def _index_inputs(self) -> frozenset:
        """Net inputs that reach a layer's index bottom, directly or
        through Split / Flatten."""
        passthrough = {t: lp.bottom[0] for lp in self.compute_layers
                       if lp.type in ("Split", "Flatten")
                       for t in lp.top}
        inputs = {n for n, _, _ in self.input_specs}
        out = set()
        for lp in self.compute_layers:
            for i in L.get_op(lp.type).index_bottoms:
                if i >= len(lp.bottom):
                    continue
                b = lp.bottom[i]
                while b not in inputs and b in passthrough:
                    b = passthrough[b]
                if b in inputs:
                    out.add(b)
        return frozenset(out)

    # ------------------------------------------------------------------
    def _fuse_relu_lrn(self, layers: List[LayerParameter], fused: set
                       ) -> List[LayerParameter]:
        """Replace eligible [ReLU, LRN] pairs with one LRN layer whose op
        applies relu in-kernel.  The LRN entry is a copy (the source
        NetParameter may build other Nets)."""
        out: List[LayerParameter] = list(layers)
        i = 0
        while i < len(out):
            nl = out[i]
            r = fusable_relu_for_lrn(out, nl) if nl.type == "LRN" else None
            if r is None:
                i += 1
                continue
            fused_lp = LayerParameter.from_binary(nl.to_binary())
            fused_lp.bottom = [r.bottom[0]]
            out[i] = fused_lp
            del out[next(j for j, l2 in enumerate(out) if l2 is r)]
            fused.add(nl.name)
        return out

    def _fuse_conv_bias(self) -> Dict[str, str]:
        """For relu-fused LRNs whose bottom is a bias_term Convolution's
        top that no other layer consumes, defer the conv's bias add into
        the LRN kernel.  Returns {lrn_name: conv_name}."""
        out: Dict[str, str] = {}
        by_top: Dict[str, LayerParameter] = {}
        for lp in self.compute_layers:
            for t in lp.top:
                by_top[t] = lp
        for lp in self.compute_layers:
            if lp.name not in self.fused_relu_lrn:
                continue
            src = by_top.get(lp.bottom[0])
            if (src is None or src.type != "Convolution"
                    or not src.convolution_param.bias_term):
                continue
            if any(o is not lp and src.top[0] in o.bottom
                   for o in self.compute_layers):
                continue     # someone else needs the biased activation
            out[lp.name] = src.name
        return out

    def _ctx(self, qscales=None, train: bool = False,
             generator: Optional[torch.Generator] = None) -> L.Ctx:
        return L.Ctx(train=train, generator=generator,
                     fused_relu_lrn=self.fused_relu_lrn,
                     defer_bias=self._defer_bias,
                     bias_lrn=self._bias_lrn_set, qscales=qscales,
                     consts=self.layer_consts)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0,
             layers: Optional[Sequence[str]] = None) -> Params:
        """Filler-initialized params on `self.device` (of `layers` only,
        when given).  Each blob draws from its own CPU generator seeded
        by (seed, layer name, blob index), so adding a layer never
        shifts another's weights."""
        from .ops.fillers import fill
        params: Params = {}
        for lname, specs in self.param_layout.items():
            if layers is not None and lname not in layers:
                continue
            blobs = {}
            for i, (bname, shape, filler) in enumerate(specs):
                g = torch.Generator().manual_seed(
                    (seed * 1_000_003 + L.stable_hash(lname) * 31 + i)
                    % (2 ** 63))
                blobs[bname] = fill(g, filler, shape, self.dtype,
                                    self.device)
            params[lname] = blobs
        return params

    def num_params(self) -> int:
        return sum(math.prod(s) for specs in self.param_layout.values()
                   for (_, s, _) in specs)

    # ------------------------------------------------------------------
    def forward(self, params: Params, inputs: Dict[str, torch.Tensor], *,
                qscales: Optional[Dict] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                state_out: Optional[Dict] = None
                ) -> Dict[str, torch.Tensor]:
        """Forward pass; returns every blob.  Caffe's TEST-phase layer
        semantics unless `train`, whatever the net's phase; at TRAIN,
        Dropout draws from `generator` (on the net's device).  `qscales`
        ({layer: {blob: f32 0-dim tensor}}) carries the publish-time
        scales of int8 serving weights (serving/quant.py), which the int8
        InnerProduct kernel consumes without dequantizing.  `state_out`,
        when given, receives the forward state ({layer: [tensors]}, see
        `merge_forward_state`)."""
        return self.forward_ranks([params], [inputs], qscales=qscales,
                                  train=train, generator=generator,
                                  state_out=state_out)[0]

    def forward_ranks(self, rank_params: Sequence[Params],
                      rank_inputs: Sequence[Dict[str, torch.Tensor]], *,
                      qscales: Optional[Dict] = None, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      state_out: Optional[Dict] = None, mesh=None,
                      before_layer=None
                      ) -> List[Dict[str, torch.Tensor]]:
        """The forward of dp ranks, each on its slice of the batch with
        params of its own (a rank's blob may be a tp-split
        `parallel.comm.Shards`): every blob of every rank.  Layer by
        layer, each layer runs for every rank before the next, so that
        a layer whose result couples the batch sees all of them at once
        (`LayerOp.apply_ranks`: BatchNorm's statistics, the losses'
        normalizers, Accuracy), and a random draw is the whole batch's,
        sliced (`Ctx.rand`); dp N then computes what dp 1 does on the
        global batch.  `mesh` (its dp axis one rank per entry) carries
        the reductions between ranks; one rank needs none, unless its
        dp axis spans processes (the ranks of the other processes are
        then its peers: `Mesh.spans`).
        `before_layer(name)`, when given, is called before each layer
        reads its params from `rank_params` (the gradient exchange's
        hooks: `parallel.gradsync.BucketHooks`)."""
        n = len(rank_inputs)
        blobs = [dict(x) for x in rank_inputs]
        ctx = self._ctx(qscales, train, generator)
        ctx.ranks = n
        if state_out is not None:
            ctx.state_out = state_out
        axes: Dict[str, Optional[int]] = {}
        if n > 1 or (mesh is not None and mesh.spans):
            if mesh is None:
                raise ValueError(f"{n} dp ranks need their mesh (the "
                                 "reductions between them run over it)")
            axes = self.batch_axes()
            ctx.mesh = mesh
            ctx.procs = mesh.dp_blocks
            ctx.rank_offset = mesh.dp_offset
        cast = self.compute_dtype != self.dtype
        for lp in self.compute_layers:
            op = L.get_op(lp.type)
            ctx.layer_name = lp.name
            ctx.bottom_axes = tuple(axes.get(b) for b in lp.bottom)
            if before_layer is not None:
                before_layer(lp.name)
            lparams = [self._layer_params(lp, p) for p in rank_params]
            bottoms = [[b[x] for x in lp.bottom] for b in blobs]
            if cast:
                # stat layers keep the net's dtype (JAX net.py:708-748);
                # int8 serving weights and index bottoms pass untouched
                target = self.dtype if op.f32_stats else self.compute_dtype
                lparams = [[_cast(p, target) if p.is_floating_point() else p
                            for p in lps] for lps in lparams]
                bottoms = [[b.to(target)
                            if b.is_floating_point() and b.dtype != target
                            and i not in op.index_bottoms else b
                            for i, b in enumerate(bs)] for bs in bottoms]
            tops = op.run(ctx, lp, lparams, bottoms)
            for b, ts in zip(blobs, tops):
                for name, val in zip(lp.top, ts):
                    b[name] = val
        return blobs

    def _layer_params(self, lp: LayerParameter, params: Params) -> list:
        """The param blobs a layer's op takes, in its blob order (a
        bias-fused LRN takes its conv's bias first)."""
        lparams = []
        if lp.name in self.param_layout:
            pd = params[lp.name]
            lparams = [pd[bname] for bname, _, _ in self.param_layout[lp.name]]
        if lp.name in self.fused_bias_lrn:
            lparams = [params[self.fused_bias_lrn[lp.name]]["bias"]] \
                + lparams
        return lparams

    def join_ranks(self, rank_blobs: Sequence[Dict[str, torch.Tensor]],
                   names: Sequence[str], mesh=None
                   ) -> Dict[str, torch.Tensor]:
        """The global value of each named blob from the dp ranks': joined
        on its batch axis (an all_gather), the sum of the ranks' shares
        for a loss or an accuracy (`LayerOp.shares`), else rank 0's;
        over the processes `mesh`'s dp axis spans too, when it does."""
        spans = mesh is not None and mesh.spans
        if len(rank_blobs) == 1 and not spans:
            return {n: rank_blobs[0][n] for n in names}
        axes = self.batch_axes()
        shared = {t for lp in self.compute_layers
                  if L.get_op(lp.type).shares for t in lp.top}
        out = {}
        for n in names:
            vals = [b[n] for b in rank_blobs]
            if axes.get(n) is not None:
                out[n] = all_gather_dp(vals, axes[n], mesh)
            elif n in shared:
                total = vals[0]
                for v in vals[1:]:
                    total = total + v.to(total.device)
                out[n] = process_sum(total, mesh)
            else:
                out[n] = vals[0]
        return out

    def loss(self, params: Params, inputs: Dict[str, torch.Tensor], *,
             train: bool = True,
             generator: Optional[torch.Generator] = None,
             state_out: Optional[Dict] = None, before_layer=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total weighted loss, every blob): each loss top summed in f32
        and weighted, as the JAX package's `Net.loss` (the loss blobs keep
        the compute dtype).  `state_out` as in `forward`, `before_layer`
        as in `forward_ranks`."""
        total, blobs = self.loss_ranks([params], [inputs], train=train,
                                       generator=generator,
                                       state_out=state_out,
                                       before_layer=before_layer)
        return total, blobs[0]

    def loss_ranks(self, rank_params: Sequence[Params],
                   rank_inputs: Sequence[Dict[str, torch.Tensor]], *,
                   train: bool = True,
                   generator: Optional[torch.Generator] = None,
                   state_out: Optional[Dict] = None, mesh=None,
                   before_layer=None
                   ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """`loss` of dp ranks (`forward_ranks`): the ranks' loss tops are
        shares of the global batch's loss, so their weighted sum is its
        loss, on the net's device."""
        blobs = self.forward_ranks(rank_params, rank_inputs, train=train,
                                   generator=generator, state_out=state_out,
                                   mesh=mesh, before_layer=before_layer)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for b in blobs:
            for name, w in self.loss_weights.items():
                total = total + w * torch.sum(
                    b[name], dtype=torch.float32).to(self.device)
        return total, blobs

    @torch.no_grad()
    def merge_forward_state(self, params: Params,
                            forward_state: Dict[str, List[torch.Tensor]]
                            ) -> None:
        """Copy the forward state (BatchNorm's new running statistics)
        into the param tensors in place, in each blob's dtype: params
        are the static buffers of a CUDA graph (solver.GraphedSteps), so
        they are written, never rebound (JAX net.py:783-794 returns new
        params instead)."""
        for lname, values in forward_state.items():
            if lname not in self.param_layout:
                continue    # side-channel keys (HDF5Output's bottoms)
            for (bname, _, _), v in zip(self.param_layout[lname], values):
                params[lname][bname].copy_(v)

    def stat_param_layers(self) -> List[str]:
        """Layers whose param blobs are running statistics, updated by
        the forward pass and never by the solver (BatchNorm)."""
        return [lp.name for lp in self.compute_layers
                if L.get_op(lp.type).f32_stats]
