"""Host transformer: Caffe `transform_param` semantics, TRAIN and TEST,
and its split into a host stage and a device stage.

A copy of `caffeonspark_tpu/data/transformer.py` (Caffe's
DataTransformer): random crop and mirror at TRAIN, center crop at TEST,
mean subtraction (mean_file or mean_value), scale.  `__call__` runs the
whole transform on numpy batches on the host.  With the device-side
transform (COS_DEVICE_TRANSFORM=1, see `DataSource.enable_device_transform`)
the host keeps only the byte moves (`host_stage`: crop and mirror on
uint8 in the native library's threads, or numpy under COS_NATIVE=0,
with the crop offsets and flips as an (N, 3) aux array) and
`device_stage_fn` does the float work with plain torch ops on the
batch's device, so the host-to-device copy carries 1 byte a pixel.

The random draws come from one `np.random.RandomState(seed & 0x7FFFFFFF)`
per transformer, in the JAX transformer's order (per batch: the crop
offsets of every sample, then the mirror flags), so for the same seed
both packages produce the same augmented batches.  `draw` takes them
under a lock, and `__call__` / `host_stage` take a pre-drawn `AugDraw`:
the transformer pool draws in feed order on one thread and packs on
several.

Order of operations (data_transformer.cpp):
  1. crop (random at TRAIN, center at TEST);
  2. mean_file subtraction at the SOURCE pixel (before the crop) when the
     mean has the input's size, else after the crop;
  3. mirror (random horizontal flip at TRAIN);
  4. mean_value per-channel subtraction (commutes with the flip);
  5. scale multiplication.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..proto.caffe import BlobProto, TransformationParameter

# batch-dict key suffix of the (N, 3) int32 [h_off, w_off, flip] aux
# array of the device-side transform (Transformer.host_stage)
DEVICE_AUX_SUFFIX = "__devxf"


class AugDraw(NamedTuple):
    """One batch's augmentation: per-sample crop offsets (hs, ws), or
    None when no crop applies, and the per-sample mirror flags."""
    offs: Optional[Tuple[np.ndarray, np.ndarray]]
    flip: np.ndarray


def load_mean_file(path: str) -> np.ndarray:
    """mean.binaryproto -> (C, H, W) float32."""
    with open(path, "rb") as f:
        bp = BlobProto.from_binary(f.read())
    if bp.shape.dim:
        shape = tuple(int(d) for d in bp.shape.dim)
    else:
        shape = (int(bp.channels), int(bp.height), int(bp.width))
    arr = np.asarray(bp.data, np.float32).reshape(shape)
    if arr.ndim == 4:
        arr = arr[0]
    return arr


class Transformer:
    """Batched NCHW transformer with one random stream per instance."""

    def __init__(self, tp: Optional[TransformationParameter], *,
                 phase_train: bool = False, seed: int = 0,
                 mean_dir: Optional[str] = None):
        self.tp = tp or TransformationParameter()
        self.train = phase_train
        self.rng = np.random.RandomState(seed & 0x7FFFFFFF)
        # a RandomState is not safe under concurrent draws: the pool's
        # dispatcher and inline callers draw under this lock
        self._rng_lock = threading.Lock()
        self.mean: Optional[np.ndarray] = None
        if self.tp.has("mean_file") and self.tp.mean_file:
            p = self.tp.mean_file
            if mean_dir is not None and not os.path.isabs(p):
                p = os.path.join(mean_dir, p)
            self.mean = load_mean_file(p)
        if self.tp.mean_value and self.mean is not None:
            raise ValueError("specify either mean_file or mean_value, "
                             "not both")

    def _draw_crop(self, n: int, h: int, w: int):
        """Per-sample crop offsets, or None when no crop applies; draws
        from self.rng only at TRAIN with an active crop."""
        crop = int(self.tp.crop_size)
        if not (crop and (crop != h or crop != w)):
            return None
        if crop > h or crop > w:
            raise ValueError(f"crop_size {crop} exceeds input {h}x{w}")
        if self.train:
            hs = self.rng.randint(0, h - crop + 1, size=n)
            ws = self.rng.randint(0, w - crop + 1, size=n)
        else:
            hs = np.full(n, (h - crop) // 2)
            ws = np.full(n, (w - crop) // 2)
        return hs, ws

    def _draw_flip(self, n: int) -> np.ndarray:
        """Per-sample mirror flags (TRAIN with mirror), else all False."""
        if self.tp.mirror and self.train:
            return self.rng.randint(0, 2, size=n).astype(bool)
        return np.zeros(n, bool)

    def draw(self, n: int, h: int, w: int) -> AugDraw:
        """Consume the random stream for one n-sample batch: crop offsets,
        then mirror flags (under the lock)."""
        with self._rng_lock:
            offs = self._draw_crop(n, h, w)
            return AugDraw(offs, self._draw_flip(n))

    def __call__(self, batch: np.ndarray,
                 draw: Optional[AugDraw] = None) -> np.ndarray:
        """batch: (N, C, H, W) float32 (raw 0..255 pixel scale); `draw`
        replays a pre-drawn augmentation instead of drawing here."""
        tp = self.tp
        n, c, h, w = batch.shape
        if draw is None:
            draw = self.draw(n, h, w)
        out = batch
        mean_done = True
        if self.mean is not None:
            m = self.mean
            if m.shape[1] == h and m.shape[2] == w:
                out = out - m[None]
            else:
                mean_done = False  # crop-sized mean: subtract post-crop

        if draw.offs is not None:
            hs, ws = draw.offs
            crop = int(tp.crop_size)
            if self.train:
                out = (np.stack([out[i, :, hs[i]:hs[i] + crop,
                                     ws[i]:ws[i] + crop]
                                 for i in range(n)])
                       if n else np.empty((0, c, crop, crop), out.dtype))
            else:
                h0, w0 = (h - crop) // 2, (w - crop) // 2
                out = out[:, :, h0:h0 + crop, w0:w0 + crop]
        else:
            out = out.copy()

        if not mean_done:
            m = self.mean
            if (m.shape[1] != out.shape[2]
                    or m.shape[2] != out.shape[3]):
                hs0 = (m.shape[1] - out.shape[2]) // 2
                ws0 = (m.shape[2] - out.shape[3]) // 2
                m = m[:, hs0:hs0 + out.shape[2], ws0:ws0 + out.shape[3]]
            out = out - m[None]

        if draw.flip.any():
            out[draw.flip] = out[draw.flip, :, :, ::-1]

        if tp.mean_value:
            mv = np.asarray(list(tp.mean_value), np.float32)
            if len(mv) == 1:
                out = out - mv[0]
            else:
                if len(mv) != c:
                    raise ValueError(
                        f"{len(mv)} mean_values for {c} channels")
                out = out - mv.reshape(1, c, 1, 1)

        if tp.scale != 1.0:
            out = out * tp.scale
        return np.ascontiguousarray(out, np.float32)

    def output_hw(self, h: int, w: int) -> Tuple[int, int]:
        crop = int(self.tp.crop_size)
        return (crop, crop) if crop else (h, w)

    # -- the device-side transform (COS_DEVICE_TRANSFORM) ----------------
    # host_stage draws exactly as __call__ does, so a run with the split
    # consumes the random stream identically and (host crop/mirror,
    # device mean/scale) reproduces the host-only batches.

    def device_eligible(self, in_h: int, in_w: int) -> bool:
        """The split takes the two mean geometries Caffe produces:
        full-size (a per-sample window at the crop offset) and
        output-size (a broadcast).  Any other mean keeps the host path."""
        if self.mean is None:
            return True
        oh, ow = self.output_hw(in_h, in_w)
        return tuple(self.mean.shape[1:]) in {(in_h, in_w), (oh, ow)}

    def host_stage(self, batch: np.ndarray,
                   draw: Optional[AugDraw] = None):
        """(N, C, H, W) integral pixels -> (uint8 batch cropped and
        mirrored, aux int32 (N, 3) of [h_off, w_off, flip]).  The bytes
        move in the native library's threaded `crop_mirror_u8` unless
        COS_NATIVE=0 selects the numpy body; both give the same batch."""
        n, c, h, w = batch.shape
        crop = int(self.tp.crop_size)
        u8 = batch if batch.dtype == np.uint8 else batch.astype(np.uint8)
        if draw is None:
            draw = self.draw(n, h, w)
        if draw.offs is not None:
            hs, ws = draw.offs
        else:
            hs = ws = np.zeros(n, np.int64)
        flip = draw.flip
        aux = np.stack([hs, ws, flip.astype(np.int64)],
                       axis=1).astype(np.int32)
        from .. import native
        if native.available():
            return native.crop_mirror_u8(
                u8, hs, ws, flip,
                crop=crop if draw.offs is not None else 0), aux
        if draw.offs is not None:
            u8 = (np.stack([u8[i, :, hs[i]:hs[i] + crop,
                               ws[i]:ws[i] + crop] for i in range(n)])
                  if n else np.empty((0, c, crop, crop), np.uint8))
        else:
            u8 = u8.copy()
        if flip.any():
            u8[flip] = u8[flip, :, :, ::-1]
        return np.ascontiguousarray(u8), aux

    def device_stage_fn(self, out_dtype=None):
        """(x uint8, aux int32) tensors on one device -> the transformed
        float batch there, in torch ops.  Subtracting the per-sample
        (h_off, w_off) window of a full-size mean, flipped where the
        image was flipped, equals Caffe's subtract-at-the-source-pixel
        order (see __call__)."""
        import torch

        mean = self.mean
        mv = (np.asarray(list(self.tp.mean_value), np.float32)
              if self.tp.mean_value else None)
        scale = float(self.tp.scale)
        consts: dict = {}      # per device: the mean and mean_value

        def on(device):
            if device not in consts:
                consts[device] = (
                    None if mean is None
                    else torch.from_numpy(mean).to(device),
                    None if mv is None else torch.from_numpy(mv).to(device))
            return consts[device]

        def apply(x, aux):
            out = x.to(torch.float32)
            n, c, ch, cw = x.shape
            m, mvt = on(x.device)
            if m is not None:
                if tuple(m.shape[1:]) == (ch, cw):
                    win = m.unsqueeze(0).expand(n, -1, -1, -1)
                else:
                    # full-size mean (device_eligible): the window at
                    # each sample's own crop offset
                    aux_l = aux.long()
                    rows = aux_l[:, :1] + torch.arange(ch, device=x.device)
                    cols = aux_l[:, 1:2] + torch.arange(cw, device=x.device)
                    win = m[:, rows[:, :, None], cols[:, None, :]
                            ].permute(1, 0, 2, 3)
                flip = aux[:, 2].bool()[:, None, None, None]
                out = out - torch.where(flip, win.flip(-1), win)
            if mvt is not None:
                out = out - (mvt[0] if len(mv) == 1
                             else mvt.view(1, c, 1, 1))
            if scale != 1.0:
                out = out * scale
            if out_dtype is not None:
                out = out.to(out_dtype)
            return out.contiguous()

        return apply
