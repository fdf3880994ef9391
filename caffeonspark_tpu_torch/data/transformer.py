"""Host transformer: Caffe `transform_param` semantics, TRAIN and TEST.

A copy of `caffeonspark_tpu/data/transformer.py` (Caffe's
DataTransformer) without its device-transform split: random crop and
mirror at TRAIN, center crop at TEST, mean subtraction (mean_file or
mean_value), scale.  Runs on numpy batches on the host; the caller moves
the packed batch to the device.

The random draws come from one `np.random.RandomState(seed & 0x7FFFFFFF)`
per transformer, in the JAX transformer's order (per batch: the crop
offsets of every sample, then the mirror flags), so for the same seed
both packages produce the same augmented batches.

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
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..proto.caffe import BlobProto, TransformationParameter


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
        then mirror flags."""
        offs = self._draw_crop(n, h, w)
        return AugDraw(offs, self._draw_flip(n))

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """batch: (N, C, H, W) float32 (raw 0..255 pixel scale)."""
        tp = self.tp
        n, c, h, w = batch.shape
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
