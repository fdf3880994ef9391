"""TEST-phase host transformer: Caffe `transform_param` semantics.

The TEST-phase part of `caffeonspark_tpu/data/transformer.py` (Caffe's
DataTransformer): center crop, mean subtraction (mean_file or
mean_value), scale.  Mirroring and random crops belong to the TRAIN
phase and come with the training slice.  Runs on numpy batches on the
host; the service moves the packed batch to the device.

Order of operations (data_transformer.cpp):
  1. mean_file subtraction at the SOURCE pixel (before the crop) when
     the mean has the input's size, else after the crop;
  2. center crop;
  3. mean_value per-channel subtraction;
  4. scale multiplication.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..proto.caffe import BlobProto, TransformationParameter


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
    """Batched NCHW TEST-phase transformer."""

    def __init__(self, tp: Optional[TransformationParameter], *,
                 mean_dir: Optional[str] = None):
        self.tp = tp or TransformationParameter()
        self.mean: Optional[np.ndarray] = None
        if self.tp.has("mean_file") and self.tp.mean_file:
            p = self.tp.mean_file
            if mean_dir is not None and not os.path.isabs(p):
                p = os.path.join(mean_dir, p)
            self.mean = load_mean_file(p)
        if self.tp.mean_value and self.mean is not None:
            raise ValueError("specify either mean_file or mean_value, "
                             "not both")

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """batch: (N, C, H, W) float32 (raw 0..255 pixel scale)."""
        tp = self.tp
        n, c, h, w = batch.shape
        crop = int(tp.crop_size)
        out = batch
        mean_done = True
        if self.mean is not None:
            m = self.mean
            if m.shape[1] == h and m.shape[2] == w:
                out = out - m[None]
            else:
                mean_done = False  # crop-sized mean: subtract post-crop

        if crop and (crop != h or crop != w):
            if crop > h or crop > w:
                raise ValueError(f"crop_size {crop} exceeds input {h}x{w}")
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
