"""Data sources: record packing for the serving path.

The part of `caffeonspark_tpu/data/source.py` that serving needs.  A
record is the reference's 7-tuple `(id, label, C, H, W, encoded,
payload)`; `DataSource.next_batch` packs raw-pixel records through the
TEST-phase transformer into the data layer's named blobs (numpy, on the
host).  The serving path uses a source only as this packer: requests
carry their own pixels, so the backing store named by `source_class`
is never read.  Reading stores (LMDB, SequenceFile, DataFrame) and
decoding encoded images come with later slices.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from ..proto.caffe import LayerParameter
from .transformer import Transformer

ImageRecord = Tuple[str, float, int, int, int, bool, object]


def _strip_scheme(uri: str) -> str:
    for scheme in ("file:", "hdfs:"):
        if uri.startswith(scheme):
            uri = uri[len(scheme):]
    return uri


class DataSource:
    """Record packer for one data layer (TEST phase)."""

    def __init__(self, layer: LayerParameter):
        self.layer = layer
        self.transformer = Transformer(
            layer.transform_param if layer.has("transform_param") else None,
            mean_dir=os.path.dirname(self.source_uri()) or None)

    def source_uri(self) -> str:
        if self.layer.has("memory_data_param"):
            return _strip_scheme(self.layer.memory_data_param.source)
        if self.layer.has("cos_data_param"):
            return _strip_scheme(self.layer.cos_data_param.source)
        return ""

    def image_dims(self) -> Tuple[int, int, int]:
        p = self.layer.memory_data_param
        return int(p.channels), int(p.height), int(p.width)

    def next_batch(self, records: Sequence[ImageRecord]
                   ) -> Dict[str, np.ndarray]:
        """Pack + transform records into the data layer's blobs.
        Payloads are raw pixels: a float ndarray of (C, H, W) values or
        uint8 bytes."""
        c, h, w = self.image_dims()
        n = len(records)
        labels = np.asarray([r[1] for r in records], np.float32)
        data = np.zeros((n, c, h, w), np.float32)
        for i, (rid, _label, rc, rh, rw, encoded, payload) in \
                enumerate(records):
            if encoded:
                raise NotImplementedError(
                    f"record {rid}: encoded images are not decoded by the "
                    "PyTorch port yet; send raw pixels ('data')")
            if (rh, rw) != (h, w):
                raise ValueError(
                    f"record {rid}: {rh}x{rw} != layer {h}x{w}")
            if isinstance(payload, np.ndarray):
                data[i] = payload.reshape(rc, rh, rw)
            else:
                data[i] = np.frombuffer(payload, np.uint8).astype(
                    np.float32).reshape(rc, rh, rw)
        out_names = list(self.layer.top)
        batch = {out_names[0]: self.transformer(data)}
        if len(out_names) > 1:
            batch[out_names[1]] = labels
        return batch


# the CaffeOnSpark source classes a MemoryData/CoSData layer may name;
# serving packs their records the same way whatever the store is
SOURCE_CLASSES = (
    "com.yahoo.ml.caffe.LMDB", "com.yahoo.ml.caffe.SeqImageDataSource",
    "com.yahoo.ml.caffe.ImageDataFrame", "LMDB", "SeqImageDataSource",
    "ImageDataFrame")


def get_source(layer: LayerParameter) -> DataSource:
    """Factory keyed on the prototxt `source_class`
    (DataSource.scala:130-167)."""
    cls_name = layer.source_class
    if not cls_name:
        raise ValueError(f"data layer {layer.name!r} has no source_class")
    if cls_name not in SOURCE_CLASSES:
        raise ValueError(f"source_class {cls_name!r} is not in the "
                         f"PyTorch port (have {list(SOURCE_CLASSES)})")
    return DataSource(layer)
