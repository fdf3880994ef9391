"""DataFrameSource: a table of typed columns -> CoSData tops.

The counterpart of `caffeonspark_tpu/data/dataframe.py` (reference:
`caffe-grid/.../DataFrameSource.scala`, Top class :315-353, nextBatch
packing :225-302): each `cos_data_param.top {}` names a column and its
type.  Packed: INT and FLOAT scalars, INT_ARRAY and FLOAT_ARRAY
(zero-padded or cut to `channels`, time-major (T, B) with `transpose`),
STRING, and the image types: RAW_IMAGE (uint8 C x H x W bytes, cut to
out_height x out_width) and ENCODED_IMAGE / ENCODED_IMAGE_WITH_DIM
(decoded through `source.decode_records`, resized to out_height x
out_width), each through its own `Transformer` when the top has a
`transform_param` (seeded seed + rank, its mean file beside the table).
An image column of a JSON table holds base64 text, as Spark's json sink
and `tools/converters.py` write binary columns; it is decoded here.

Tables: `dataframe_format: "json"` reads JSON lines with the standard
library (one object per line, keyed by column); "parquet" needs
pyarrow, imported when a parquet table is read.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, Iterator, List, Sequence

import numpy as np

from ..proto.caffe import TopBlobType as T
from .source import DataSource, decode_records, need_pyarrow
from .transformer import Transformer

IMAGE_TYPES = (T.RAW_IMAGE, T.ENCODED_IMAGE, T.ENCODED_IMAGE_WITH_DIM)


def _image_bytes(v) -> bytes:
    """An image cell as bytes: binary as it is, a list of byte values,
    or the base64 text of a JSON table."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, str):
        return base64.b64decode(v)
    return bytes(v or [])


class DataFrameSource(DataSource):

    def __init__(self, layer, **kw):
        super().__init__(layer, **kw)
        self.tops = list(layer.cos_data_param.top)
        self.top_transformers = {
            top.name: Transformer(
                top.transform_param, phase_train=self.phase_train,
                seed=self.seed + self.rank,
                mean_dir=os.path.dirname(self.source_uri()) or None)
            for top in self.tops if top.has("transform_param")}

    def image_dims(self):
        """(C, H, W) of the first image top; (0, 0, 0) without one."""
        for top in self.tops:
            if top.type in IMAGE_TYPES:
                return int(top.channels), int(top.height), int(top.width)
        return 0, 0, 0

    # -- rows --------------------------------------------------------------
    def _table(self) -> List[Dict]:
        fmt = self.layer.cos_data_param.dataframe_format or "parquet"
        path = self.source_uri()
        if fmt == "json":
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]
        if fmt == "parquet":
            pq = need_pyarrow(path, "reading a parquet DataFrame",
                              " (use dataframe_format: \"json\")")
            return pq.read_table(path).to_pylist()
        raise ValueError(f"dataframe_format {fmt!r}")

    def rows(self) -> Iterator[Dict]:
        """This rank's contiguous share of the table's rows."""
        table = self._table()
        n = len(table)
        lo = self.rank * n // self.num_ranks
        hi = (self.rank + 1) * n // self.num_ranks
        yield from table[lo:hi]

    def records(self):
        # rows are the records: next_batch packs them into typed tops
        return self.rows()

    # -- packing -----------------------------------------------------------
    def _pack_top(self, top, values: Sequence) -> np.ndarray:
        b = len(values)
        t = top.type
        if t == T.INT or t == T.FLOAT:
            arr = np.asarray([float(v if v is not None else 0)
                              for v in values], np.float32)
            return arr.reshape(b, 1, 1, 1)
        if t in (T.INT_ARRAY, T.FLOAT_ARRAY):
            width = int(top.channels)
            out = np.zeros((b, width), np.float32)
            for i, v in enumerate(values):
                v = list(v or [])[:width]
                out[i, :len(v)] = v
            if top.transpose:
                return np.ascontiguousarray(out.T)   # (T, B) time-major
            return out
        if t == T.STRING:
            return np.asarray([str(v) for v in values], object)
        if t not in IMAGE_TYPES:
            raise ValueError(f"CoSData top {top.name!r}: unknown type {t}")
        c, h, w = int(top.channels), int(top.height), int(top.width)
        oh = int(top.out_height or h)
        ow = int(top.out_width or w)
        payloads = [_image_bytes(v) for v in values]
        if t == T.RAW_IMAGE:
            imgs = np.zeros((b, c, oh, ow), np.float32)
            for i, p in enumerate(payloads):
                imgs[i] = np.frombuffer(p, np.uint8).reshape(
                    c, h, w)[:, :oh, :ow]
        else:
            imgs = decode_records(
                [(f"{top.name}[{i}]", 0.0, c, oh, ow, True, p)
                 for i, p in enumerate(payloads)], c, oh, ow,
                num_threads=self.num_threads)
        tr = self.top_transformers.get(top.name)
        return imgs if tr is None else tr(imgs)

    def next_batch(self, rows: Sequence[Dict], draw=None
                   ) -> Dict[str, np.ndarray]:
        """Typed tops, no augmentation: `draw` is always None here
        (make_draw_fn gives the pool none for this source)."""
        return {top.name: self._pack_top(top, [r.get(top.name)
                                               for r in rows])
                for top in self.tops}

    pack_batch = next_batch
