"""DataFrameSource: a table of typed columns -> CoSData tops.

The counterpart of `caffeonspark_tpu/data/dataframe.py` (reference:
`caffe-grid/.../DataFrameSource.scala`, Top class :315-353, nextBatch
packing :225-302): each `cos_data_param.top {}` names a column and its
type.  Packed here: INT and FLOAT scalars, INT_ARRAY and FLOAT_ARRAY
(zero-padded or cut to `channels`, time-major (T, B) with `transpose`),
and STRING.  Image tops (RAW_IMAGE, ENCODED_IMAGE*) wait for the slice
that decodes images, and raise naming themselves.

Tables: `dataframe_format: "json"` reads JSON lines with the standard
library (one object per line, keyed by column); "parquet" needs
pyarrow, imported when a parquet table is read.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Sequence

import numpy as np

from ..proto.caffe import TopBlobType as T
from .source import DataSource

class DataFrameSource(DataSource):

    def __init__(self, layer, **kw):
        super().__init__(layer, **kw)
        self.tops = list(layer.cos_data_param.top)

    # -- rows --------------------------------------------------------------
    def _table(self) -> List[Dict]:
        fmt = self.layer.cos_data_param.dataframe_format or "parquet"
        path = self.source_uri()
        if fmt == "json":
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]
        if fmt == "parquet":
            try:
                import pyarrow.parquet as pq
            except ImportError as e:
                raise ImportError(
                    f"{path!r}: reading a parquet DataFrame needs pyarrow, "
                    "which is not installed (use dataframe_format: "
                    "\"json\")") from e
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
        raise NotImplementedError(
            f"CoSData top {top.name!r} ({T.name_of(t)}): image tops of a "
            "DataFrame wait for the slice of the PyTorch port that decodes "
            "images")

    def next_batch(self, rows: Sequence[Dict], draw=None
                   ) -> Dict[str, np.ndarray]:
        """Typed tops, no augmentation: `draw` is always None here
        (make_draw_fn gives the pool none for this source)."""
        return {top.name: self._pack_top(top, [r.get(top.name)
                                               for r in rows])
                for top in self.tops}

    pack_batch = next_batch
