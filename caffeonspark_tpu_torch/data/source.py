"""Data sources: records from a store, packed into the data layer's blobs.

The counterpart of `caffeonspark_tpu/data/source.py` (the DataSource SPI
of the reference, `DataSource.scala:27-128`).  A record is the
reference's 7-tuple `(id, label, C, H, W, encoded, payload)`;
`DataSource.next_batch` packs raw-pixel records through the phase's
transformer into the data layer's named blobs (numpy, on the host),
or, with the device-side transform (`enable_device_transform`), into
uint8 pixels and their crop/flip aux array whose float stage runs on
the device (`apply_device_stage`, data/queue_runner.py).

Stores, by `source_class` (or by layer type where Caffe has no
CaffeOnSpark source class):
  * `LMDB`: an LMDB of Caffe `Datum` records, read rank-sharded by key
    range (data/lmdb_io.py);
  * `SeqImageDataSource`: a SequenceFile of (id, Datum) records, or a
    directory of part files taken round-robin by rank
    (data/sequencefile.py; `tools/converters.py binary2sequence` writes
    them);
  * `ImageDataFrame`: a parquet table of images (needs pyarrow, refused
    by name without it);
  * `DataFrameSource`: a table of typed columns for CoSData layers
    (data/dataframe.py);
  * `StreamingDir`: a growing directory of LMDB / SequenceFile parts
    (data/streaming.py);
  * `module:Class`: a user's DataSource subclass, imported by name;
  * a source-less `Data` layer: Caffe's own LMDB or LevelDB database
    (data/leveldb_io.py);
  * `ImageData`: Caffe's image list (`ImageListSource`);
  * `HDF5Data`: Caffe's list of HDF5 files (data/hdf5.py; needs h5py).

Encoded Datums and image files (`convert_imageset --encoded`) are
decoded by the native library's threaded libjpeg decoder
(`native.decode_batch`, `num_threads` on the source, 0 meaning one
thread per core), straight to uint8 planes under the device-side
transform.  When a batch fails, its images are decoded one by one to
name the bad record.  Under COS_NATIVE=0, or on a machine without
libjpeg, each image goes through cv2 where cv2 imports, as in the JAX
package; otherwise the record is refused, naming what is missing.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..proto.caffe import Datum, LayerParameter
from .lmdb_io import LmdbReader
from .transformer import DEVICE_AUX_SUFFIX, AugDraw, Transformer

ImageRecord = Tuple[str, float, int, int, int, bool, object]

# epoch boundary in a feed queue: the packer drops the ragged tail
STOP_MARK = object()


def _strip_scheme(uri: str) -> str:
    for scheme in ("file:", "hdfs:"):
        if uri.startswith(scheme):
            uri = uri[len(scheme):]
    return uri


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def decode_image(rid: str, data: bytes, *, channels: int,
                 resize_hw: Tuple[int, int], dtype=np.float32) -> np.ndarray:
    """One encoded image -> (C, H, W) in BGR order through cv2 (the JAX
    package's per-image path, jcaffe Mat.decode), resized when its size
    differs from `resize_hw`."""
    cv2 = _cv2()
    if cv2 is None:
        from .. import native
        why = ("COS_NATIVE=0 selects the cv2 decoder" if not native.enabled()
               else "the native decoder needs libjpeg (jpeglib.h and "
               "-ljpeg), which this machine lacks")
        raise RuntimeError(f"record {rid!r} is an encoded image: {why}, "
                           "and cv2 is not importable here")
    flag = cv2.IMREAD_GRAYSCALE if channels == 1 else cv2.IMREAD_COLOR
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    if img is None:
        raise ValueError(f"record {rid!r}: image decode failed")
    if (img.shape[0], img.shape[1]) != tuple(resize_hw):
        img = cv2.resize(img, (resize_hw[1], resize_hw[0]))
    if img.ndim == 2:
        img = img[:, :, None]
    return img.transpose(2, 0, 1).astype(dtype)


def decode_records(records: Sequence[ImageRecord], c: int, h: int, w: int,
                   *, dtype=np.float32, num_threads: int = 0) -> np.ndarray:
    """Encoded records -> (N, C, H, W) of `dtype` (float32, or uint8 for
    the device-side transform): one native batch decode, or cv2 image
    by image (COS_NATIVE=0, no libjpeg).  A batch the native decoder
    fails (a PNG, a corrupt file) goes through cv2 image by image, as in
    the JAX package, which names a bad record; without cv2 it is decoded
    natively again image by image to name its first bad record."""
    from .. import native
    images = [r[6] for r in records]
    if native.decode_available():
        try:
            return native.decode_batch(images, channels=c, out_h=h, out_w=w,
                                       num_threads=num_threads,
                                       out_dtype=dtype)
        except ValueError:
            if _cv2() is not None:
                return _decode_cv2(records, c, h, w, dtype)
            for r in records:
                try:
                    native.decode_batch([r[6]], channels=c, out_h=h,
                                        out_w=w, num_threads=1,
                                        out_dtype=dtype)
                except ValueError as e:
                    raise ValueError(f"record {r[0]!r}: image decode "
                                     "failed") from e
            raise
    return _decode_cv2(records, c, h, w, dtype)


def _decode_cv2(records, c, h, w, dtype) -> np.ndarray:
    out = np.zeros((len(records), c, h, w), dtype)
    for i, r in enumerate(records):
        out[i] = decode_image(r[0], r[6], channels=c, resize_hw=(h, w),
                              dtype=dtype)
    return out


def datum_to_record(key: bytes, raw: bytes) -> ImageRecord:
    """LMDB value (serialized Datum) -> 7-tuple record
    (`LmdbRDD.scala:136-151`): uint8 pixel bytes, a float32 array for a
    float-payload Datum, or the encoded bytes flagged as encoded."""
    d = Datum.from_binary(raw)
    rid = key.decode("latin-1")
    if not d.encoded and not d.has("data") and d.float_data:
        arr = np.asarray(list(d.float_data), np.float32).reshape(
            d.channels, d.height, d.width)
        return (rid, float(d.label), d.channels, d.height, d.width, False,
                arr)
    if d.encoded or not d.has("data"):
        data = d.data if d.has("data") else b""
        return (rid, float(d.label), d.channels, d.height, d.width, True,
                data)
    return (rid, float(d.label), d.channels, d.height, d.width, False,
            d.data)


def first_datum_dims(reader) -> Optional[Tuple[int, int, int]]:
    """(C, H, W) of the database's first Datum; None when it is empty."""
    for _k, v in reader.items(None, None):
        d = Datum.from_binary(v)
        return int(d.channels), int(d.height), int(d.width)
    return None


class DataSource:
    """SPI base: record packing for one data layer; stores that the port
    reads implement `records()`."""

    SHUFFLE_BUFFER = 4096

    def __init__(self, layer: LayerParameter, *, phase_train: bool = False,
                 rank: int = 0, num_ranks: int = 1, seed: int = 0,
                 resize: bool = False, num_threads: int = 0):
        self.layer = layer
        self.phase_train = phase_train
        self.rank = rank
        self.num_ranks = num_ranks
        self.seed = seed
        self.resize = resize
        self.num_threads = num_threads  # 0: the native decoder's default
        self.batch_size = self._batch_size()
        self.transformer = Transformer(
            layer.transform_param if layer.has("transform_param") else None,
            phase_train=phase_train, seed=seed + rank,
            mean_dir=os.path.dirname(self.source_uri()) or None)
        self._device_transform = False
        self._device_fns: Dict = {}

    # -- config ------------------------------------------------------------
    def _batch_size(self) -> int:
        if self.layer.has("memory_data_param"):
            return int(self.layer.memory_data_param.batch_size)
        if self.layer.has("cos_data_param"):
            return int(self.layer.cos_data_param.batch_size)
        raise ValueError(f"data layer {self.layer.name!r} has no batch size")

    def source_uri(self) -> str:
        if self.layer.has("memory_data_param"):
            return _strip_scheme(self.layer.memory_data_param.source)
        if self.layer.has("cos_data_param"):
            return _strip_scheme(self.layer.cos_data_param.source)
        return ""

    def image_dims(self) -> Tuple[int, int, int]:
        p = self.layer.memory_data_param
        return int(p.channels), int(p.height), int(p.width)

    # -- SPI ---------------------------------------------------------------
    def records(self) -> Iterator[ImageRecord]:
        raise NotImplementedError(
            f"{type(self).__name__} implements no records()")

    def next_batch(self, records: Sequence[ImageRecord],
                   draw: Optional[AugDraw] = None
                   ) -> Dict[str, np.ndarray]:
        """Pack + transform records into the data layer's blobs.
        Payloads are raw pixels: a float ndarray of (C, H, W) values or
        uint8 bytes.  `draw` replays a pre-drawn augmentation (the
        transformer pool's ordered draws) instead of drawing here.  With
        the device-side transform enabled the first top is the uint8
        host stage and `<top>__devxf` its aux array."""
        c, h, w = self.image_dims()
        n = len(records)
        labels = np.asarray([r[1] for r in records], np.float32)
        if self._device_transform:
            # a float payload cannot be narrowed to uint8 without loss,
            # and a per-batch fallback would emit another key set
            bad = next((r for r in records
                        if not r[5] and isinstance(r[6], np.ndarray)
                        and r[6].dtype != np.uint8), None)
            if bad is not None:
                raise ValueError(
                    f"COS_DEVICE_TRANSFORM=1 needs uint8/encoded pixel "
                    f"payloads, but record {bad[0]!r} carries "
                    f"{bad[6].dtype} data — unset COS_DEVICE_TRANSFORM "
                    "for float-valued sources")
        dtype = np.uint8 if self._device_transform else np.float32
        encoded = [i for i, r in enumerate(records) if r[5]]
        if encoded and len(encoded) == n:
            data = decode_records(records, c, h, w, dtype=dtype,
                                  num_threads=self.num_threads)
        else:
            data = np.zeros((n, c, h, w), dtype)
            if encoded:
                data[encoded] = decode_records(
                    [records[i] for i in encoded], c, h, w, dtype=dtype,
                    num_threads=self.num_threads)
        for i, (rid, _label, rc, rh, rw, enc, payload) in \
                enumerate(records):
            if enc:
                continue
            if (rh, rw) != (h, w):
                raise ValueError(
                    f"record {rid}: {rh}x{rw} != layer {h}x{w}")
            if isinstance(payload, np.ndarray):
                data[i] = payload.reshape(rc, rh, rw)
            else:
                data[i] = np.frombuffer(payload, np.uint8).reshape(
                    rc, rh, rw)
        out_names = list(self.layer.top)
        if self._device_transform:
            u8, aux = self.transformer.host_stage(data, draw=draw)
            batch = {out_names[0]: u8,
                     out_names[0] + DEVICE_AUX_SUFFIX: aux}
        else:
            batch = {out_names[0]: self.transformer(data, draw=draw)}
        if len(out_names) > 1:
            batch[out_names[1]] = labels
        return batch

    # -- transformer-pool protocol -----------------------------------------
    def pack_batch(self, records: Sequence[ImageRecord],
                   draw: Optional[AugDraw] = None
                   ) -> Dict[str, np.ndarray]:
        """What the pool's workers call: next_batch with an optional
        pre-draw.  Sources that pack their own blobs (DataFrameSource)
        never get one (make_draw_fn returns None for them)."""
        return self.next_batch(records, draw=draw)

    def _packs_images(self) -> bool:
        return type(self).next_batch is DataSource.next_batch

    def make_draw_fn(self):
        """`fn(n) -> AugDraw` for the pool's dispatcher, which draws each
        batch's augmentation in feed order on one thread, so that packing
        on several reproduces the inline path's stream.  None for a
        source that packs its own blobs or has no image geometry."""
        if not self._packs_images():
            return None
        try:
            _c, h, w = self.image_dims()
        except (NotImplementedError, ValueError):
            return None
        t = self.transformer
        return lambda n: t.draw(n, h, w)

    def enable_device_transform(self, net_dtype=None):
        """With COS_DEVICE_TRANSFORM=1, switch next_batch to the uint8 +
        aux split and return `{top: fn(u8, aux)}`, the device stage
        (Transformer.device_stage_fn; cast to `net_dtype` unless it is
        float32).  None, leaving the host path, for a source that packs
        its own blobs, has no image geometry or a mean of another
        shape."""
        if os.environ.get("COS_DEVICE_TRANSFORM") != "1":
            return None
        if not self._packs_images():
            return None
        try:
            _c, h, w = self.image_dims()
        except (NotImplementedError, ValueError):
            return None
        if not self.transformer.device_eligible(h, w):
            return None
        import torch
        out_dtype = None if net_dtype in (None, torch.float32) else net_dtype
        self._device_transform = True
        self._device_fns = {self.layer.top[0]:
                            self.transformer.device_stage_fn(out_dtype)}
        return dict(self._device_fns)

    def apply_device_stage(self, batch: Dict[str, np.ndarray], device):
        """A packed host batch -> tensors on `device`, finishing the
        split where it is on: for consumers that call next_batch
        themselves (validation rounds, feature extraction) rather than
        feeding through device_prefetch."""
        from .queue_runner import stage_batch
        return stage_batch(batch, device, self._device_fns)

    # -- epochs ------------------------------------------------------------
    def epoch_seed(self, epoch: int) -> int:
        """Deterministic per-(seed, rank, epoch) shuffle seed."""
        return (self.seed + self.rank * 9973
                + epoch * 131071) & 0x7FFFFFFF

    def shuffled_records(self, epoch: int) -> Iterator[ImageRecord]:
        """Streaming shuffle over records(): a bounded reservoir buffer
        (capacity SHUFFLE_BUFFER) emits a random resident element as
        each new record arrives; the order is fully determined by
        (seed, rank, epoch), as in the JAX package."""
        rng = np.random.RandomState(self.epoch_seed(epoch))
        buf: List[ImageRecord] = []
        for rec in self.records():
            if len(buf) < self.SHUFFLE_BUFFER:
                buf.append(rec)
                continue
            j = rng.randint(0, len(buf))
            out, buf[j] = buf[j], rec
            yield out
        rng.shuffle(buf)
        yield from buf

    def batches(self, *, loop: bool = True,
                shuffle: Optional[bool] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Records -> packed batches, epoch-looping (a looping epoch's
        tail carries into the next); shuffled at TRAIN by default.  With
        loop=False the ragged tail comes as a short batch."""
        if shuffle is None:
            shuffle = self.phase_train
        buf: List[ImageRecord] = []
        epoch = 0
        while True:
            got_any = False
            records = (self.shuffled_records(epoch) if shuffle
                       else self.records())
            for rec in records:
                got_any = True
                buf.append(rec)
                if len(buf) == self.batch_size:
                    yield self.next_batch(buf)
                    buf = []
            if not got_any:
                return
            if not loop:
                if buf:
                    yield self.next_batch(buf)
                return
            epoch += 1


class LMDB(DataSource):
    """LMDB of Caffe Datum records (source_class com.yahoo.ml.caffe.LMDB),
    read rank-sharded by key range."""

    def _reader(self) -> LmdbReader:
        return LmdbReader(self.source_uri())

    def records(self) -> Iterator[ImageRecord]:
        with self._reader() as r:
            ranges = r.partition_ranges(self.num_ranks)
            lo, hi = ranges[self.rank % len(ranges)]
            for k, v in r.items(lo, hi):
                yield datum_to_record(k, v)


class CaffeDataSource(LMDB):
    """Caffe's own `Data` layer (`data_param { source backend }`): LMDB or
    LevelDB databases of serialized Datum records (db_lmdb.cpp /
    db_leveldb.cpp); geometry comes from the first record, as Caffe's
    DataLayer sizes its tops."""

    def _batch_size(self) -> int:
        return int(self.layer.data_param.batch_size)

    def source_uri(self) -> str:
        return _strip_scheme(self.layer.data_param.source)

    def _reader(self):
        return open_db(self.source_uri(), self.layer.data_param.backend)

    def image_dims(self) -> Tuple[int, int, int]:
        dims = getattr(self, "_dims", None)
        if dims is None:
            with self._reader() as r:
                dims = first_datum_dims(r)
            if dims is None:
                raise ValueError(f"{self.source_uri()!r}: empty database")
            self._dims = dims
        return dims


def open_db(path: str, backend: int):
    """A reader of a `Data` layer's database: LevelDB for `backend:
    LEVELDB`, else LMDB."""
    from ..proto.caffe import DBBackend
    if backend == DBBackend.LEVELDB:
        from .leveldb_io import LevelDBReader
        return LevelDBReader(path)
    return LmdbReader(path)


class SeqImageDataSource(DataSource):
    """SequenceFile of (id, Datum) records (source_class
    com.yahoo.ml.caffe.SeqImageDataSource): one file, or a directory of
    part files (names starting with "." or "_" skipped) taken
    round-robin by rank when there are several."""

    def records(self) -> Iterator[ImageRecord]:
        from .sequencefile import SequenceFileReader
        path = self.source_uri()
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if not f.startswith((".", "_"))) if os.path.isdir(path) \
            else [path]
        for i, f in enumerate(files):
            if i % self.num_ranks != self.rank and len(files) > 1:
                continue
            for key, val in SequenceFileReader(f):
                yield datum_to_record(key.encode("latin-1"), val)


def need_pyarrow(path: str, what: str, hint: str = ""):
    """`pyarrow.parquet`, or an ImportError naming pyarrow and `what`."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(f"{path!r}: {what} needs pyarrow, which is not "
                          f"installed{hint}") from e
    return pq


class ImageDataFrame(DataSource):
    """Parquet DataFrame of images (source_class
    com.yahoo.ml.caffe.ImageDataFrame): optional columns id / label /
    channels / height / width / encoded and the data column
    (ImageDataFrame.scala:31-73); each rank reads a contiguous share of
    the rows.  Needs pyarrow."""

    def records(self) -> Iterator[ImageRecord]:
        pq = need_pyarrow(self.source_uri(), "an ImageDataFrame")
        c, h, w = self.image_dims()
        encoded_default = self.layer.memory_data_param.image_encoded
        table = pq.read_table(self.source_uri())
        cols = set(table.column_names)
        n = table.num_rows
        lo = self.rank * n // self.num_ranks
        hi = (self.rank + 1) * n // self.num_ranks
        tbl = table.slice(lo, hi - lo).to_pydict()
        for i in range(hi - lo):
            def col(name, default):
                return tbl[name][i] if name in cols else default
            data = col("data", b"") or b""
            if isinstance(data, list):
                data = bytes(data)
            yield (str(col("id", i)), float(col("label", 0.0) or 0.0),
                   int(col("channels", c)), int(col("height", h)),
                   int(col("width", w)),
                   bool(col("encoded", encoded_default)), data)


class ImageListSource(DataSource):
    """Caffe's ImageData layer (image_data_layer.cpp): a text list of
    `<path> <label>` lines, images read from disk (under root_folder)
    and resized to new_height x new_width.  `shuffle` draws a fresh
    permutation every epoch from a rank-independent seed, so that rank
    striping (line i to rank i % ranks) stays a partition; `rand_skip`
    rotates the list once, at epoch 0.  The epoch counts the calls of
    records(), as in the JAX package."""

    def __init__(self, layer: LayerParameter, **kw):
        kw["resize"] = True       # Caffe's ImageData always resizes
        super().__init__(layer, **kw)
        self._epoch = 0

    def _batch_size(self) -> int:
        return int(self.layer.image_data_param.batch_size)

    def source_uri(self) -> str:
        return _strip_scheme(self.layer.image_data_param.source)

    def image_dims(self) -> Tuple[int, int, int]:
        p = self.layer.image_data_param
        c = 3 if p.is_color else 1
        h, w = int(p.new_height), int(p.new_width)
        if not h or not w:
            cs = int(self.layer.transform_param.crop_size or 0)
            h = h or cs
            w = w or cs
        return c, h, w

    def _entries(self) -> List[Tuple[str, float]]:
        root = self.layer.image_data_param.root_folder or ""
        out = []
        with open(self.source_uri()) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                path, _, lbl = ln.rpartition(" ")
                if not path:      # no label column
                    path, lbl = lbl, "0"
                out.append((os.path.join(root, path), float(lbl)))
        return out

    def records(self) -> Iterator[ImageRecord]:
        """image_data_layer.cpp's order: shuffle first (ShuffleImages()
        at every wrap), then rand_skip once at startup only."""
        c, h, w = self.image_dims()
        p = self.layer.image_data_param
        entries = self._entries()
        epoch, self._epoch = self._epoch, self._epoch + 1
        if p.shuffle:
            seed = (self.seed + epoch * 131071) & 0x7FFFFFFF
            np.random.RandomState(seed).shuffle(entries)
        if int(p.rand_skip) and epoch == 0:
            skip = np.random.RandomState(self.seed).randint(
                0, int(p.rand_skip))
            entries = entries[skip:] + entries[:skip]
        for i, (path, lbl) in enumerate(entries):
            if i % self.num_ranks != self.rank:
                continue
            with open(path, "rb") as f:
                yield (os.path.basename(path), lbl, c, h, w, True,
                       f.read())


_CLASS_MAP = {
    "com.yahoo.ml.caffe.LMDB": LMDB,
    "com.yahoo.ml.caffe.SeqImageDataSource": SeqImageDataSource,
    "com.yahoo.ml.caffe.ImageDataFrame": ImageDataFrame,
    "LMDB": LMDB,
    "SeqImageDataSource": SeqImageDataSource,
    "ImageDataFrame": ImageDataFrame,
}


def get_source(layer: LayerParameter, **kw) -> DataSource:
    """Factory keyed on the prototxt `source_class`
    (DataSource.scala:130-167); `kw` as for DataSource.  HDF5Data,
    ImageData and a source-less Data layer are Caffe layer types with no
    CaffeOnSpark source class and route by type."""
    if layer.type == "HDF5Data":
        from .hdf5 import HDF5Source
        return HDF5Source(layer, **kw)
    if layer.type == "ImageData":
        return ImageListSource(layer, **kw)
    if layer.type == "Data" and not layer.source_class:
        return CaffeDataSource(layer, **kw)
    cls_name = layer.source_class
    if not cls_name:
        raise ValueError(f"data layer {layer.name!r} has no source_class")
    if cls_name in _CLASS_MAP:
        return _CLASS_MAP[cls_name](layer, **kw)
    if cls_name.endswith("DataFrameSource"):
        from .dataframe import DataFrameSource
        return DataFrameSource(layer, **kw)
    if cls_name in ("StreamingDir", "com.yahoo.ml.caffe.StreamingDir"):
        from .streaming import StreamingDirSource
        return StreamingDirSource(layer, **kw)
    if ":" in cls_name:             # a user's "module:Class"
        import importlib
        mod, cls = cls_name.rsplit(":", 1)
        return getattr(importlib.import_module(mod), cls)(layer, **kw)
    raise ValueError(f"unknown source_class {cls_name!r}")


def register_source(name: str, cls) -> None:
    """Make `cls` the source of `source_class: "<name>"`."""
    _CLASS_MAP[name] = cls
