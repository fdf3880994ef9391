"""The PyTorch port's LevelDB reader/writer and the LevelDB `Data` layer
against the JAX package.

  * crc32c, the masked crc and the pure-Python snappy decoder agree;
  * a database written by either package's LevelDBWriter (raw or snappy
    blocks, SSTables, write-ahead logs, MANIFEST) reads identically in
    the other, and the writers give the same bytes;
  * MANIFEST replay (deleted keys stay deleted, obsolete logs dropped)
    and partition ranges agree;
  * corrupt files raise ValueError in both readers;
  * a source-less `Data` layer with `backend: LEVELDB`: the same top
    shapes from the first record (the port used to give (3, 0, 0)),
    records, shuffled order and packed TRAIN batches;
  * `-train` of LeNet through both CLIs from one -weights file on a
    LevelDB ends within rtol 1e-4.
"""

import glob
import os
import struct

import numpy as np
import pytest

from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.data import leveldb_io as JL
from caffeonspark_tpu.net import data_layer_input_specs as jax_specs
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu_torch.data import get_source
from caffeonspark_tpu_torch.data import leveldb_io as TL
from caffeonspark_tpu_torch.data.source import CaffeDataSource
from caffeonspark_tpu_torch.net import data_layer_input_specs
from caffeonspark_tpu_torch.proto import NetParameter
from torch_port_helpers import datum_records, lenet_cli_pair
from torch_common import cap_torch_threads

cap_torch_threads()


def _kv(n, vlen=60, seed=0):
    rng = np.random.RandomState(seed)
    return [(b"%08d" % i, rng.bytes(vlen + int(rng.randint(0, 40))))
            for i in range(n)]


def test_crc_and_snappy_agree():
    rng = np.random.RandomState(0)
    for n in (0, 1, 31, 1000):
        data = rng.bytes(n)
        assert TL.crc32c(data) == JL.crc32c(data)
        assert TL.crc_mask(TL.crc32c(data)) == JL.crc_mask(JL.crc32c(data))
    assert TL.crc32c(b"123456789") == 0xE3069283
    # literal, then copies with 1-, 2- and 4-byte offsets (overlapping)
    stream = (TL._put_uvarint(29) + bytes([4 << 2]) + b"abcde"
              + bytes([((8 - 4) << 2) | 1 | (0 << 5), 5])
              + bytes([((8 - 1) << 2) | 2]) + struct.pack("<H", 13)
              + bytes([((8 - 1) << 2) | 3]) + struct.pack("<I", 1))
    assert TL.snappy_decompress(stream) == JL.snappy_decompress(stream)
    with pytest.raises(ValueError):
        TL.snappy_decompress(TL._put_uvarint(4) + bytes([1, 1]))


@pytest.mark.parametrize("snappy", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_database_written_by_either_package_reads_in_the_other(
        tmp_path, writer, snappy):
    mod = JL if writer == "jax" else TL
    recs = _kv(300, seed=1)
    path = str(tmp_path / "db")
    w = mod.LevelDBWriter(path, block_size=1024, snappy=snappy)
    w.write(recs[:200])
    w.write_log(recs[200:], file_number=7)
    with TL.LevelDBReader(path) as t, JL.LevelDBReader(path) as j:
        assert list(t.items()) == list(j.items()) == recs
        assert t.partition_ranges(3) == j.partition_ranges(3)
        lo, hi = t.partition_ranges(3)[1]
        assert list(t.items(lo, hi)) == list(j.items(lo, hi))


@pytest.mark.parametrize("snappy", [False, True])
def test_writers_give_the_same_bytes(tmp_path, snappy):
    recs = _kv(120, seed=2)
    for mod, d in ((JL, "j"), (TL, "t")):
        w = mod.LevelDBWriter(str(tmp_path / d), block_size=700,
                              snappy=snappy)
        w.write(recs)
        w.write_log(recs[:5], file_number=9)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "t" / n).read_bytes(), n


def test_manifest_replay_agrees(tmp_path):
    """A crash-leftover table outside the MANIFEST's live set and a log
    below its log floor are ignored by both readers."""
    path = str(tmp_path / "db")
    w = TL.LevelDBWriter(path)
    w.write(_kv(10, seed=3), file_number=5)
    w.write_table([(b"%08d" % 99, b"stale")], file_number=3)
    w.write_log([(b"%08d" % 98, b"old")], file_number=2)
    w.write_manifest([(5, os.path.getsize(os.path.join(path,
                                                       "000005.ldb")),
                       TL.internal_key(b"%08d" % 0),
                       TL.internal_key(b"%08d" % 9))], log_number=4)
    with TL.LevelDBReader(path) as t, JL.LevelDBReader(path) as j:
        got = list(t.items())
        assert got == list(j.items()) == _kv(10, seed=3)


def test_corrupt_files_raise_value_error_in_both(tmp_path):
    path = str(tmp_path / "db")
    w = TL.LevelDBWriter(path, snappy=True)
    w.write(_kv(50, seed=4))
    w.write_log(_kv(5, seed=5), file_number=9)
    files = [f for f in glob.glob(os.path.join(path, "*"))
             if os.path.getsize(f)]
    rng = np.random.RandomState(6)
    rejected = 0
    for f in files:
        orig = open(f, "rb").read()
        for _ in range(15):
            m = bytearray(orig)
            m[rng.randint(0, len(m))] = rng.randint(0, 256)
            open(f, "wb").write(m)
            res = []
            for mod in (TL, JL):
                try:
                    with mod.LevelDBReader(path) as r:
                        res.append(list(r.items()))
                except ValueError as e:
                    res.append(type(e))
            assert res[0] == res[1]
            rejected += res[0] is ValueError
        open(f, "wb").write(orig)
    assert rejected


def _data_layer(source, batch=4, backend="LEVELDB"):
    return ('layer { name: "data" type: "Data" top: "data" top: "label" '
            'transform_param { crop_size: 8 mirror: true mean_value: 100 } '
            f'data_param {{ source: "file:{source}" batch_size: {batch} '
            f'backend: {backend} }} }}')


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_data_layer_leveldb_shapes_records_and_batches_equal_jax(tmp_path,
                                                                 writer):
    """The LevelDB `Data` layer's top shapes come from the first record
    in both packages (the port's shape probe gave (3, 0, 0) for any
    LevelDB before), and its source matches the JAX source."""
    path = str(tmp_path / "db")
    mod = JL if writer == "jax" else TL
    mod.LevelDBWriter(path, snappy=True, block_size=900).write(
        datum_records(14, 3, 10, 9, seed=6))
    text = _data_layer(path)
    tl = NetParameter.from_text(text).layer[0]
    jl = JaxNetParameter.from_text(text).layer[0]
    assert data_layer_input_specs(tl) == jax_specs(jl) == [
        ("data", (4, 3, 8, 8), "data"), ("label", (4,), "label")]
    tl.transform_param.crop_size = jl.transform_param.crop_size = 0
    assert data_layer_input_specs(tl) == jax_specs(jl)
    assert data_layer_input_specs(tl)[0][1] == (4, 3, 10, 9)
    tl.transform_param.crop_size = jl.transform_param.crop_size = 8
    for rank, ranks in ((0, 1), (1, 2)):
        tsrc = get_source(tl, phase_train=True, seed=3, rank=rank,
                          num_ranks=ranks)
        jsrc = jax_get_source(jl, phase_train=True, seed=3, rank=rank,
                              num_ranks=ranks)
        assert isinstance(tsrc, CaffeDataSource)
        assert tsrc.image_dims() == jsrc.image_dims() == (3, 10, 9)
        assert list(tsrc.records()) == list(jsrc.records())
        recs = list(tsrc.shuffled_records(1))
        assert recs == list(jsrc.shuffled_records(1))
        b_t, b_j = tsrc.next_batch(recs[:4]), jsrc.next_batch(recs[:4])
        for k in ("data", "label"):
            np.testing.assert_array_equal(b_t[k], b_j[k])


def test_unreadable_leveldb_gives_the_fallback_shape(tmp_path):
    text = _data_layer(str(tmp_path / "missing"))
    assert data_layer_input_specs(NetParameter.from_text(text).layer[0]) \
        == jax_specs(JaxNetParameter.from_text(text).layer[0])


def test_cli_train_on_a_leveldb_matches_jax_cli(tmp_path):
    path = str(tmp_path / "ldb")
    TL.LevelDBWriter(path, snappy=True).write(datum_records(40, seed=9))
    layer = ('layer { name: "data" type: "Data" top: "data" top: "label" '
             'transform_param { scale: 0.00390625 crop_size: 24 '
             f'mirror: true }} data_param {{ source: "{path}" '
             'batch_size: 8 backend: LEVELDB } }')
    got, want = lenet_cli_pair(tmp_path, layer)
    assert set(got) == set(want)
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
