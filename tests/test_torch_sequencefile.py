"""The PyTorch port's SequenceFile reader/writer and SeqImageDataSource
against the JAX package.

  * a file written by either package reads identically in the other,
    uncompressed and record- or block-compressed with the zlib, gzip and
    bz2 codecs; the writers give the same bytes, but under GzipCodec,
    whose header carries the time of writing (its records are compared
    instead);
  * corrupt and truncated files raise ValueError in both readers;
  * SeqImageDataSource over one file and over a part directory of
    several (files round-robin by rank): the same records,
    `shuffled_records(epoch)` order and packed TRAIN batches;
  * `-train` of LeNet through both CLIs from one -weights file on a
    SequenceFile ends within rtol 1e-4.
"""

import numpy as np
import pytest

from caffeonspark_tpu.data import get_source as jax_get_source
from caffeonspark_tpu.data import sequencefile as JS
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu_torch.data import get_source
from caffeonspark_tpu_torch.data import sequencefile as TS
from caffeonspark_tpu_torch.data.source import SeqImageDataSource
from caffeonspark_tpu_torch.proto import NetParameter
from torch_port_helpers import datum_records, lenet_cli_pair
from torch_common import cap_torch_threads

cap_torch_threads()

CODECS = {"zlib": TS.DEFAULT_CODEC, "gzip": TS.GZIP_CODEC,
          "bz2": TS.BZIP2_CODEC}
FORMS = [(None, "zlib")] + [(comp, codec) for comp in ("record", "block")
                            for codec in CODECS]


def _write(mod, path, recs, comp, codec, block_size=1 << 20):
    with mod.SequenceFileWriter(path, compression=comp,
                                codec=CODECS[codec],
                                block_size=block_size) as w:
        for k, v in recs:
            w.append(k, v)


def _recs(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return [(f"key-{i:04d}-é", rng.bytes(int(rng.randint(0, 900))))
            for i in range(n)]


@pytest.mark.parametrize("comp,codec", FORMS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_file_written_by_either_package_reads_in_the_other(tmp_path, comp,
                                                           codec, writer):
    recs = _recs()
    path = str(tmp_path / "f.seq")
    _write(JS if writer == "jax" else TS, path, recs, comp, codec,
           block_size=4096)
    t, j = TS.SequenceFileReader(path), JS.SequenceFileReader(path)
    assert (t.compression, t.codec, t.key_class, t.value_class) == \
        (j.compression, j.codec, j.key_class, j.value_class)
    assert list(t) == list(j) == recs


@pytest.mark.parametrize("comp,codec", FORMS)
def test_writers_give_the_same_bytes(tmp_path, comp, codec):
    recs = _recs(seed=1)
    _write(JS, str(tmp_path / "j"), recs, comp, codec, block_size=4096)
    _write(TS, str(tmp_path / "t"), recs, comp, codec, block_size=4096)
    a, b = (tmp_path / "j").read_bytes(), (tmp_path / "t").read_bytes()
    if codec == "gzip":
        # gzip.compress stamps the time of writing into each member
        assert list(TS.SequenceFileReader(str(tmp_path / "j"))) == \
            list(TS.SequenceFileReader(str(tmp_path / "t")))
    else:
        assert a == b


@pytest.mark.parametrize("comp", [None, "record", "block"])
def test_corrupt_and_truncated_files_raise_value_error_in_both(tmp_path,
                                                               comp):
    path = tmp_path / "seq"
    _write(TS, str(path), [(f"{i:04d}", b"payload" * 20)
                           for i in range(50)], comp, "zlib")
    wire = path.read_bytes()
    bad = tmp_path / "bad"
    rng = np.random.RandomState(2)
    outcomes = []
    for i in range(60):
        m = bytearray(wire)
        m[rng.randint(0, len(m))] = rng.randint(0, 256)
        if i % 3 == 0:
            m = m[:rng.randint(4, len(m))]
        bad.write_bytes(bytes(m))
        res = []
        for mod in (TS, JS):
            try:
                res.append(("ok", list(mod.SequenceFileReader(str(bad)))))
            except (ValueError, NotImplementedError) as e:
                res.append(("error", type(e).__name__))
        assert res[0] == res[1]
        outcomes.append(res[0][0])
    assert "error" in outcomes


def _seq_layer(source, batch=4, hw=6):
    return ('layer { name: "data" type: "MemoryData" top: "data" '
            'top: "label" source_class: '
            '"com.yahoo.ml.caffe.SeqImageDataSource" transform_param { '
            'crop_size: 4 mirror: true mean_value: 100 } memory_data_param '
            f'{{ source: "{source}" batch_size: {batch} channels: 3 '
            f'height: {hw} width: {hw} }} }}')


def _write_parts(tmp_path, n_parts, per_part):
    d = tmp_path / "parts"
    d.mkdir()
    recs = datum_records(n_parts * per_part, 3, 6, 6, seed=4)
    for p in range(n_parts):
        with TS.SequenceFileWriter(str(d / f"part-{p:05d}")) as w:
            for k, v in recs[p * per_part:(p + 1) * per_part]:
                w.append(k.decode(), v)
    (d / "_SUCCESS").write_bytes(b"")
    (d / ".part-00009.crc").write_bytes(b"x")
    return str(d)


@pytest.mark.parametrize("n_parts,ranks", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_seq_source_records_shuffle_and_batches_equal_jax(tmp_path,
                                                          n_parts, ranks):
    """One file (every rank reads it whole, as the JAX package does) or a
    part directory (files round-robin by rank; marker and hidden files
    skipped)."""
    src = _write_parts(tmp_path, n_parts, 10)
    if n_parts == 1:
        src += "/part-00000"
    text = _seq_layer(src)
    for rank in range(ranks):
        tsrc = get_source(NetParameter.from_text(text).layer[0],
                          phase_train=True, rank=rank, num_ranks=ranks,
                          seed=5)
        jsrc = jax_get_source(JaxNetParameter.from_text(text).layer[0],
                              phase_train=True, rank=rank,
                              num_ranks=ranks, seed=5)
        assert isinstance(tsrc, SeqImageDataSource)
        got = list(tsrc.records())
        assert got == list(jsrc.records()) and got
        for epoch in (0, 1):
            assert list(tsrc.shuffled_records(epoch)) == \
                list(jsrc.shuffled_records(epoch))
        recs = list(tsrc.shuffled_records(0))
        for i in range(2):
            b_t = tsrc.next_batch(recs[4 * i:4 * i + 4])
            b_j = jsrc.next_batch(recs[4 * i:4 * i + 4])
            for k in ("data", "label"):
                np.testing.assert_array_equal(b_t[k], b_j[k])


def test_cli_train_on_a_sequencefile_matches_jax_cli(tmp_path):
    path = str(tmp_path / "train.seq")
    with TS.SequenceFileWriter(path, compression="block") as w:
        for k, v in datum_records(40, seed=9):
            w.append(k.decode(), v)
    layer = ('layer { name: "data" type: "MemoryData" top: "data" '
             'top: "label" source_class: '
             '"com.yahoo.ml.caffe.SeqImageDataSource" transform_param { '
             'scale: 0.00390625 crop_size: 24 mirror: true } '
             f'memory_data_param {{ source: "{path}" batch_size: 8 '
             'channels: 1 height: 28 width: 28 } }')
    got, want = lenet_cli_pair(tmp_path, layer)
    assert set(got) == set(want)
    for ln in want:
        for g, w in zip(got[ln], want[ln]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
