"""The PyTorch port's converters CLI (`python -m
caffeonspark_tpu_torch.tools.converters`) against the JAX package's on
the same inputs: every subcommand writes the same records (the same
bytes where the output is a SequenceFile or JSON lines), a `.parquet`
output is refused by name without pyarrow, and the module runs as a
program."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from caffeonspark_tpu.data import LmdbReader as JaxLmdbReader
from caffeonspark_tpu.tools import converters as JC
from caffeonspark_tpu_torch.data import LmdbReader, LmdbWriter
from caffeonspark_tpu_torch.data.leveldb_io import LevelDBWriter
from caffeonspark_tpu_torch.data.sequencefile import SequenceFileReader
from caffeonspark_tpu_torch.tools import converters as TC
from torch_port_helpers import datum_records
from torch_common import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(5):
        cv2.imwrite(str(d / f"{i:03d}.jpg"),
                    rng.randint(0, 256, (9, 7, 3), dtype=np.uint8))
    (d / "notes.txt").write_text("not an image")
    labels = tmp_path / "labels.txt"
    labels.write_text("000.jpg 3\n002.jpg 1\n004.jpg 7\n")
    return str(d), str(labels)


def _run_both(tmp_path, args, out_name):
    """Both CLIs with `args` + -output <dir>/<out_name>: the two paths."""
    paths = []
    for tag, mod in (("t", TC), ("j", JC)):
        out = str(tmp_path / tag / out_name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        assert mod.main(args + ["-output", out]) == 0
        paths.append(out)
    return paths


def _lmdb_items(reader_cls, path):
    with reader_cls(path) as r:
        return list(r.items(None, None))


def test_binary2sequence_writes_the_same_bytes(tmp_path, capsys):
    root, labels = _images(tmp_path)
    t, j = _run_both(tmp_path, ["binary2sequence", "-imageRoot", root,
                                "-labelFile", labels], "seq/part-00000")
    assert open(t, "rb").read() == open(j, "rb").read()
    recs = list(SequenceFileReader(t))
    assert [k for k, _ in recs] == [f"{i:03d}.jpg" for i in range(5)]
    assert "binary2sequence: 5 records" in capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["json", "parquet"])
def test_binary2dataframe_writes_the_same_table(tmp_path, fmt):
    if fmt == "parquet":
        pq = pytest.importorskip("pyarrow.parquet")
    root, labels = _images(tmp_path)
    t, j = _run_both(tmp_path, ["binary2dataframe", "-imageRoot", root,
                                "-labelFile", labels], f"df.{fmt}")
    if fmt == "json":
        assert open(t).read() == open(j).read()
        rows = [json.loads(x) for x in open(t)]
        assert [r["label"] for r in rows] == [3.0, -1.0, 1.0, -1.0, 7.0]
    else:
        assert pq.read_table(t).to_pylist() == pq.read_table(j).to_pylist()


def test_lmdb2sequence_and_lmdb2dataframe(tmp_path):
    db = str(tmp_path / "db")
    LmdbWriter(db).write(datum_records(7, 2, 3, 4, seed=1))
    t, j = _run_both(tmp_path, ["lmdb2sequence", "-lmdb", db], "l.seq")
    assert open(t, "rb").read() == open(j, "rb").read()
    t, j = _run_both(tmp_path, ["lmdb2dataframe", "-lmdb", db], "l.json")
    assert open(t).read() == open(j).read()
    rows = [json.loads(x) for x in open(t)]
    assert [r["id"] for r in rows] == ["%08d" % i for i in range(7)]
    assert rows[0]["channels"] == 2 and rows[0]["encoded"] is False


def test_sequence2lmdb_and_leveldb2lmdb(tmp_path):
    recs = datum_records(9, seed=2)
    db = str(tmp_path / "db")
    LmdbWriter(db).write(recs)
    seq = str(tmp_path / "in.seq")
    assert TC.main(["lmdb2sequence", "-lmdb", db, "-output", seq]) == 0
    t, j = _run_both(tmp_path, ["sequence2lmdb", "-sequence", seq], "s2l")
    assert _lmdb_items(LmdbReader, t) == _lmdb_items(JaxLmdbReader, j) \
        == recs
    ldb = str(tmp_path / "ldb")
    LevelDBWriter(ldb, snappy=True).write(recs)
    t, j = _run_both(tmp_path, ["leveldb2lmdb", "-leveldb", ldb], "l2l")
    assert _lmdb_items(LmdbReader, t) == _lmdb_items(JaxLmdbReader, j) \
        == recs


def test_cocodataset_writes_the_same_vocab_and_rows(tmp_path):
    root, _ = _images(tmp_path)
    coco = {"images": [{"id": i, "file_name": f"{i:03d}.jpg", "height": 9,
                        "width": 7} for i in range(3)],
            "annotations": [{"image_id": i % 3, "caption": c} for i, c in
                            enumerate(["a cat on a mat", "two dogs run",
                                       "a cat and a dog", "red ball"])]}
    cap = tmp_path / "captions.json"
    cap.write_text(json.dumps(coco))
    outs = []
    for tag, mod in (("t", TC), ("j", JC)):
        d = tmp_path / tag
        assert mod.main(["cocodataset", "-captionFile", str(cap),
                         "-imageRoot", root, "-vocabDir", str(d / "vocab"),
                         "-embeddingDFDir", str(d / "emb"), "-vocabSize",
                         "8", "-captionLength", "5", "-outputFormat",
                         "json"]) == 0
        outs.append(d)
    for rel in ("emb/embedding.json",
                os.path.relpath(
                    [os.path.join(p, f) for p, _, fs in
                     os.walk(outs[1] / "vocab") for f in fs][0], outs[1])):
        assert (outs[0] / rel).read_bytes() == (outs[1] / rel).read_bytes()


def test_parquet_output_is_refused_by_name_without_pyarrow(tmp_path,
                                                           monkeypatch):
    root, labels = _images(tmp_path)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        TC.main(["binary2dataframe", "-imageRoot", root, "-output",
                 str(tmp_path / "df.parquet")])
    assert TC.main(["binary2dataframe", "-imageRoot", root, "-output",
                    str(tmp_path / "df.json")]) == 0


def test_converters_run_as_a_program(tmp_path):
    root, labels = _images(tmp_path)
    out = tmp_path / "seq"
    r = subprocess.run([sys.executable, "-m",
                        "caffeonspark_tpu_torch.tools.converters",
                        "binary2sequence", "-imageRoot", root, "-labelFile",
                        labels, "-output", str(out)], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "binary2sequence: 5 records"
    assert len(list(SequenceFileReader(str(out)))) == 5
