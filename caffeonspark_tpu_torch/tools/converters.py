"""Dataset conversion tools: the spark-submit main()s of the reference
as plain CLIs (the port's copy of `caffeonspark_tpu/tools/converters.py`):

    python -m caffeonspark_tpu_torch.tools.converters <tool> ...

  * binary2sequence  (Binary2Sequence.scala:18-89): image folder + label
    file → SequenceFile of (id, Datum)
  * binary2dataframe (Binary2DataFrame.scala): same → a DataFrame
    (id, label, encoded, data)
  * lmdb2sequence / lmdb2dataframe (LMDB2{Sequence,DataFrame}.scala):
    Caffe LMDB → SequenceFile / DataFrame
  * sequence2lmdb: SequenceFile → LMDB
  * leveldb2lmdb: a Caffe LevelDB database → LMDB
  * cocodataset (CocoDataSetConverter.scala): COCO captions → caption
    rows, Vocab and LRCN embedding rows (tools/conversions.py)

A DataFrame output ending .json is written as JSON lines (binary
columns base64-encoded, as Spark's json sink writes them); any other
path is parquet, which needs pyarrow and is refused by name without it.
Label file format: one `<filename> <label>` per line (the reference's
`-labelFile`); images without an entry get label -1.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Iterator, List, Optional, Tuple

from ..data.lmdb_io import LmdbReader, LmdbWriter
from ..data.sequencefile import SequenceFileReader, SequenceFileWriter
from ..proto.caffe import Datum
from .conversions import write_rows

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def read_label_file(path: Optional[str]) -> Dict[str, float]:
    if not path:
        return {}
    labels: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                labels[parts[0]] = float(parts[1])
    return labels


def iter_image_records(image_root: str, label_file: Optional[str]
                       ) -> Iterator[Tuple[str, Datum]]:
    """(id, Datum[encoded image bytes]) per image file, sorted."""
    labels = read_label_file(label_file)
    for name in sorted(os.listdir(image_root)):
        if os.path.splitext(name)[1].lower() not in IMAGE_EXTS:
            continue
        with open(os.path.join(image_root, name), "rb") as f:
            data = f.read()
        yield name, Datum(data=data, encoded=True,
                          label=int(labels.get(name, -1)))


def binary2sequence(image_root: str, output: str,
                    label_file: Optional[str] = None) -> int:
    n = 0
    with SequenceFileWriter(output) as w:
        for name, datum in iter_image_records(image_root, label_file):
            w.append(name, datum.to_binary())
            n += 1
    return n


def binary2dataframe(image_root: str, output: str,
                     label_file: Optional[str] = None) -> int:
    rows: List[Dict] = []
    for name, datum in iter_image_records(image_root, label_file):
        rows.append({"id": name, "label": float(datum.label),
                     "encoded": True, "data": datum.data})
    write_rows(rows, output)
    return len(rows)


def lmdb2sequence(lmdb_path: str, output: str) -> int:
    n = 0
    with LmdbReader(lmdb_path) as r, SequenceFileWriter(output) as w:
        for k, v in r.items():
            w.append(k.decode("latin-1"), v)
            n += 1
    return n


def lmdb2dataframe(lmdb_path: str, output: str) -> int:
    rows: List[Dict] = []
    with LmdbReader(lmdb_path) as r:
        for k, v in r.items():
            d = Datum.from_binary(v)
            rows.append({"id": k.decode("latin-1"),
                         "label": float(d.label),
                         "channels": d.channels, "height": d.height,
                         "width": d.width, "encoded": bool(d.encoded),
                         "data": bytes(d.data)})
    write_rows(rows, output)
    return len(rows)


def sequence2lmdb(seq_path: str, output: str) -> int:
    recs = [(k.encode("latin-1"), v)
            for k, v in SequenceFileReader(seq_path)]
    LmdbWriter(output).write(recs)
    return len(recs)


def leveldb2lmdb(leveldb_path: str, output: str) -> int:
    """Migrate a Caffe LevelDB database to LMDB (the faster feed, with
    LmdbRDD-style range partitioning)."""
    from ..data.leveldb_io import LevelDBReader
    with LevelDBReader(leveldb_path) as r:
        recs = list(r.items(None, None))
    LmdbWriter(output).write(recs)
    return len(recs)


# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="cos_tools")
    sub = p.add_subparsers(dest="tool", required=True)

    b2s = sub.add_parser("binary2sequence")
    b2s.add_argument("-imageRoot", required=True)
    b2s.add_argument("-labelFile", default=None)
    b2s.add_argument("-output", required=True)

    b2d = sub.add_parser("binary2dataframe")
    b2d.add_argument("-imageRoot", required=True)
    b2d.add_argument("-labelFile", default=None)
    b2d.add_argument("-output", required=True)

    l2s = sub.add_parser("lmdb2sequence")
    l2s.add_argument("-lmdb", required=True)
    l2s.add_argument("-output", required=True)

    l2d = sub.add_parser("lmdb2dataframe")
    l2d.add_argument("-lmdb", required=True)
    l2d.add_argument("-output", required=True)

    s2l = sub.add_parser("sequence2lmdb")
    s2l.add_argument("-sequence", required=True)
    s2l.add_argument("-output", required=True)

    ldb = sub.add_parser("leveldb2lmdb")
    ldb.add_argument("-leveldb", required=True)
    ldb.add_argument("-output", required=True)

    coco = sub.add_parser(
        "cocodataset",
        description="COCO caption pipeline driver "
                    "(CocoDataSetConverter.scala:1-49 analog): "
                    "annotations json -> caption DF [-> vocab -> "
                    "LRCN embedding DF], or image-only embedding when "
                    "the json has no annotations")
    coco.add_argument("-captionFile", required=True)
    coco.add_argument("-imageRoot", required=True)
    coco.add_argument("-imageCaptionDFDir", default="",
                      help="optional: also write the caption DF here")
    coco.add_argument("-vocabDir", required=True)
    coco.add_argument("-embeddingDFDir", required=True)
    coco.add_argument("-vocabSize", type=int, default=10000)
    coco.add_argument("-captionLength", type=int, default=20)
    coco.add_argument("-outputFormat", default="parquet",
                      choices=["parquet", "json"])

    a = p.parse_args(argv)
    if a.tool == "binary2sequence":
        n = binary2sequence(a.imageRoot, a.output, a.labelFile)
    elif a.tool == "binary2dataframe":
        n = binary2dataframe(a.imageRoot, a.output, a.labelFile)
    elif a.tool == "lmdb2sequence":
        n = lmdb2sequence(a.lmdb, a.output)
    elif a.tool == "lmdb2dataframe":
        n = lmdb2dataframe(a.lmdb, a.output)
    elif a.tool == "sequence2lmdb":
        n = sequence2lmdb(a.sequence, a.output)
    elif a.tool == "leveldb2lmdb":
        n = leveldb2lmdb(a.leveldb, a.output)
    else:  # cocodataset (CocoDataSetConverter.scala:17-49 analog)
        from .conversions import (coco_to_image_caption,
                                  image_caption_to_embedding,
                                  image_to_embedding)
        from .vocab import Vocab
        rows = coco_to_image_caption(
            a.captionFile, a.imageRoot,
            os.path.join(a.imageCaptionDFDir, "captions.parquet")
            if a.imageCaptionDFDir else None)
        out_path = os.path.join(a.embeddingDFDir,
                                "embedding." + a.outputFormat)
        if rows and "caption" in rows[0]:
            # reuse an existing vocab (the fs.exists branch,
            # CocoDataSetConverter.scala:35-39) so a shared vocab stays
            # stable across dataset conversions
            if Vocab.exists(a.vocabDir):
                vocab = Vocab.load(a.vocabDir)
            else:
                vocab = Vocab.build((r["caption"] for r in rows),
                                    a.vocabSize)
                vocab.save(a.vocabDir)
            emb = image_caption_to_embedding(rows, vocab,
                                             a.captionLength, out_path)
        else:
            emb = image_to_embedding(rows, out_path)
        n = len(emb)
    print(f"{a.tool}: {n} records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
