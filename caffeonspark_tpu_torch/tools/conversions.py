"""COCO caption pipeline conversions.

The port's copy of `caffeonspark_tpu/tools/conversions.py` (Caffe's
`caffe-grid/.../tools/Conversions.scala`):
  * `coco_to_image_caption` (:31-87 Coco2ImageCaptionFile): COCO
    annotation json + image dir → caption rows (id, image bytes, height,
    width, caption)
  * `image_caption_to_embedding` (:146-207 ImageCaption2Embedding):
    caption rows + Vocab → the LRCN training arrays — input_sentence =
    [0, w1..wN] (start marker then words), target_sentence = [w1..wN, 0]
    (words then end marker, padded with -1), cont_sentence = [0, 1, 1,
    ...] (0 marks the sequence start), each padded/truncated to
    caption_length+1
  * `image_to_embedding` (:107-137 Image2Embedding): caption-less rows
    for decoding
  * `embedding_to_caption` (:209-229 Embedding2Caption): the inverse
    mapping

Each writes its rows when given `output_path`: JSON lines for a path
ending .json (binary columns base64-encoded, as Spark's json sink does),
else parquet, which needs pyarrow and is refused by name without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

from .vocab import START_END_ID, Vocab


def coco_to_image_caption(annotation_json: str, image_root: str,
                          output_path: Optional[str] = None,
                          *, embed_image_bytes: bool = True) -> List[Dict]:
    """COCO captions_*.json → rows (id, data, height, width, caption),
    one a caption; one row an image when the file has no annotations."""
    with open(annotation_json) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco.get("images", [])}

    def base_row(im):
        row = {"id": str(im["id"]),
               "height": int(im.get("height", 0)),
               "width": int(im.get("width", 0))}
        fname = os.path.join(image_root, im["file_name"])
        if embed_image_bytes and os.path.exists(fname):
            with open(fname, "rb") as imf:
                row["data"] = imf.read()
        else:
            row["data"] = b""
        return row

    rows: List[Dict] = []
    if coco.get("annotations"):
        for ann in coco["annotations"]:
            im = images.get(ann["image_id"])
            if im is None:
                continue
            row = base_row(im)
            row["caption"] = ann["caption"]
            rows.append(row)
    else:
        rows = [base_row(im) for im in coco.get("images", [])]
    if output_path:
        write_rows(rows, output_path)
    return rows


def image_caption_to_embedding(caption_rows: Iterable[Dict], vocab: Vocab,
                               caption_length: int = 20,
                               output_path: Optional[str] = None
                               ) -> List[Dict]:
    """Caption rows → LRCN embedding rows with input/cont/target arrays
    of length caption_length+1.  The target pads with -1, which the
    loss ignores (lrcn_cos.prototxt's ignore_label: -1): padding with 0
    would make the padded positions look like the sequence start."""
    length = caption_length + 1
    out: List[Dict] = []
    for row in caption_rows:
        ids = vocab.encode(row["caption"])[:caption_length]
        n = len(ids)
        input_sentence = [START_END_ID] + ids + [0] * (length - n - 1)
        target_sentence = ids + [START_END_ID] + [-1] * (length - n - 1)
        cont_sentence = [0] + [1] * n + [0] * (length - n - 1)
        erow = dict(row)
        erow.pop("caption", None)
        erow.update(input_sentence=input_sentence,
                    target_sentence=target_sentence,
                    cont_sentence=cont_sentence,
                    label=0.0)
        out.append(erow)
    if output_path:
        write_rows(out, output_path)
    return out


def image_to_embedding(caption_rows: Iterable[Dict],
                       output_path: Optional[str] = None) -> List[Dict]:
    """Caption-less rows → embedding rows (id, image data, label 0): the
    image-only input of caption generation."""
    out: List[Dict] = []
    for row in caption_rows:
        erow = dict(row)
        erow.pop("caption", None)
        erow["label"] = 0.0
        out.append(erow)
    if output_path:
        write_rows(out, output_path)
    return out


def embedding_to_caption(embedding_rows: Iterable[Dict], vocab: Vocab
                         ) -> List[Dict]:
    """Inverse: target_sentence ids → caption text."""
    return [{"id": row.get("id"),
             "caption": vocab.decode(row["target_sentence"])}
            for row in embedding_rows]


def write_rows(rows: List[Dict], path: str) -> None:
    """Row dicts → JSON lines (a path ending .json; binary columns
    base64-encoded) or parquet (needs pyarrow)."""
    if not rows:
        raise ValueError(f"no rows to write to {path} (empty input?)")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".json"):
        import base64
        with open(path, "w") as f:
            for r in rows:
                enc = {k: (base64.b64encode(v).decode("ascii")
                           if isinstance(v, (bytes, bytearray)) else v)
                       for k, v in r.items()}
                f.write(json.dumps(enc) + "\n")
        return
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            f"{path!r}: writing a parquet DataFrame needs pyarrow, which is "
            "not installed (give a path ending .json for JSON lines)") from e
    pq.write_table(pa.table({k: [r.get(k) for r in rows]
                             for k in rows[0]}), path)
