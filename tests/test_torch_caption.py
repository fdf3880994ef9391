"""The caption pipeline of the PyTorch port against the JAX package:
`tools/vocab.py`, `tools/conversions.py` and the three decoders of
`tools/image_caption.py`, on the tiny LRCN captioner of
tests/test_lrcn.py (Embed, an LSTM with the image features as its
static input, the per-step classifier).

  * Vocab files are byte-equal, and so are the ids and texts;
  * the conversions' rows are equal, and their JSON-lines files
    byte-equal; parquet is refused by name where pyarrow is missing;
  * the captioner trained in JAX (400 Adam steps, as test_lrcn.py
    trains it) and carried across as numpy: greedy, incremental and
    beam (1 and 3) ids equal to the JAX decoders' (the trained model's
    top-1 / top-2 probability margins are far from ties);
  * test_lrcn.py's memorize-and-decode, trained in the port: at least 3
    of the 4 captions come back, the incremental decoder and beam 1
    equal greedy, beam 3 still gives at least 3.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffeonspark_tpu.net import Net as JaxNet
from caffeonspark_tpu.proto import NetParameter as JaxNetParameter
from caffeonspark_tpu.proto import NetState as JaxNetState
from caffeonspark_tpu.proto import SolverParameter as JaxSolverParameter
from caffeonspark_tpu.solver import Solver as JaxSolver
from caffeonspark_tpu.tools import conversions as jconv
from caffeonspark_tpu.tools import image_caption as jcap
from caffeonspark_tpu.tools import vocab as jvocab
from caffeonspark_tpu_torch import convert
from caffeonspark_tpu_torch.net import Net
from caffeonspark_tpu_torch.proto import (NetParameter, NetState, Phase,
                                          SolverParameter)
from caffeonspark_tpu_torch.solver import Solver
from caffeonspark_tpu_torch.tools import conversions, image_caption, vocab
from torch_common import cap_torch_threads

cap_torch_threads()

CAPTIONS = [
    "a dog runs in the park",
    "a cat sits on the mat",
    "the bird flies over water",
    "a fish swims in the sea",
]
T = 9            # caption_length 8 + 1
VOCAB = 24
EMBED = 24
LSTM_N = 48
FEAT = 8

# tests/test_lrcn.py's nets
TRAIN_NET = f"""
name: "tiny_lrcn"
layer {{ name: "data" type: "CoSData"
  top: "image_features" top: "cont_sentence" top: "input_sentence"
  top: "target_sentence"
  cos_data_param {{ batch_size: 4
    top {{ name: "image_features" type: FLOAT_ARRAY channels: {FEAT}
          sample_num_axes: 1 }}
    top {{ name: "cont_sentence" type: INT_ARRAY channels: {T}
          sample_num_axes: 1 transpose: true }}
    top {{ name: "input_sentence" type: INT_ARRAY channels: {T}
          sample_num_axes: 1 transpose: true }}
    top {{ name: "target_sentence" type: INT_ARRAY channels: {T}
          sample_num_axes: 1 transpose: true }} }} }}
layer {{ name: "embedding" type: "Embed" bottom: "input_sentence"
  top: "embedded_input_sentence"
  embed_param {{ input_dim: {VOCAB} num_output: {EMBED} bias_term: false
    weight_filler {{ type: "uniform" min: -0.08 max: 0.08 }} }} }}
layer {{ name: "lstm1" type: "LSTM" bottom: "embedded_input_sentence"
  bottom: "cont_sentence" bottom: "image_features" top: "lstm1"
  recurrent_param {{ num_output: {LSTM_N}
    weight_filler {{ type: "uniform" min: -0.08 max: 0.08 }}
    bias_filler {{ type: "constant" }} }} }}
layer {{ name: "predict" type: "InnerProduct" bottom: "lstm1"
  top: "predict"
  inner_product_param {{ num_output: {VOCAB} axis: 2
    weight_filler {{ type: "uniform" min: -0.08 max: 0.08 }} }} }}
layer {{ name: "cross_entropy_loss" type: "SoftmaxWithLoss"
  bottom: "predict" bottom: "target_sentence" top: "cross_entropy_loss"
  loss_weight: {T}.0
  loss_param {{ ignore_label: -1 }}
  softmax_param {{ axis: 2 }} }}
"""
DEPLOY_NET = TRAIN_NET.split('layer { name: "cross_entropy_loss"')[0] + """
layer { name: "probs" type: "Softmax" bottom: "predict" top: "probs"
  softmax_param { axis: 2 } }
"""
SOLVER = ("base_lr: 0.05 momentum: 0.9 lr_policy: 'fixed' max_iter: 400 "
          "clip_gradients: 5 random_seed: 2 type: 'ADAM'")
STEPS = 400
EXPECT = [" ".join(c.lower().split()) for c in CAPTIONS]


def _dataset(voc_mod, conv_mod):
    voc = voc_mod.Vocab.build(CAPTIONS, VOCAB)
    feats = np.random.RandomState(0).rand(4, FEAT).astype(np.float32)
    rows = [{"id": str(i), "caption": c} for i, c in enumerate(CAPTIONS)]
    emb = conv_mod.image_caption_to_embedding(rows, voc,
                                              caption_length=T - 1)
    return voc, feats, emb


def _batch(feats, emb):
    def col(k):
        return np.stack([e[k] for e in emb]).T.astype(np.float32)
    return {"image_features": feats, "cont_sentence": col("cont_sentence"),
            "input_sentence": col("input_sentence"),
            "target_sentence": col("target_sentence")}


# ---------------------------------------------------------------------------
# Vocab and the conversions
# ---------------------------------------------------------------------------

TIES = ["b a c", "a b d", "c d e", "It's a DOG's life, 42 times!"]


@pytest.mark.parametrize("size", [3, 6, 100])
def test_vocab_files_are_byte_equal(size, tmp_path):
    ours = vocab.Vocab.build(TIES + CAPTIONS, size)
    ref = jvocab.Vocab.build(TIES + CAPTIONS, size)
    ours.save(str(tmp_path / "ours"))
    ref.save(str(tmp_path / "ref.txt"))
    assert ((tmp_path / "ours" / "vocab.txt").read_bytes()
            == (tmp_path / "ref.txt").read_bytes())
    loaded = vocab.Vocab.load(str(tmp_path / "ref.txt"))
    assert loaded.words == ref.words and len(loaded) == len(ref)
    for text in TIES + ["zebra crossing the park"]:
        assert vocab.tokenize(text) == jvocab.tokenize(text)
        ids = loaded.encode(text)
        assert ids == ref.encode(text)
        assert loaded.decode(ids + [0, 5]) == ref.decode(ids + [0, 5])
    assert (vocab.START_END_ID, vocab.UNK_ID, vocab.FIRST_WORD_ID) == (
        0, 1, 2)
    assert vocab.Vocab.exists(str(tmp_path / "ours"))


@pytest.fixture()
def coco(tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    ims = []
    for i in range(3):
        (images / f"im{i}.jpg").write_bytes(bytes(range(i, i + 40)))
        ims.append({"id": 10 + i, "file_name": f"im{i}.jpg",
                    "height": 20 + i, "width": 30 + i})
    ims.append({"id": 99, "file_name": "missing.jpg"})
    anns = [{"image_id": 10 + (i % 3), "caption": c}
            for i, c in enumerate(CAPTIONS + TIES)]
    anns.append({"image_id": 1234, "caption": "no such image"})
    with_caps = tmp_path / "captions.json"
    with_caps.write_text(json.dumps({"images": ims, "annotations": anns}))
    no_caps = tmp_path / "images.json"
    no_caps.write_text(json.dumps({"images": ims}))
    return str(with_caps), str(no_caps), str(images)


def test_conversions_rows_and_files_equal(coco, tmp_path):
    with_caps, no_caps, images = coco
    for ann, embed in ((with_caps, True), (no_caps, True),
                       (with_caps, False)):
        ours = conversions.coco_to_image_caption(
            ann, images, embed_image_bytes=embed)
        ref = jconv.coco_to_image_caption(ann, images,
                                          embed_image_bytes=embed)
        assert ours == ref
    rows = conversions.coco_to_image_caption(with_caps, images)
    voc = vocab.Vocab.build([r["caption"] for r in rows], 12)
    jvoc = jvocab.Vocab.build([r["caption"] for r in rows], 12)
    for length in (3, 8, 20):
        emb = conversions.image_caption_to_embedding(rows, voc, length)
        assert emb == jconv.image_caption_to_embedding(rows, jvoc, length)
        assert all(len(e["input_sentence"]) == length + 1 for e in emb)
        assert (conversions.embedding_to_caption(emb, voc)
                == jconv.embedding_to_caption(emb, jvoc))
    assert (conversions.image_to_embedding(rows)
            == jconv.image_to_embedding(rows))
    conversions.image_caption_to_embedding(
        rows, voc, 8, output_path=str(tmp_path / "ours.json"))
    jconv.image_caption_to_embedding(rows, jvoc, 8,
                                     output_path=str(tmp_path / "ref.json"))
    assert ((tmp_path / "ours.json").read_bytes()
            == (tmp_path / "ref.json").read_bytes())
    with pytest.raises(ValueError, match="no rows"):
        conversions.write_rows([], str(tmp_path / "empty.json"))


def test_parquet_rows_round_trip(coco, tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    with_caps, _, images = coco
    path = str(tmp_path / "rows.parquet")
    rows = conversions.coco_to_image_caption(with_caps, images,
                                             output_path=path)
    assert pq.read_table(path).to_pylist() == rows


def test_parquet_without_pyarrow_is_refused_by_name(coco, tmp_path,
                                                    monkeypatch):
    with_caps, _, images = coco
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    path = tmp_path / "rows.parquet"
    with pytest.raises(ImportError, match="pyarrow"):
        conversions.coco_to_image_caption(with_caps, images,
                                          output_path=str(path))
    assert not path.exists()
    # JSON lines need no pyarrow
    conversions.coco_to_image_caption(with_caps, images,
                                      output_path=str(tmp_path / "r.json"))


# ---------------------------------------------------------------------------
# the decoders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trained():
    """The captioner trained in JAX, as test_lrcn.py trains it; its
    params as numpy."""
    _, feats, emb = _dataset(jvocab, jconv)
    s = JaxSolver(JaxSolverParameter.from_text(SOLVER),
                  JaxNetParameter.from_text(TRAIN_NET))
    params, st = s.init()
    step = s.jit_train_step()
    batch = {k: jnp.asarray(v) for k, v in _batch(feats, emb).items()}
    for i in range(STEPS):
        params, st, _ = step(params, st, batch, s.step_rng(i))
    return feats, {ln: {bn: np.asarray(a) for bn, a in bl.items()}
                   for ln, bl in params.items()}


def test_decoders_match_jax_on_a_jax_trained_captioner(jax_trained):
    feats, arrays = jax_trained
    jp = {ln: {bn: jnp.asarray(a) for bn, a in bl.items()}
          for ln, bl in arrays.items()}
    jdeploy = JaxNet(JaxNetParameter.from_text(DEPLOY_NET),
                     JaxNetState(phase=int(Phase.TEST)))
    deploy = Net(NetParameter.from_text(DEPLOY_NET),
                 NetState(phase=Phase.TEST), device="cpu")
    tp = convert.params_from_numpy(deploy, arrays)
    rows = []
    got = image_caption.greedy_caption(deploy, tp, feats, max_length=T - 1,
                                       step_probs=rows)
    want = jcap.greedy_caption(jdeploy, jp, feats, max_length=T - 1)
    assert got == want
    # the comparison is not at a near-tie
    margins = [np.diff(np.sort(r, axis=-1)[:, -2:], axis=-1).min()
               for r in rows]
    assert min(margins) > 1e-3, margins
    kw = dict(batch=4, max_length=T - 1)
    extra = {"image_features": feats}
    assert image_caption.incremental_greedy_caption(
        NetParameter.from_text(DEPLOY_NET), tp, extra, device="cpu",
        **kw) == jcap.incremental_greedy_caption(
        JaxNetParameter.from_text(DEPLOY_NET), jp, extra, **kw) == want
    for beam in (1, 3):
        assert image_caption.beam_caption(
            NetParameter.from_text(DEPLOY_NET), tp, extra, beam=beam,
            device="cpu", **kw) == jcap.beam_caption(
            JaxNetParameter.from_text(DEPLOY_NET), jp, extra, beam=beam,
            **kw)


def test_lrcn_memorizes_and_decodes():
    """tests/test_lrcn.py:95, trained in the port."""
    voc, feats, emb = _dataset(vocab, conversions)
    s = Solver(SolverParameter.from_text(SOLVER),
               NetParameter.from_text(TRAIN_NET), device="cpu")
    params, st = s.init()
    batch = {k: torch.from_numpy(v) for k, v in _batch(feats, emb).items()}
    losses = [float(s.train_step(params, st, batch)[0])
              for _ in range(STEPS)]
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])
    deploy = Net(NetParameter.from_text(DEPLOY_NET),
                 NetState(phase=Phase.TEST), device="cpu")
    seqs = image_caption.greedy_caption(deploy, params, feats,
                                        max_length=T - 1)
    texts = image_caption.captions_to_text(seqs, voc)
    assert sum(t == e for t, e in zip(texts, EXPECT)) >= 3, texts
    kw = dict(batch=4, max_length=T - 1, device="cpu")
    extra = {"image_features": feats}
    assert image_caption.incremental_greedy_caption(
        NetParameter.from_text(DEPLOY_NET), params, extra, **kw) == seqs
    assert image_caption.beam_caption(
        NetParameter.from_text(DEPLOY_NET), params, extra, beam=1,
        **kw) == seqs
    b3 = image_caption.captions_to_text(image_caption.beam_caption(
        NetParameter.from_text(DEPLOY_NET), params, extra, beam=3, **kw),
        voc)
    assert sum(t == e for t, e in zip(b3, EXPECT)) >= 3, b3


def test_expose_lstm_states_builds_a_stepped_net():
    stepped = image_caption.expose_lstm_states(
        NetParameter.from_text(DEPLOY_NET), batch=6)
    net = Net(stepped, NetState(phase=Phase.TEST), device="cpu")
    shapes = dict((n, s) for n, s, _ in net.input_specs)
    assert shapes["lstm1__h0"] == shapes["lstm1__c0"] == (1, 6, LSTM_N)
    assert shapes["input_sentence"] == shapes["cont_sentence"] == (1, 6)
    assert net.blob_shapes["lstm1__hT"] == (1, 6, LSTM_N)
    assert net.blob_shapes["probs"] == (1, 6, VOCAB)
    assert "expose_hidden" not in DEPLOY_NET      # the source is untouched
