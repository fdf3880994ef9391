"""Image-caption inference over a trained LRCN captioner.

The port's counterpart of `caffeonspark_tpu/tools/image_caption.py`
(Caffe's `ImageCaption.py` example):

  * `greedy_caption`: each decode step runs the full-sequence forward on
    the padded prefix (cont-gated, so positions past the prefix are
    inert) and takes the prediction at the last real position;
  * `incremental_greedy_caption` and `beam_caption`: a stepped copy of
    the net (`expose_lstm_states`: every LSTM exposes its states, the
    sequence tops shrink to one step) advances the recurrence one token
    a forward, O(T) in all; beams' states are gathered by parent index
    on the device.

Every forward runs in eval mode (Caffe's TEST semantics, no autograd)
on the net's device; each step reads back only the one probability row
(B, V) it needs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..net import Net
from ..proto.caffe import BlobShape, NetParameter, NetState, Phase
from .vocab import START_END_ID, Vocab


def _dev(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(device)


def greedy_caption(net: Net, params, image_features, *,
                   prob_blob: str = "probs",
                   input_blob: str = "input_sentence",
                   cont_blob: str = "cont_sentence",
                   feature_blob: str = "image_features",
                   max_length: int = 20,
                   step_probs: Optional[list] = None) -> List[List[int]]:
    """Captions for a batch of image feature vectors, through `net` (a
    deploy net shaped as lrcn_word_to_preds.deploy.prototxt: inputs
    input_sentence (T, B), cont_sentence (T, B), image_features (B, F),
    output `prob_blob` (T, B, V)) on its device.  Returns each image's
    ids up to the first END (excluded).  `step_probs`, when given,
    receives each step's probability rows (B, V) as read back."""
    b = image_features.shape[0]
    t_max = max_length + 1
    feats = _dev(image_features, net.device)
    ids = np.zeros((b, t_max), np.int64)      # step 0 = START marker (0)
    done = np.zeros((b,), bool)
    tpos = np.arange(t_max)[:, None]
    for t in range(1, t_max):
        # cont: 0 at the sequence start, 1 on the live prefix, 0 past it
        cont = np.broadcast_to(((tpos > 0) & (tpos < t)), (t_max, b))
        inputs = {input_blob: _dev(ids.T, net.device),
                  cont_blob: _dev(cont, net.device),
                  feature_blob: feats}
        with torch.inference_mode():
            probs = net(params, inputs)[prob_blob][t - 1].float().cpu()
        probs = probs.numpy()
        if step_probs is not None:
            step_probs.append(probs)
        nxt = np.where(done, 0, probs.argmax(axis=-1))
        ids[:, t] = nxt
        done |= nxt == START_END_ID
        if done.all():
            break
    return _trim_sequences(ids)


def expose_lstm_states(net_param: NetParameter, *, batch: int,
                       time_steps: int = 1) -> NetParameter:
    """A stepped copy of a deploy NetParameter: every LSTM gets
    `expose_hidden` with `<name>__h0/__c0` net inputs and
    `<name>__hT/__cT` tops, and the time-major CoSData tops shrink to
    `time_steps`, so one forward advances the recurrence by that many
    steps."""
    npm = net_param.clone()
    # legacy `input_dim:` nets: input_shape for all inputs before the
    # state inputs are appended
    if npm.input and not npm.input_shape and npm.input_dim:
        dims = list(npm.input_dim)
        for i in range(len(npm.input)):
            npm.input_shape.append(BlobShape(dim=dims[4 * i:4 * i + 4]))
        npm.clear("input_dim")
    for lyr in npm.layer:
        if lyr.type == "CoSData":
            for top in lyr.cos_data_param.top:
                if top.transpose:
                    top.channels = time_steps
            lyr.cos_data_param.batch_size = batch
        if lyr.type != "LSTM":
            continue
        rp = lyr.recurrent_param
        rp.expose_hidden = True
        n = int(rp.num_output)
        h0, c0 = f"{lyr.name}__h0", f"{lyr.name}__c0"
        lyr.bottom.extend([h0, c0])
        lyr.top.extend([f"{lyr.name}__hT", f"{lyr.name}__cT"])
        for name in (h0, c0):
            npm.input.append(name)
            npm.input_shape.append(BlobShape(dim=[1, batch, n]))
    return npm


def _make_stepper(net_param: NetParameter, batch: int, prob_blob: str,
                  device):
    """(lstm names, zero states on `device`, forward): forward(params,
    inputs) -> (probs (1, B, V), {"<lstm>__h" / "__c": state tops})."""
    stepped = expose_lstm_states(net_param, batch=batch, time_steps=1)
    net = Net(stepped, NetState(phase=Phase.TEST), device=device)
    lstms = [lp for lp in net.compute_layers if lp.type == "LSTM"]
    names = [lp.name for lp in lstms]

    def forward(params, inputs):
        with torch.inference_mode():
            blobs = net(params, inputs)
        return (blobs[prob_blob],
                {f"{nme}__{s}": blobs[f"{nme}__{s}T"]
                 for nme in names for s in ("h", "c")})

    states = {f"{lp.name}__{s}0": torch.zeros(
        (1, batch, int(lp.recurrent_param.num_output)), device=net.device)
        for lp in lstms for s in ("h", "c")}
    return names, states, forward


def _step_inputs(words, t, input_blob, cont_blob, device):
    n = words.shape[0]
    return {input_blob: _dev(words.reshape(1, n), device),
            cont_blob: torch.full((1, n), 0.0 if t == 1 else 1.0,
                                  device=device)}


def incremental_greedy_caption(net_param: NetParameter, params,
                               extra_inputs: Dict, *, batch: int,
                               prob_blob: str = "probs",
                               input_blob: str = "input_sentence",
                               cont_blob: str = "cont_sentence",
                               max_length: int = 20, device="cuda",
                               step_probs: Optional[list] = None
                               ) -> List[List[int]]:
    """Greedy decode stepping the recurrence one token a forward;
    `extra_inputs` carries the non-sequence inputs (image features),
    `params` live on `device`.  `step_probs` as in `greedy_caption`."""
    names, states, forward = _make_stepper(net_param, batch, prob_blob,
                                           device)
    device = torch.device(device)
    fixed = {k: _dev(v, device) for k, v in extra_inputs.items()}
    ids = np.zeros((batch, max_length + 1), np.int64)
    done = np.zeros((batch,), bool)
    for t in range(1, max_length + 1):
        probs_dev, new_states = forward(params, {
            **_step_inputs(ids[:, t - 1], t, input_blob, cont_blob, device),
            **fixed, **states})
        probs = probs_dev[0].float().cpu().numpy()
        if step_probs is not None:
            step_probs.append(probs)
        nxt = np.where(done, 0, probs.argmax(axis=-1))
        ids[:, t] = nxt
        done |= nxt == START_END_ID
        states = {f"{nme}__{s}0": new_states[f"{nme}__{s}"]
                  for nme in names for s in ("h", "c")}
        if done.all():
            break
    return _trim_sequences(ids)


def beam_caption(net_param: NetParameter, params, extra_inputs: Dict, *,
                 batch: int, beam: int = 3,
                 prob_blob: str = "probs",
                 input_blob: str = "input_sentence",
                 cont_blob: str = "cont_sentence",
                 max_length: int = 20, device="cuda") -> List[List[int]]:
    """Beam search over the incremental stepper, batched: all B·K beams
    advance in one forward a step, and the LSTM states are gathered by
    parent beam on the device.  A finished beam extends only with END,
    at no cost; the best-scoring beam of each image is returned."""
    bk = batch * beam
    names, states, forward = _make_stepper(net_param, bk, prob_blob, device)
    device = torch.device(device)
    # every beam of an image shares its feature vector
    fixed = {k: _dev(np.repeat(np.asarray(v), beam, axis=0), device)
             for k, v in extra_inputs.items()}
    neg = -1e30
    scores = np.full((batch, beam), neg, np.float64)
    scores[:, 0] = 0.0                 # beams start identical: one live
    ids = np.zeros((batch, beam, max_length + 1), np.int64)
    finished = np.zeros((batch, beam), bool)
    for t in range(1, max_length + 1):
        probs_dev, new_states = forward(params, {
            **_step_inputs(ids[:, :, t - 1].reshape(bk), t, input_blob,
                           cont_blob, device),
            **fixed, **states})
        logp = np.log(np.maximum(probs_dev[0].float().cpu().numpy(),
                                 1e-20))
        v = logp.shape[-1]
        logp = logp.reshape(batch, beam, v)
        fin_row = np.full((v,), neg)
        fin_row[START_END_ID] = 0.0
        cand = np.where(finished[:, :, None],
                        scores[:, :, None] + fin_row[None, None, :],
                        scores[:, :, None] + logp)
        flat = cand.reshape(batch, beam * v)
        top = np.argsort(-flat, axis=1)[:, :beam]
        parent, word = top // v, top % v
        scores = np.take_along_axis(flat, top, axis=1)
        ids = np.take_along_axis(ids, parent[:, :, None], axis=1)
        ids[:, :, t] = word
        finished = np.take_along_axis(finished, parent, axis=1) \
            | (word == START_END_ID)
        parent_global = torch.as_tensor(
            (np.arange(batch)[:, None] * beam + parent).reshape(bk)).to(
            device)
        states = {f"{nme}__{s}0": torch.index_select(
            new_states[f"{nme}__{s}"], 1, parent_global)
            for nme in names for s in ("h", "c")}
        if finished.all():
            break
    best = scores.argmax(axis=1)
    return _trim_sequences(ids[np.arange(batch), best])


def _trim_sequences(ids: np.ndarray) -> List[List[int]]:
    """ids (B, T+1) with column 0 = START → END-trimmed id lists."""
    out: List[List[int]] = []
    for row in ids:
        seq = []
        for w in row[1:]:
            if int(w) == START_END_ID:
                break
            seq.append(int(w))
        out.append(seq)
    return out


def captions_to_text(id_seqs: Sequence[Sequence[int]], vocab: Vocab
                     ) -> List[str]:
    return [vocab.decode(seq) for seq in id_seqs]
