"""The port's CLI and training engine refuse what they cannot do, and
keep their training log bounded.

  * every JAX command-line flag the port does not act on yet is refused
    by name (`Config.validate`); flags no JAX version knows still pass,
    as Spark passes its own;
  * the training log folds its device-scalar losses to host floats at
    every display / snapshot boundary (at most LOSS_FOLD_MAX steps), and
    `info.train` is what the unfolded log gave, key for key.

Everything here runs on the CPU and asserts counts and values only: no
wall-clock or thread-timing condition.
"""

import json
import os

import numpy as np
import pytest
import torch

from caffeonspark_tpu_torch import caffe_on_spark, processor
from caffeonspark_tpu_torch.config import LATER_FLAGS, Config
from caffeonspark_tpu_torch.data import LmdbWriter
from caffeonspark_tpu_torch.proto.caffe import Datum
from caffeonspark_tpu_torch.solver import Solver
from torch_common import cap_torch_threads

cap_torch_threads()

TINY_NET = """name: "Tiny"
layer {{
  name: "data" type: "MemoryData" top: "data" top: "label"
  source_class: "com.yahoo.ml.caffe.LMDB"
  transform_param {{ scale: 0.00390625 }}
  memory_data_param {{ batch_size: 4 channels: 1 height: 4 width: 4
                      source: "{src}" }}
}}
layer {{
  name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param {{ num_output: 10 weight_filler {{ type: "xavier" }} }}
}}
layer {{
  name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss"
}}
"""


def _setup(tmp_path, max_iter, extra="", records=32):
    """An LMDB of seeded 1x4x4 records, the tiny net on it and an SGD
    solver; returns the solver's path."""
    src = tmp_path / "lmdb"
    if not src.exists():
        rng = np.random.RandomState(3)
        LmdbWriter(str(src)).write([(b"%08d" % i, Datum(
            channels=1, height=4, width=4,
            data=rng.randint(0, 256, 16).astype(np.uint8).tobytes(),
            label=int(rng.randint(10))).to_binary())
            for i in range(records)])
    net = tmp_path / "net.prototxt"
    net.write_text(TINY_NET.format(src=src))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.1\nmomentum: 0.9\n'
                      f'lr_policy: "inv"\ngamma: 0.01\npower: 0.75\n'
                      f'max_iter: {max_iter}\nrandom_seed: 5\n{extra}')
    return str(solver)


def _refused_args(flag):
    dest, kind, most = LATER_FLAGS[flag]
    if kind == "switch":
        return [flag]
    if kind is int:
        return [flag, str((most or 0) + 1)]
    return [flag, "x"]


@pytest.mark.parametrize("flag", sorted(LATER_FLAGS))
def test_cli_refuses_each_jax_flag_it_lacks(tmp_path, flag):
    """Each JAX flag the port lacks is refused by name before anything
    runs, with -train and with -serve alike."""
    solver = _setup(tmp_path, 2)
    args = _refused_args(flag)
    for mode in ("-train", "-serve"):
        with pytest.raises(ValueError, match=f"^{flag}.*a later slice of "
                                             "the PyTorch port"):
            caffe_on_spark.main(["-conf", solver, mode, "-output",
                                 str(tmp_path / "out"), "-device", "cpu",
                                 *args])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("args", [
    ["-devices", "1"], ["-devices", "0"], ["-rank", "0"],
    ["-serveReplicas", "1"], ["-spark.executor.cores", "4"],
    ["--spark-conf", "a=b"]])
def test_cli_takes_one_process_values_and_unknown_flags(tmp_path, args):
    """What a one-process run is (one device, rank 0, one replica)
    passes, and so do flags no JAX version knows (Spark's own)."""
    solver = _setup(tmp_path, 2)
    Config(["-conf", solver, "-train", "-device", "cpu", *args]).validate()


def _recording_run(tmp_path, monkeypatch, max_iter, extra):
    """Train through the CLI, recording before each step how many losses
    of the log are still device tensors, and each step's (loss, lr) as
    the solver returned them.  Returns (live counts, records, info)."""
    live, recs = [], []
    real = Solver.train_step

    def step(self, *a):
        log = processor.CaffeProcessor._instance.train_log
        live.append(sum(isinstance(x[1], torch.Tensor) for x in log))
        loss, out = real(self, *a)
        recs.append((loss.detach().clone(), float(out["lr"])))
        return loss, out

    monkeypatch.setattr(Solver, "train_step", step)
    path = tmp_path / "metrics.json"
    monkeypatch.setenv("COS_PIPELINE_METRICS", str(path))
    solver = _setup(tmp_path, max_iter, extra)
    assert caffe_on_spark.main(["-conf", solver, "-train", "-output",
                                str(tmp_path / "out"), "-device",
                                "cpu"]) == 0
    return live, recs, json.load(open(path))["info"]["train"]


def test_train_info_is_unchanged_by_folding(tmp_path, monkeypatch):
    """info.train after folding equals what the unfolded log gave (every
    step's loss tensor stacked at the end), key for key and value for
    value; `t` holds one increasing host time per step."""
    live, recs, info = _recording_run(tmp_path, monkeypatch, 7,
                                      "display: 3\n")
    want = {"iter": list(range(1, 8)),
            "loss": torch.stack([x[0] for x in recs]).cpu().tolist(),
            "lr": [x[1] for x in recs], "batch": 4, "device": "cpu"}
    assert sorted(info) == sorted(list(want) + ["t"])
    for key, value in want.items():
        assert info[key] == value, key
    assert len(info["t"]) == 7 and info["t"] == sorted(info["t"])
    assert live == [0, 1, 2, 0, 1, 2, 0]


@pytest.mark.parametrize("extra,fold_max,bound", [
    ("display: 25\n", None, 25), ("snapshot: 40\n", None, 40),
    ("display: 30\nsnapshot: 45\n", None, 30), ("", 16, 16),
    ("display: 50\n", 16, 16)])
def test_training_log_stays_bounded(tmp_path, monkeypatch, extra, fold_max,
                                    bound):
    """Over 300 tiny steps the log never holds more device losses than
    the fold interval: the display / snapshot boundary, or LOSS_FOLD_MAX
    (cut to 16 in some cases here) when that comes sooner; every loss
    comes out as the step returned it."""
    if fold_max is not None:
        monkeypatch.setattr(processor, "LOSS_FOLD_MAX", fold_max)
    live, recs, info = _recording_run(tmp_path, monkeypatch, 300, extra)
    assert len(live) == 300
    assert max(live) == bound - 1
    assert info["loss"] == [float(x[0]) for x in recs]
    assert all(np.isfinite(info["loss"]))
