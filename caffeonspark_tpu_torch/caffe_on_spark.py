"""CLI entry point: `python -m caffeonspark_tpu_torch.caffe_on_spark`.

The `-train` and `-serve` modes of the JAX package's command line, on
PyTorch, on the card unless `-device cpu`:

    python -m caffeonspark_tpu_torch.caffe_on_spark -conf solver.prototxt \\
        -train -output out/ [-weights init.caffemodel | -snapshot x.solverstate]

parses the prototxts, opens the TRAIN data layer's LMDB, streams its
records (a seeded shuffle per epoch) through the bounded feed queue into
the TRAIN-phase transformer, and runs Caffe's solver for max_iter steps
(`CaffeOnSpark.train` -> `CaffeProcessor`).  Snapshots land at the
`snapshot` interval and after training; the final model goes to
`-model` (default `<output>/model.caffemodel`), which -serve loads.
`-mesh 1,1,4` trains on a mesh with an sp axis of 4 ranks (the JAX
CLI's grammar dp,tp,sp): every MultiHeadAttention runs as a ring over
time blocks, the ranks all on `-device`'s card (parallel/sp.py).


    python -m caffeonspark_tpu_torch.caffe_on_spark -conf solver.prototxt \\
        -serve -model m.caffemodel -features fc8

builds the TEST-phase net, loads the .caffemodel, warms every batch
bucket, starts the micro-batcher and the HTTP front end, and prints one
boot line of JSON (`{"serving": true, "port": N, "model_version": V,
"buckets": [...]}`) on stdout.  SIGINT or SIGTERM drains accepted work
and exits 0; COS_SERVE_METRICS=path dumps the serving metrics there at
shutdown.  Interleaved validation (trainWithValidation), -test and
-features come with later slices.
"""

from __future__ import annotations

import json
import os
import signal
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .config import Config
from .data.source import DataSource, get_source
from .processor import CaffeProcessor
from .serving import InferenceService, ServingHTTPServer


def _serve_signals_drain() -> None:
    """Route SIGTERM (and Ctrl-C) onto the drain-then-exit path."""
    def handler(signum, frame):
        raise KeyboardInterrupt
    try:
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        pass                  # not the main thread (embedded): skip


def start_server(conf: Config) -> Tuple[InferenceService, ServingHTTPServer]:
    """Build, load and warm the service and bind its HTTP front end
    (not yet serving: call `serve_forever` or `start_background`)."""
    svc = InferenceService(conf)   # loads -weights, else -model
    svc.start()
    try:
        httpd = ServingHTTPServer(svc, host=conf.serveHost,
                                  port=conf.servePort)
    except BaseException:
        svc.stop(drain=False)
        raise
    return svc, httpd


def serve_main(conf: Config) -> int:
    """-serve mode: runs until interrupted, then drains."""
    _serve_signals_drain()
    svc, httpd = start_server(conf)
    try:
        print(json.dumps({"serving": True, "port": httpd.port,
                          "model_version": svc.registry.version,
                          "buckets": list(svc.batcher.buckets)}),
              flush=True)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        svc.stop(drain=True)
        path = os.environ.get("COS_SERVE_METRICS")
        if path:
            with open(path, "w") as f:
                json.dump(svc.metrics_summary(), f, indent=2,
                          sort_keys=True)
                f.write("\n")
    return 0


class CaffeOnSpark:
    """Driver facade on the local engine (one process, one device)."""

    def train(self, source: DataSource, conf: Config) -> None:
        """Synchronous training (CaffeOnSpark.train): the processor's
        solver thread runs max_iter steps while this thread feeds it the
        source's records, epoch after epoch, until it stops."""
        proc = CaffeProcessor.instance(conf)
        proc.start()
        try:
            gen = _record_loop(source, persistent=conf.isPersistent)
            while proc._thread is not None and proc._thread.is_alive():
                if not proc.feed_queue(0, next(gen)):
                    break
        finally:
            proc.queues[0].offer(None)
            proc.join()


def _record_loop(source: DataSource, persistent: bool = False
                 ) -> Iterator[tuple]:
    """Endless record generator (the repeated RDD re-feed); TRAIN-phase
    sources emit a per-epoch shuffled order.  With `persistent` epoch 0
    keeps the decoded records in memory and later epochs re-serve them
    in a seeded per-epoch order instead of re-reading the store."""
    epoch = 0
    cache: Optional[List] = [] if persistent else None
    while True:
        n = 0
        if cache and epoch > 0:
            if source.phase_train:
                rng = np.random.RandomState(source.epoch_seed(epoch))
                order = rng.permutation(len(cache))
            else:
                order = range(len(cache))
            for i in order:
                n += 1
                yield cache[i]
        else:
            records = (source.shuffled_records(epoch)
                       if source.phase_train else source.records())
            for rec in records:
                n += 1
                if cache is not None:
                    cache.append(rec)
                yield rec
        if n == 0:
            raise ValueError("data source produced no records")
        epoch += 1


def _wants_validation(conf: Config) -> bool:
    """True when the config asks for interleaved validation (a TEST data
    layer with test_interval and test_iter), as the JAX package's
    `validation_source` decides."""
    sp = conf.solverParameter
    return (conf.test_data_layer() is not None and bool(sp.test_interval)
            and bool(sp.test_iter and sp.test_iter[0]))


def train_main(conf: Config) -> int:
    """-train: the model file defaults to <output>/model.caffemodel."""
    if _wants_validation(conf):
        raise NotImplementedError(
            "this solver asks for interleaved validation (test_interval "
            "and test_iter with a TEST data layer): trainWithValidation "
            "is a later slice of the PyTorch port; drop test_interval/"
            "test_iter to train without it")
    if not conf.modelPath:
        conf.modelPath = os.path.join(conf.outputPath or ".",
                                      "model.caffemodel")
    src = get_source(conf.train_data_layer(), phase_train=True, rank=0,
                     num_ranks=1, resize=conf.resize)
    CaffeOnSpark().train(src, conf)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    conf = Config(argv if argv is not None else sys.argv[1:])
    conf.validate()
    if conf.serve:
        return serve_main(conf)
    if conf.isTraining:
        return train_main(conf)
    raise SystemExit("the PyTorch port runs -train and -serve so far "
                     "(-test and -features come later)")


if __name__ == "__main__":
    sys.exit(main())
