"""CLI entry point: `python -m caffeonspark_tpu_torch.caffe_on_spark`.

The `-train`, `-test`, `-features` and `-serve` modes of the JAX
package's command line, on PyTorch, on the card unless `-device cpu`:

    python -m caffeonspark_tpu_torch.caffe_on_spark -conf solver.prototxt \\
        -train [-test | -features fc8 -label label] -output out/ \\
        [-weights init.caffemodel | -snapshot x.solverstate] \\
        [-outputFormat json|parquet]

-train parses the prototxts, opens the TRAIN data layer's LMDB, streams
its records (a seeded shuffle per epoch) through the bounded feed queue
into the TRAIN-phase transformer, and runs Caffe's solver for max_iter
steps (`CaffeOnSpark.train` -> `CaffeProcessor`).  A solver with
test_interval and test_iter over a net with a TEST data layer trains
with interleaved validation (`trainWithValidation`): every test_interval
steps a round of test_iter TEST batches, whose per-output means land in
`<output>/validation.<fmt>`.  Snapshots land at the `snapshot` interval
and after training; the final model goes to `-model` (default
`<output>/model.caffemodel`).  Then -test writes the per-output means
over the TEST data layer's records to `<output>/test_result` (and
stdout), and -features writes one SampleID row a record with the named
blobs (and the -label blob) to `<output>/features.<fmt>`; after -train
they use the just-trained weights, otherwise -model or -weights.
`-clusterSize N -rank r` runs as the JAX package's local engine does
without pyspark: this process trains alone on shard r of N of the
records, its solver seeded by r, with no exchange, and its `-mesh` is
this process's alone (processes that train in lockstep on one global
mesh are `mini_cluster -server -cluster -rank [-mesh]`).
`-mesh dp[,tp[,sp]]` (the JAX CLI's grammar; a bare N is dp N; `-devices
k` is `-mesh k`) trains
with `parallel.dp.ParallelSolver`, the ranks all on `-device`'s card:
each batch split over dp (the prototxt batch is the global batch), the
large matmuls split by column over tp, every MultiHeadAttention a ring
over sp time blocks (parallel/sp.py), ZeRO-1 under COS_ZERO=1; with
more than one rank, validation, -test and -features run on the same
layout.  A batch that dp does not divide is refused naming its layer.

    python -m caffeonspark_tpu_torch.caffe_on_spark -conf solver.prototxt \\
        -serve -model m.caffemodel -features fc8

builds the TEST-phase net, loads the .caffemodel, warms every batch
bucket, starts the micro-batcher and the HTTP front end, and prints one
boot line of JSON (`{"serving": true, "port": N, "model_version": V,
"buckets": [...]}`) on stdout.  SIGINT or SIGTERM drains accepted work
and exits 0; COS_SERVE_METRICS=path dumps the serving metrics there at
shutdown.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import sys
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .config import Config
from .data.source import DataSource, get_source
from .processor import CaffeProcessor
from .serving import InferenceService, ServingHTTPServer


class DataFrame:
    """A minimal columnar result (Spark's DataFrame in local mode): rows
    of dicts and their columns, written as JSON lines or parquet."""

    def __init__(self, rows: List[Dict[str, Any]],
                 columns: Optional[Sequence[str]] = None):
        self.rows = rows
        self.columns = (list(columns) if columns is not None
                        else (list(rows[0]) if rows else []))

    def __len__(self):
        return len(self.rows)

    def select(self, *cols) -> "DataFrame":
        return DataFrame([{c: r[c] for c in cols} for r in self.rows], cols)

    def collect(self) -> List[Dict[str, Any]]:
        return self.rows

    def write(self, path: str, fmt: str = "json") -> None:
        if fmt not in ("json", "parquet"):
            raise ValueError(f"outputFormat {fmt!r}")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if fmt == "json":
            with open(path, "w") as f:
                for r in self.rows:
                    f.write(json.dumps(r) + "\n")
        elif fmt == "parquet":
            try:
                import pyarrow as pa
                import pyarrow.parquet as pq
            except ImportError as e:
                raise ImportError(
                    f"{path!r}: -outputFormat parquet needs pyarrow, which "
                    "is not installed (use -outputFormat json)") from e
            pq.write_table(pa.table({c: [r.get(c) for r in self.rows]
                                     for c in self.columns}), path)


def vector_mean(df: DataFrame, column: str) -> List[float]:
    """Element-wise mean of a float-array column (the VectorMean UDAF of
    the reference, used by test())."""
    arrs = [np.asarray(r[column], np.float64) for r in df.rows]
    if not arrs:
        return []
    return [float(x) for x in np.mean(np.stack(arrs), axis=0)]


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
    """Driver facade on the local engine (one process, one device; shard
    -rank of -clusterSize of the records)."""

    def train(self, source: DataSource, conf: Config) -> None:
        """Synchronous training (CaffeOnSpark.train): the processor's
        solver thread runs max_iter steps while this thread feeds it the
        source's records, epoch after epoch, until it stops."""
        proc = CaffeProcessor.instance(conf, conf.rank)
        proc.start()
        try:
            gen = _record_loop(source, persistent=conf.isPersistent)
            while proc._thread is not None and proc._thread.is_alive():
                if not proc.feed_queue(0, next(gen)):
                    break
        finally:
            proc.queues[0].offer(None)
            proc.join()

    def trainWithValidation(self, source_train: DataSource,
                            source_validation: DataSource,
                            conf: Config) -> DataFrame:
        """Interleaved training and validation (:239-358): feed
        test_interval x batch training records, then exactly test_iter x
        batch validation records, in lockstep with the solver's rounds
        (more would block queue 1 for good, fewer would stall the round),
        topping the training feed up for batches the processor dropped.
        One row of per-output means a round."""
        sp = conf.solverParameter
        test_interval = sp.test_interval
        test_iter = sp.test_iter[0] if sp.test_iter else 0
        if not test_interval or not test_iter:
            raise ValueError("trainWithValidation needs test_interval "
                             "and test_iter in the solver prototxt")
        proc = CaffeProcessor.instance(conf, conf.rank)
        proc.interleave_validation = True
        proc.start()
        try:
            train_bs = source_train.batch_size
            val_bs = source_validation.batch_size
            train_gen = _record_loop(source_train,
                                     persistent=conf.isPersistent)
            val_gen = _record_loop(source_validation,
                                   persistent=conf.isPersistent)
            fed = drops_seen = 0
            while fed < sp.max_iter and proc._thread.is_alive():
                extra = proc.dropped_batches - drops_seen
                drops_seen = proc.dropped_batches
                for rec in itertools.islice(
                        train_gen, (test_interval + extra) * train_bs):
                    if not proc.feed_queue(0, rec):
                        break
                fed += test_interval
                for rec in itertools.islice(val_gen, test_iter * val_bs):
                    if not proc.feed_queue(1, rec):
                        break
        finally:
            proc.queues[0].offer(None)
            proc.join()
        report = proc.validation
        return DataFrame(report.rounds if report else [],
                         report.names if report else [])

    def test(self, source: DataSource,
             conf: Config) -> Dict[str, List[float]]:
        """Forward over the test set: per-output mean vectors
        (:396-418)."""
        df = self.features2(source, conf)
        return {n: vector_mean(df, n) for n in df.columns
                if n != "SampleID"}

    def features(self, source: DataSource, conf: Config) -> DataFrame:
        """Feature extraction: DataFrame(SampleID, blobs...) (:427-438)."""
        return self.features2(source, conf)

    def features2(self, source: DataSource, conf: Config) -> DataFrame:
        blob_names = ([b.strip() for b in conf.features.split(",")
                       if b.strip()] if conf.features else None)
        if blob_names and conf.label and conf.label not in blob_names:
            blob_names.append(conf.label)
        proc = CaffeProcessor.instance(conf, conf.rank)
        if blob_names is None:
            blob_names = proc.default_feature_blobs()
        rows = proc.extract_features(source, blob_names)
        return DataFrame(rows, ["SampleID"] + blob_names)


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


def validation_source(conf: Config) -> Optional[DataSource]:
    """The interleaved-validation source, or None when the config does
    not interleave: the reference's condition (a TEST data layer, and
    test_interval and test_iter in the solver), whatever the run's mode
    (the CLI asks only under -train, through `Config.validates`)."""
    test_layer = conf.test_data_layer()
    sp = conf.solverParameter
    if test_layer is None or not sp.test_interval \
            or not (sp.test_iter and sp.test_iter[0]):
        return None
    return get_source(test_layer, phase_train=False, rank=0,
                      num_ranks=1, resize=conf.resize)


def train_main(conf: Config) -> None:
    """-train, with interleaved validation when the solver asks for it;
    the model file defaults to <output>/model.caffemodel."""
    if not conf.modelPath:
        conf.modelPath = os.path.join(conf.outputPath or ".",
                                      "model.caffemodel")
    cos = CaffeOnSpark()
    # -clusterSize N -rank r without Spark: shard r of N (JAX
    # caffe_on_spark.py:547-549)
    src = get_source(conf.train_data_layer(), phase_train=True,
                     rank=conf.rank, num_ranks=max(1, conf.clusterSize),
                     resize=conf.resize)
    val_src = validation_source(conf)
    if val_src is None:
        cos.train(src, conf)
        return
    df = cos.trainWithValidation(src, val_src, conf)
    if conf.outputPath:
        df.write(os.path.join(conf.outputPath,
                              "validation." + conf.outputFormat),
                 conf.outputFormat)


def eval_main(conf: Config) -> None:
    """-test / -features over the TEST data layer's records (else the
    TRAIN one's, at TEST).  After -train the just-trained model is the
    weights, even over -weights; otherwise -model, else -weights."""
    if conf.isTraining and conf.modelPath \
            and os.path.exists(conf.modelPath):
        conf.snapshotModelFile = conf.modelPath
        conf.snapshotStateFile = ""
    elif conf.modelPath and os.path.exists(conf.modelPath) \
            and not conf.snapshotModelFile:
        conf.snapshotModelFile = conf.modelPath
    layer = conf.test_data_layer() or conf.train_data_layer()
    src = get_source(layer, phase_train=False, rank=0, num_ranks=1,
                     resize=conf.resize)
    cos = CaffeOnSpark()
    if conf.isTest:
        out = json.dumps(cos.test(src, conf))
        print(out, flush=True)
        if conf.outputPath:
            os.makedirs(conf.outputPath, exist_ok=True)
            with open(os.path.join(conf.outputPath, "test_result"),
                      "w") as f:
                f.write(out + "\n")
    else:
        df = cos.features(src, conf)
        if conf.outputPath:
            df.write(os.path.join(conf.outputPath,
                                  "features." + conf.outputFormat),
                     conf.outputFormat)


def main(argv: Optional[List[str]] = None) -> int:
    conf = Config(argv if argv is not None else sys.argv[1:])
    conf.validate()
    if conf.serve:
        return serve_main(conf)
    try:
        if conf.isTraining:
            train_main(conf)
        if conf.isTest or conf.features:
            eval_main(conf)
    finally:
        proc = CaffeProcessor._instance
        if proc is not None and proc.conf is conf:
            proc.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
