"""CLI entry point: `python -m caffeonspark_tpu_torch.caffe_on_spark`.

The `-serve` mode of the JAX package's command line, on PyTorch:

    python -m caffeonspark_tpu_torch.caffe_on_spark -conf solver.prototxt \\
        -serve -model m.caffemodel -features fc8 [-device cpu]

parses the prototxts, builds the TEST-phase net on the device (`cuda`
unless `-device cpu`), loads the .caffemodel, warms every batch bucket,
starts the micro-batcher and the HTTP front end, and prints one boot
line of JSON (`{"serving": true, "port": N, "model_version": V,
"buckets": [...]}`) on stdout.  SIGINT or SIGTERM drains accepted work
and exits 0; COS_SERVE_METRICS=path dumps the serving metrics there at
shutdown.  Training, -test and -features come with later slices.
"""

from __future__ import annotations

import json
import os
import signal
import sys
from typing import List, Optional, Tuple

from .config import Config
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


def main(argv: Optional[List[str]] = None) -> int:
    conf = Config(argv if argv is not None else sys.argv[1:])
    conf.validate()
    if conf.serve:
        return serve_main(conf)
    raise SystemExit("the PyTorch port runs -serve only so far "
                     "(training, -test and -features come later)")


if __name__ == "__main__":
    sys.exit(main())
