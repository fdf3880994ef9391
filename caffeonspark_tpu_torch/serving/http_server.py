"""Stdlib JSON front end for the serving subsystem.

`http.server.ThreadingHTTPServer`, one thread per connection; each
handler thread submits to the micro-batcher and blocks on its
PendingResult, so concurrent HTTP requests coalesce into bucketed
flushes exactly like in-process clients.  The routes and wire format
are the JAX package's (`caffeonspark_tpu/serving/http_server.py`):

  POST /v1/predict   {"records": [{"id", "label", "data"}, ...]} or a
                     single record object -> {"rows": [...],
                     "model_version": N}
  POST /v1/reload    {"model": "<snapshot path>"} -> hot-swap
  GET  /healthz      liveness + status + queue depth (503 before a
                     model is loaded)
  GET  /metrics      serving metrics (PipelineMetrics JSON, plus
                     queue_depth_now, per-bucket flush counters and
                     the kernels' launch counts)

Status mapping: 429 queue-full fast-reject, 504 deadline exceeded,
400 malformed request, 503 stopped or model failure.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .batcher import DeadlineExceeded, QueueFullError, ServingStopped

_LOG = logging.getLogger(__name__)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):      # route to logging, not stderr
        _LOG.debug("http: " + fmt, *args)

    def _read_json(self):
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw.decode())

    def do_GET(self):
        svc = self.server.service
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            version = svc.registry.version
            if version == 0:
                self._send(503, {"ok": False, "status": "down",
                                 "error": "no model loaded"})
                return
            self._send(200, {"ok": True, "status": "ok",
                             "model_version": version,
                             "queue_depth": svc.batcher.depth()})
        elif path == "/metrics":
            self._send(200, svc.metrics_summary())
        else:
            self._send(404, {"error": f"no route {path}"})

    def do_POST(self):
        svc = self.server.service
        path = self.path.split("?", 1)[0]
        if path == "/v1/predict":
            self._predict(svc)
        elif path == "/v1/reload":
            try:
                req = self._read_json()
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                version = svc.reload(req["model"])
            except (KeyError, ValueError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:        # noqa: BLE001 — bad snapshot
                self._send(503, {"error": f"{type(e).__name__}: {e}"})
            else:
                self._send(200, {"ok": True, "model_version": version})
        else:
            self._send(404, {"error": f"no route {path}"})

    def _predict(self, svc):
        try:
            req = self._read_json()
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            records = req.get("records", [req] if "data" in req else None)
            if not records or not isinstance(records, list):
                raise ValueError("need 'records' (list) or a single "
                                 "record with 'data'")
            for r in records:
                if not isinstance(r, dict):
                    raise ValueError("each record must be a JSON object")
            pending = svc.submit_many(records,
                                      timeout_ms=req.get("timeout_ms"))
        except QueueFullError as e:
            self._send(429, {"error": str(e)})
            return
        except ServingStopped as e:
            self._send(503, {"error": str(e)})
            return
        except (ValueError, TypeError) as e:   # JSONDecodeError included
            self._send(400, {"error": str(e)})
            return
        try:
            rows = [p.wait(svc.http_wait_s) for p in pending]
        except DeadlineExceeded as e:
            self._send(504, {"error": str(e)})
            return
        except Exception as e:        # noqa: BLE001 — model fault
            self._send(503, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, {"rows": rows,
                         "model_version": pending[-1].model_version})


class ServingHTTPServer(ThreadingHTTPServer):
    """Bind-and-go wrapper; port 0 picks an ephemeral port (read it back
    from `.port`).  Binds loopback by default: /v1/reload loads
    arbitrary filesystem paths with no auth."""

    daemon_threads = True

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 http_wait_s: float = 120.0):
        super().__init__((host, port), _Handler)
        self.service = service
        service.http_wait_s = http_wait_s
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start_background(self) -> "ServingHTTPServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="cos-serve-http",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.server_close()
