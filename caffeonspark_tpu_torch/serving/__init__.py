"""Online serving: registry + micro-batcher + JSON HTTP front end."""

from .batcher import (DeadlineExceeded, MicroBatcher, PendingResult,  # noqa: F401
                      QueueFullError, ServingStopped, bucket_for,
                      make_buckets, serve_max_batch, serve_max_wait_ms)
from .http_server import ServingHTTPServer  # noqa: F401
from .service import Client, InferenceService, coerce_record  # noqa: F401
