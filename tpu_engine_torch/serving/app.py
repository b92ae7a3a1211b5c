"""Wire the port's worker to its HTTP server (counterpart of
``serve_worker`` in ``tpu_engine/serving/app.py``)."""

from __future__ import annotations

from typing import Tuple

from tpu_engine_torch.serving.http import JsonHttpServer
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import WorkerConfig


def serve_worker(config: WorkerConfig, params=None, warmup: bool = False
                 ) -> Tuple[WorkerNode, JsonHttpServer]:
    """Start a worker serving in a background thread on ``config.port``
    (0 = any free port; the bound port is then ``server.port``), after
    running every /infer batch bucket once with ``warmup``. Returns
    (worker, server); the caller stops both."""
    worker = WorkerNode(config, params=params)
    try:
        if warmup:
            worker.engine.warmup()
    except BaseException:
        worker.stop()
        raise
    server = JsonHttpServer(config.port)
    server.route("POST", "/infer",
                 lambda body: (200, worker.handle_infer_raw(body)))
    server.route("POST", "/score",
                 lambda body: (200, worker.handle_score(body)))
    server.route("POST", "/generate",
                 lambda body: (200, worker.handle_generate(body)))
    server.route("POST", "/generate/stream",
                 lambda body: (200, worker.handle_generate_stream(body)))
    server.route("GET", "/health", lambda _body: (200, worker.get_health()))
    server.route("GET", "/stats", lambda _body: (200, worker.get_stats()))
    try:
        server.start(background=True)
    except BaseException:
        worker.stop()
        raise
    return worker, server
