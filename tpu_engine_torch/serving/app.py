"""Wire the port's worker and gateway to HTTP servers (counterparts of
``serve_worker`` and ``serve_gateway`` in ``tpu_engine/serving/app.py``).

Worker routes: ``POST /infer``, ``/score``, ``/generate``,
``/generate/stream``, ``/admin/drain``, ``/admin/migrate``,
``/admin/export_prefix``, ``/admin/role``, ``/admin/reload``,
``/admin/timeline``, ``/admin/profile``; ``GET /health``, ``/metrics``
(Prometheus text, version 0.0.4), ``/trace``, ``/trace/export`` (Chrome
trace-event JSON), ``/admin/timeline``, ``/admin/profile``,
``/admin/trace/<request_id>``. Gateway routes: ``POST /infer`` (the
lane's bytes relayed), ``/generate``, ``/generate/stream``, ``/score``,
``/admin/role`` (``{node, role}``); ``GET /stats``, ``/metrics``,
``/trace``, ``/trace/export``, ``/admin/slo``,
``/admin/trace/<request_id>`` (the stream's spans from every lane, one
tree). ``/admin/fleet`` (the autoscaler's) is not routed.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from tpu_engine_torch.serving.gateway import Gateway
from tpu_engine_torch.serving.http import JsonHttpServer
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig
from tpu_engine_torch.utils.metrics import render_prometheus
from tpu_engine_torch.utils.tracing import export_chrome, stitch_trace

_PROMETHEUS = "text/plain; version=0.0.4"


def _trace_routes(server: JsonHttpServer, node: str, tracer) -> None:
    """``GET /trace`` (the ring's summaries and last 20 spans) and
    ``/trace/export`` (its Chrome trace-event JSON)."""
    server.route("GET", "/trace", lambda _body: (200, {
        "summary": {node: tracer.summary()},
        "recent": tracer.recent(20),
        "stages": {node: tracer.stage_summary()},
    }))
    server.route("GET", "/trace/export",
                 lambda _body: (200, export_chrome({node: tracer})))


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
    server = worker_server(worker, config.port)
    try:
        server.start(background=True)
    except BaseException:
        worker.stop()
        raise
    return worker, server


def worker_server(worker: WorkerNode, port: int) -> JsonHttpServer:
    """An HTTP server (not yet started) with the worker's routes on
    ``port``; a stopped server's worker can be served again this way."""
    server = JsonHttpServer(port)
    server.route("POST", "/infer",
                 lambda body: (200, worker.handle_infer_raw(body)))
    server.route("POST", "/score",
                 lambda body: (200, worker.handle_score(body)))
    server.route("POST", "/generate",
                 lambda body: (200, worker.handle_generate(body)))
    server.route("POST", "/generate/stream",
                 lambda body: (200, worker.handle_generate_stream(body)))
    server.route("GET", "/health", lambda _body: (200, worker.get_health()))

    def admin_drain(body):
        """Drain (lame-duck: new admissions shed 503 while in-flight work
        completes) or undrain; ``status`` names the outcome (draining,
        already-draining, undrained, not-draining)."""
        action = (body or {}).get("action", "drain")
        if action == "drain":
            status = worker.drain()
        elif action == "undrain":
            status = worker.undrain()
        else:
            return 400, {"error": "action must be drain|undrain"}
        return 200, {"ok": True, "node_id": worker.node_id,
                     "draining": worker.draining, "status": status}

    server.route("POST", "/admin/drain", admin_drain)
    # Live-row migration: export a stream's row; the continuation rides
    # /generate/stream with a `migrate_import` body.
    server.route("POST", "/admin/migrate",
                 lambda body: (200, worker.handle_migrate_export(body or {})))
    # The fleet prefix tier: a peer's fetch of this lane's radix chain.
    server.route("POST", "/admin/export_prefix",
                 lambda body: (200, worker.handle_export_prefix(body or {})))
    # Disaggregated serving: flip the lane's role (the gateway drains and
    # migrates around it).
    server.route("POST", "/admin/role",
                 lambda body: (200, worker.set_role((body or {}).get(
                     "role", ""))))
    # Hot weight reload: {"model_path"} of the served architecture.
    server.route("POST", "/admin/reload",
                 lambda body: (200, worker.reload_weights(body["model_path"])))
    server.route("GET", "/metrics", lambda _body: (
        200, render_prometheus([worker.get_health()],
                               recorders={worker.node_id: worker.tracer},
                               named_hists=worker.latency_histograms()),
        _PROMETHEUS))
    _trace_routes(server, worker.node_id, worker.tracer)
    # The flight recorder (GET: the ring; POST {"dump": reason}: a dump
    # now) and the tick-bounded profile (POST {"ticks": N} | {"action":
    # "stop"}; GET: its status).
    server.route("GET", "/admin/timeline",
                 lambda body: (200, worker.handle_timeline(body)))
    server.route("POST", "/admin/timeline",
                 lambda body: (200, worker.handle_timeline(body or {})))
    server.route("POST", "/admin/profile",
                 lambda body: (200, worker.handle_profile(body or {})))
    server.route("GET", "/admin/profile", lambda _body: (
        200, worker.handle_profile({"action": "status"})))
    # This lane's fragment of a request's trace (the gateway's route
    # merges every lane's).
    server.route_prefix("GET", "/admin/trace/", lambda _body, rid: (
        200, stitch_trace({worker.node_id: worker.tracer.snapshot()}, rid)))
    return server


def serve_gateway(worker_urls: List[str],
                  config: Optional[GatewayConfig] = None
                  ) -> Tuple[Gateway, JsonHttpServer]:
    """Start a gateway over the HTTP workers ``worker_urls`` serving in a
    background thread on ``config.port`` (0 = any free port). Returns
    (gateway, server); the caller stops the server."""
    config = config or GatewayConfig()
    gateway = Gateway(worker_urls, config)
    server = JsonHttpServer(config.port)
    server.route("POST", "/infer",
                 lambda body: (200, gateway.route_request_raw(body)))
    server.route("POST", "/generate",
                 lambda body: (200, gateway.route_generate(body)))
    server.route("POST", "/generate/stream",
                 lambda body: (200, gateway.route_generate_stream(body)))
    server.route("POST", "/score",
                 lambda body: (200, gateway.route_score(body)))
    server.route("GET", "/stats", lambda _body: (200, gateway.get_stats()))
    # Disaggregated serving: flip a lane's role fleet-side.
    server.route("POST", "/admin/role", lambda body: (
        200, gateway.set_worker_role((body or {}).get("node", ""),
                                     (body or {}).get("role", ""))))
    server.route("GET", "/metrics", lambda _body: (
        200, render_prometheus([], gateway.get_stats(),
                               recorders={"gateway": gateway.tracer}),
        _PROMETHEUS))
    _trace_routes(server, "gateway", gateway.tracer)
    server.route_prefix("GET", "/admin/trace/", lambda _body, rid: (
        200, gateway.stitched_trace(rid)))
    server.route("GET", "/admin/slo", lambda _body: (
        200, gateway.slo_status()
        or {"error": "no objectives configured "
                     "(set --slo-ttft-p99-ms / --slo-itl-p99-ms / "
                     "--slo-completion-p99-ms)"}))
    server.start(background=True)
    return gateway, server
