"""Wire the port's workers and gateway to HTTP servers (counterparts of
``serve_worker``, ``serve_gateway`` and ``serve_combined`` in
``tpu_engine/serving/app.py``).

Worker routes: ``POST /infer``, ``/score``, ``/generate``,
``/generate/stream``, ``/admin/drain``, ``/admin/migrate``,
``/admin/export_prefix``, ``/admin/role``, ``/admin/reload``,
``/admin/timeline``, ``/admin/profile``; ``GET /health``, ``/metrics``
(Prometheus text, version 0.0.4), ``/trace``, ``/trace/export`` (Chrome
trace-event JSON), ``/admin/timeline``, ``/admin/profile``,
``/admin/trace/<request_id>``. Gateway routes: ``POST /infer`` (the
lane's bytes relayed), ``/generate``, ``/generate/stream``, ``/score``,
``/admin/role`` (``{node, role}``), ``/admin/fleet`` (the elastic fleet:
``{action: status|add|remove|rebalance|clear, worker, role}``); ``GET
/stats``, ``/metrics``,
``/trace``, ``/trace/export``, ``/admin/slo``,
``/admin/trace/<request_id>`` (the stream's spans from every lane, one
tree).

``serve_combined``: one process, one front door, N in-process lanes (each
its own engine, cache, batcher and scheduler) behind the gateway, which
routes to a lane with no HTTP hop (``LocalWorkerClient``). Its routes are
the gateway's, plus the aggregate ``GET /health`` (counters summed over
the lanes, and each lane's under ``lanes``), ``/health/<node>``,
``/stats`` with the lanes' ``kv_pool``, ``state_pool``, ``mixed``,
``spec``, ``prefix_fetch`` and ``stateless`` blocks, ``POST
/admin/fault`` (``{node, action: fail|slow|heal, latency_s}``),
``/admin/drain`` (``{node, action, remove}``), ``/admin/reload`` (every
lane, or ``node``/``model``), and ``/admin/profile`` and
``/admin/timeline`` per lane. With ``autoscale`` the fleet controller
mints in-process lanes ``worker_{n+1}...`` on the weights the static lanes
share and retires them through the drain and migration. The front is the
C++ one
(``core.native.NativeHttpFront``: /infer hits answered in C++ from each
lane's raw-mode native cache, gated by the lane's native breaker) for a
single-model fleet unless ``native_front=False``; a multi-model fleet
gets the Python ``JsonHttpServer`` (the C++ hit path knows no model).
The C++ front's ring follows the gateway's membership: a lane added or
removed later joins or leaves it too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import List, Optional, Tuple

from tpu_engine_torch.serving.autoscaler import (
    InProcessLaneProvider,
    StandbyLaneProvider,
)
from tpu_engine_torch.serving.gateway import Gateway
from tpu_engine_torch.serving.http import JsonHttpServer
from tpu_engine_torch.serving.worker import (
    WorkerNode,
    _load_model_path,
    _model_spec,
)
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig
from tpu_engine_torch.utils.deadline import ShedError
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
                  config: Optional[GatewayConfig] = None,
                  standby_workers: Optional[List[str]] = None
                  ) -> Tuple[Gateway, JsonHttpServer]:
    """Start a gateway over the HTTP workers ``worker_urls`` serving in a
    background thread on ``config.port`` (0 = any free port).
    ``standby_workers``: worker addresses the fleet controller may bring
    in (after a passing /health probe) and retire; not registered at
    start. Returns (gateway, server); the caller stops the server."""
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
    server.route("POST", "/admin/fleet", lambda body: (
        200, gateway.fleet_admin(body or {})))
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
    if config.autoscale or standby_workers:
        gateway.engage_autoscaler(
            provider=StandbyLaneProvider(list(standby_workers or [])))
    server.start(background=True)
    return gateway, server


_NO_SLO = {"error": "no objectives configured (set --slo-ttft-p99-ms / "
                    "--slo-itl-p99-ms / --slo-completion-p99-ms)"}


def lane_devices(worker_config: WorkerConfig) -> List[str]:
    """The devices lanes go round-robin onto: the one ``device`` the
    config names, else every CUDA card (none raises, as every entry point
    of the port does without a card)."""
    if worker_config.device is not None:
        return [str(worker_config.device)]
    import torch

    from tpu_engine_torch.utils.device import resolve_device

    resolve_device(None)  # raises without a card
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def native_front_wanted(models: List[str],
                        native_front: Optional[bool]) -> bool:
    """Whether the combined server's front is the C++ one: yes for one
    model unless ``native_front`` is False; never for several (the C++
    hit path's ring and cache keys carry no model), where
    ``native_front=True`` raises."""
    if len(set(models)) > 1:
        if native_front is True:
            raise RuntimeError(
                "native front is single-model (its ring and cache keys "
                "carry no model); serve multi-model with the python front")
        return False
    return native_front is not False


def parse_mesh_spec(spec: str, device=None):
    """'data=8' / 'model=2,data=4' -> a ``parallel.mesh.Mesh`` with those
    axes in that order; a missing ``data`` axis is added with size 1 (the
    engine's batch axis always exists). The ranks are the CUDA devices,
    which must number the mesh's size (the JAX message otherwise), or
    with ``device`` every rank on that one device."""
    import math

    from tpu_engine_torch.parallel.mesh import create_mesh
    from tpu_engine_torch.utils.device import resolve_device

    axes = []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes.append((name.strip(), int(size)))
    if "data" not in (n for n, _ in axes):
        axes.append(("data", 1))
    shape = tuple(s for _, s in axes)
    return create_mesh(shape=shape, axis_names=tuple(n for n, _ in axes),
                       devices=(None if device is None else
                                [resolve_device(device)] * math.prod(shape)))


def _mesh_engine(model: str, lane_cfg: WorkerConfig, mesh, params=None):
    """One engine spanning the whole mesh: batches scatter over ``data``,
    weights split over ``model`` when that axis is > 1
    (``training.train.shard_params_tp``), else whole on every rank.
    ``params``: the model's tree on the mesh's home device; None draws
    the seeded random weights of ``lane_cfg.seed``."""
    from tpu_engine_torch.runtime.engine import InferenceEngine
    from tpu_engine_torch.training.train import shard_params_tp

    spec = _model_spec(model, lane_cfg.model_path or "")
    if params is None:
        params = spec.init(lane_cfg.seed, device=mesh.home,
                           dtype=lane_cfg.dtype)
    shardings = None
    if mesh.shape.get("model", 1) > 1:
        shardings = shard_params_tp(params, mesh, axis="model")
    return InferenceEngine(
        spec, params=params, dtype=lane_cfg.dtype,
        batch_buckets=lane_cfg.batch_buckets,
        shape_buckets=lane_cfg.shape_buckets, mesh=mesh,
        param_shardings=shardings)


def serve_combined(model: str = "resnet50", lanes: int = 0,
                   port: int = 8000,
                   worker_config: Optional[WorkerConfig] = None,
                   gateway_config: Optional[GatewayConfig] = None,
                   warmup: bool = False,
                   native_front: Optional[bool] = None,
                   lane_roles: Optional[List[str]] = None, mesh=None):
    """One process serving ``model`` (``"a,b"``: models assigned to lanes
    round-robin, requests routed by their ``model``) on ``lanes``
    in-process lanes (0: one per device of ``lane_devices``; more go
    round-robin onto them) named ``worker_1..N``, behind a gateway and one
    front on ``port`` (0: any free port, then ``server.port``). Lanes of
    one model on one device share one weight tree: ``model_path``'s,
    loaded once, or the first lane's random draw (a quantized lane draws
    its own). ``lane_roles`` assigns disaggregated roles round-robin
    (default ``worker_config.role``). With ``worker_config.tp`` > 1 the
    default is ``cards // tp`` lanes, lane i's ranks on cards
    [i*tp, (i+1)*tp) (``tp_device_offset``), or all on the config's
    ``device`` when it names one. ``warmup`` runs each lane's batch
    buckets and a short generation before serving. ``native_front``: None
    = the C++ front for one model, True = require it, False = the Python
    front. A library that does not build raises. With
    ``gateway_config.autoscale`` the fleet controller mints lanes
    ``worker_{N+1}...`` (``make_lane``'s, at most ``autoscale_max_lanes``
    live) and retires them; ``workers`` follows. ``mesh`` (a spec such
    as 'model=2,data=4', every rank on ``worker_config.device`` when it
    names one, or a ``parallel.mesh.Mesh``): mesh-sharded serving, one
    model on ONE lane, ``worker_1``, whose engine spans the mesh
    (``_mesh_engine``). Returns (gateway, workers, server), serving in the
    background; stop them with ``stop_combined``."""
    cfg = worker_config or WorkerConfig()
    gateway_config = gateway_config or GatewayConfig(port=port)
    models = [m.strip() for m in str(model).split(",") if m.strip()]
    if len(models) > 1 and cfg.model_path:
        raise ValueError("model_path is ambiguous with multiple models; "
                         "serve them from separate processes or extend "
                         "the config per model")
    if mesh is not None and len(models) > 1:
        raise ValueError("mesh-sharded serving is single-model")
    if lanes and lanes < len(models):
        raise ValueError(
            f"lanes={lanes} cannot serve {len(models)} models — "
            f"later-listed models would silently get no lane")
    if lane_roles and lanes and lanes < len(lane_roles):
        raise ValueError(
            f"lanes={lanes} cannot honor {len(lane_roles)} lane "
            f"roles — later-listed roles would silently get no lane")
    use_native = native_front_wanted(models, native_front)
    if use_native:
        from tpu_engine_torch.core import native

        native.load()  # a failed build raises here, before any lane
    if isinstance(mesh, str):
        mesh = parse_mesh_spec(mesh, device=cfg.device)
    devices = ([str(mesh.home)] if mesh is not None
               else lane_devices(cfg))
    tp = max(1, int(cfg.tp))
    # Tensor-parallel lanes each take tp cards: the default fleet is
    # cards // tp lanes, lane i on cards [i*tp, (i+1)*tp) (round-robin
    # when --lanes oversubscribes), or every rank on the named device.
    n_slices = max(1, len(devices) // tp)
    n_lanes = 1 if mesh is not None else lanes or max(
        n_slices if tp > 1 else len(devices), len(models))
    if lane_roles and mesh is None:
        n_lanes = max(n_lanes, len(lane_roles))
    load_dtype = "float32" if cfg.quantize else cfg.dtype
    path = cfg.model_path or ""
    shared: dict = {}
    workers: List[WorkerNode] = []

    def make_lane(i: int) -> WorkerNode:
        """Lane ``worker_{i+1}``: its model and device round-robin, on the
        weights of its (model, device), which the first such lane draws
        when there is no checkpoint (a quantized lane draws its own)."""
        over = {"node_id": f"worker_{i + 1}",
                "model": models[i % len(models)],
                "device": devices[i % len(devices)], "port": port}
        if tp > 1 and cfg.device is None:
            over["device"] = None
            over["tp_device_offset"] = (i % n_slices) * tp
        if lane_roles:
            over["role"] = lane_roles[i % len(lane_roles)]
        lane_cfg = dataclasses.replace(cfg, **over)
        key = (lane_cfg.model, lane_cfg.device)
        if key not in shared:
            shared[key] = (None if path.endswith(".onnx") else
                           _load_model_path(
                               _model_spec(lane_cfg.model, path), path,
                               lane_cfg.device, load_dtype))
        cache = None
        if use_native:
            cache = native.NativeLRUCache(lane_cfg.cache_capacity, raw=True)
        engine = (None if mesh is None else _mesh_engine(
            lane_cfg.model, lane_cfg, mesh, params=shared[key]))
        w = WorkerNode(lane_cfg, params=shared[key], cache=cache,
                       engine=engine)
        if (shared[key] is None and cfg.quantize is None
                and not path.endswith(".onnx")):
            shared[key] = w.engine.params
        return w

    try:
        for i in range(n_lanes):
            workers.append(make_lane(i))
        if warmup:
            for w in workers:
                w.engine.warmup()
                gen = w.generator
                if gen is not None and not getattr(gen, "_stateless",
                                                   False):
                    # Straight to the generator: the request path would
                    # count a phantom request and record its spans.
                    gen.generate([[1, 2, 3]], max_new_tokens=2)
    except BaseException:
        for w in workers:
            w.stop()
        raise
    gateway = Gateway(workers, gateway_config, native_breakers=use_native)

    # The fleet prefix tier in process: a peer fetch is the owner lane's
    # handle_export_prefix, called directly.
    def peer_export(hint, payload):
        lane = hint.get("lane")
        for w in list(workers):
            if w.node_id == lane:
                return w.handle_export_prefix(payload)
        raise KeyError(f"no in-process lane named {lane!r}")

    if cfg.gen_prefix_fetch:
        for w in workers:
            w.set_prefix_fetch_transport(peer_export)
    routes, prefix_routes = _combined_routes(gateway, workers)
    try:
        server = _make_front_server(port, routes, prefix_routes, workers,
                                    gateway, use_native)
    except BaseException:
        stop_combined(gateway, workers, None)
        raise
    if gateway_config.autoscale:
        # The elastic fleet: minted lanes continue the static lanes'
        # names and round-robin, and a retired one leaves the per-lane
        # surfaces. Engaged once the front follows the membership.
        def spawn_lane(idx: int) -> WorkerNode:
            w = make_lane(n_lanes + idx)
            if cfg.gen_prefix_fetch:
                w.set_prefix_fetch_transport(peer_export)
            workers.append(w)
            return w

        def drop_lane(w) -> None:
            if w in workers:
                workers.remove(w)

        provider = InProcessLaneProvider(
            spawn_lane, max_lanes=gateway_config.autoscale_max_lanes,
            on_retire=drop_lane)
        # A retired static lane stops and gives its memory back too.
        for w in workers:
            provider.adopt(w)
        gateway.engage_autoscaler(provider=provider)
    return gateway, workers, server


def stop_combined(gateway, workers, server) -> None:
    """Stop the front (its connections and threads), the gateway's prober
    and every lane."""
    if server is not None:
        server.stop()
    gateway.stop()
    for w in workers:
        w.stop()


def _combined_routes(gateway: Gateway, workers: List[WorkerNode]):
    """The combined server's (method, path) -> handler routes, and its
    prefix routes."""
    def lanes_of(body, allow_all=True):
        node = (body or {}).get("node")
        return [w for w in workers
                if w.node_id == node or (allow_all and node in (None, "*"))]

    def stats(_body):
        """The gateway's /stats, plus each lane's pool, mixed, spec,
        prefix-fetch and one-shot blocks where a lane has them."""
        out = gateway.get_stats()
        blocks = {k: {} for k in ("kv_pool", "state_pool", "mixed", "spec",
                                  "prefix_fetch", "stateless")}
        for w in workers:
            gen = w.generator
            if gen is None or not hasattr(gen, "stats"):
                continue
            try:
                st = gen.stats()
            except Exception:
                continue
            if st.get("stateless", {}).get("dispatches"):
                blocks["stateless"][w.node_id] = st["stateless"]
            for k in ("kv_pool", "prefix_fetch", "state_pool"):
                if st.get(k):
                    blocks[k][w.node_id] = st[k]
            for k in ("mixed", "spec"):
                if st.get(k):
                    blocks[k][w.node_id] = dict(st[k],
                                                active=st.get("active"))
        for k in ("kv_pool", "state_pool", "mixed", "spec", "prefix_fetch",
                  "stateless"):
            if blocks[k]:
                out[k] = blocks[k]
        return 200, out

    def health(_body):
        """The whole process's /health: the lanes' counters summed, under
        the reference's field names, and each lane's under ``lanes``."""
        lanes_h = [w.get_health() for w in workers]
        total = sum(h["total_requests"] for h in lanes_h)
        bp = {k: sum(h["batch_processor"][k] for h in lanes_h)
              for k in ("total_batches", "timeout_batches", "full_batches")}
        n = bp["total_batches"]
        bp["avg_batch_size"] = round(
            sum(h["batch_processor"]["avg_batch_size"]
                * h["batch_processor"]["total_batches"]
                for h in lanes_h) / n, 4) if n else 0.0
        rate = (sum(h["cache_hit_rate"] * h["total_requests"]
                    for h in lanes_h) / total) if total else 0.0
        return 200, {
            "healthy": all(h["healthy"] for h in lanes_h),
            "node_id": (lanes_h[0]["node_id"] if len(lanes_h) == 1
                        else "combined"),
            "total_requests": total,
            "cache_hits": sum(h["cache_hits"] for h in lanes_h),
            "cache_size": sum(h["cache_size"] for h in lanes_h),
            "cache_hit_rate": round(rate, 6),
            "batch_processor": bp,
            "lanes": {h["node_id"]: h for h in lanes_h},
        }

    def admin_fault(body):
        """{"node": id|"*", "action": "fail"|"slow"|"heal",
        "latency_s": X}: fail a lane's requests, slow them by X seconds
        (default 1) without failing, or clear both."""
        body = body or {}
        action = body.get("action", "fail")
        targets = lanes_of(body)
        if not targets:
            return 404, {"error": f"unknown node '{body.get('node')}'"}
        for w in targets:
            if action == "fail":
                w.inject_fault()
            elif action == "slow":
                w.inject_latency(float(body.get("latency_s", 1.0)))
            else:
                w.heal()
        return 200, {"ok": True, "nodes": [w.node_id for w in targets],
                     "action": action}

    def admin_drain(body):
        """{"node", "action": "drain"|"undrain", "remove"}: with
        ``remove`` the drained lane leaves the ring (through the
        migrate-mode drain with ``migrate_streams``)."""
        body = body or {}
        action = body.get("action", "drain")
        if action not in ("drain", "undrain"):
            return 400, {"error": "action must be drain|undrain"}
        targets = lanes_of(body)
        if not targets:
            return 200, {"ok": False, "status": "unknown-lane",
                         "node": body.get("node")}
        for w in targets:
            if action == "undrain":
                w.undrain()
            elif body.get("remove") and gateway.config.migrate_streams:
                gateway.remove_worker(w.node_id, drain=True)
            else:
                w.drain()
                if body.get("remove"):
                    gateway.remove_worker(w.node_id)
        return 200, {"ok": True, "action": action,
                     "nodes": [w.node_id for w in targets],
                     "removed": bool(body.get("remove"))
                     and action == "drain"}

    def admin_role(body):
        node = (body or {}).get("node")
        if not any(w.node_id == node for w in workers):
            return 404, {"error": f"unknown node '{node}'"}
        return 200, gateway.set_worker_role(node, (body or {}).get("role",
                                                                   ""))

    def admin_reload(body):
        """{"model_path", "node"?, "model"?}: load the checkpoint once per
        device and swap it into each target lane; per-lane outcomes, 500
        if any lane refused. Several models served need a ``model`` or
        ``node``."""
        body = body or {}
        targets = lanes_of(body)
        if not targets:
            return 404, {"error": f"unknown node '{body.get('node')}'"}
        model = body.get("model")
        if model is not None:
            targets = [w for w in targets if w.engine.spec.name == model]
            if not targets:
                return 404, {"error": f"no lane serves model '{model}'"}
        else:
            served = {w.engine.spec.name for w in targets}
            if len(served) > 1:
                return 400, {"error": "multiple models served "
                             f"({sorted(served)}): pass 'model' or 'node' "
                             "to pick the target"}
        path = body["model_path"]
        loaded: dict = {}
        outcomes, ok = [], True
        for w in targets:
            dev = str(w.engine.device)
            if dev not in loaded:
                loaded[dev] = _load_model_path(
                    w.engine.spec, path, w.engine.device,
                    "float32" if w.config.quantize else w.config.dtype)
            if loaded[dev] is None:
                return 400, {"error": f"no loadable weights at '{path}'"}
            try:
                outcomes.append(w.apply_weights(loaded[dev], source=path))
            except Exception as exc:
                ok = False
                outcomes.append({"ok": False, "node_id": w.node_id,
                                 "error": str(exc)[:300]})
        return (200 if ok else 500), {"ok": ok, "reloaded": outcomes}

    def trace(_body):
        return 200, {
            "summary": {w.node_id: w.tracer.summary() for w in workers},
            "recent": [s for w in workers for s in w.tracer.recent(20)],
            "gateway": gateway.tracer.summary(),
            "stages": {w.node_id: w.tracer.stage_summary()
                       for w in workers},
        }

    def trace_export(_body):
        recs = {w.node_id: w.tracer for w in workers}
        recs["gateway"] = gateway.tracer
        return 200, export_chrome(recs)

    def admin_profile(body):
        """{"ticks": N, "node"?} arms one lane's tick-bounded capture
        (its ``profile_dir``); {"action": "status"} reports it;
        {"action": "start"|"stop", "log_dir"} drives a whole-process
        torch.profiler session."""
        from tpu_engine_torch.utils import tracing

        body = body or {}
        if body.get("action") == "start":
            return 200, tracing.profiler_start(body.get(
                "log_dir", os.path.join(tempfile.gettempdir(),
                                        "tpu_engine_torch_profile")))
        if body.get("action") == "stop":
            return 200, tracing.profiler_stop()
        targets = lanes_of(body)
        if not targets:
            return 404, {"error": f"unknown node '{body.get('node')}'"}
        if body.get("action") == "status" or body.get("ticks"):
            return 200, targets[0].handle_profile(body)
        return 400, {"error": "action must be start|stop|status, "
                              "or pass ticks"}

    def admin_timeline(body):
        body = body or {}
        targets = lanes_of(body)
        if not targets:
            return 404, {"error": f"unknown node '{body.get('node')}'"}
        return 200, {"lanes": {w.node_id: w.handle_timeline(body)
                               for w in targets}}

    def named_hists():
        named: dict = {}
        for w in workers:
            for name, by_node in w.latency_histograms().items():
                named.setdefault(name, {}).update(by_node)
        return named

    routes = {
        ("POST", "/infer"): lambda body: (
            200, gateway.route_request_raw(body)),
        ("POST", "/generate"): lambda body: (
            200, gateway.route_generate(body)),
        ("POST", "/generate/stream"): lambda body: (
            200, gateway.route_generate_stream(body)),
        ("POST", "/score"): lambda body: (200, gateway.route_score(body)),
        ("GET", "/stats"): stats,
        ("GET", "/health"): health,
        ("POST", "/admin/fault"): admin_fault,
        ("POST", "/admin/drain"): admin_drain,
        ("POST", "/admin/role"): admin_role,
        ("POST", "/admin/fleet"): lambda body: (
            200, gateway.fleet_admin(body or {})),
        ("POST", "/admin/reload"): admin_reload,
        ("GET", "/trace"): trace,
        ("GET", "/trace/export"): trace_export,
        ("POST", "/admin/profile"): admin_profile,
        ("GET", "/admin/profile"): lambda _b: admin_profile(
            {"action": "status"}),
        ("GET", "/admin/timeline"): admin_timeline,
        ("POST", "/admin/timeline"): admin_timeline,
        ("GET", "/metrics"): lambda _b: (
            200, render_prometheus(
                [w.get_health() for w in workers], gateway.get_stats(),
                recorders={**{w.node_id: w.tracer for w in workers},
                           "gateway": gateway.tracer},
                named_hists=named_hists()), _PROMETHEUS),
        ("GET", "/admin/slo"): lambda _b: (
            200, gateway.slo_status(named_hists()) or _NO_SLO),
    }
    for w in workers:
        routes[("GET", f"/health/{w.node_id}")] = (
            lambda _b, w=w: (200, w.get_health()))
    prefix_routes = {("GET", "/admin/trace/"): (
        lambda _b, rid: (200, gateway.stitched_trace(rid)))}
    return routes, prefix_routes


def _make_front_server(port: int, routes: dict, prefix_routes: dict,
                       workers: List[WorkerNode], gateway: Gateway,
                       use_native: bool):
    """The started front: the Python ``JsonHttpServer``, or the C++
    ``NativeHttpFront`` whose misses and other routes call ``fallback``
    (a ShedError 503, a client error 400, anything else 500; a stream is
    sent as one buffered SSE body; a content type rides
    ``tpu_front_reply2``). Each lane joins the C++ front with its cache
    and its gateway breaker, its C++ counters feed its /health, and its
    fault listener enables and disables it there; a lane the gateway adds
    later joins the same way (an HTTP lane joins the ring disabled, its
    hits left to Python), and one it removes leaves the front's ring."""
    if not use_native:
        server = JsonHttpServer(port)
        for (method, path), handler in routes.items():
            server.route(method, path, handler)
        for (method, prefix), handler in prefix_routes.items():
            server.route_prefix(method, prefix, handler)
        server.start(background=True)
        return server

    from tpu_engine_torch.core.native import NativeHttpFront, NativeLRUCache

    def fallback(method: str, path: str, body: bytes):
        handler = routes.get((method, path))
        if handler is None:
            for (m, prefix), ph in sorted(prefix_routes.items(),
                                          key=lambda kv: -len(kv[0][1])):
                if (m == method and path.startswith(prefix)
                        and len(path) > len(prefix)):
                    handler = (lambda b, _h=ph, _s=path[len(prefix):]:
                               _h(b, _s))
                    break
        if handler is None:
            return 404, json.dumps(
                {"error": f"no route {method} {path}"}).encode()
        try:
            parsed = json.loads(body or b"{}") if method == "POST" else None
            result = handler(parsed)
            status, payload = result[0], result[1]
            ctype = result[2] if len(result) == 3 else None
            if not isinstance(payload, bytes):
                if (hasattr(payload, "__iter__")
                        and not isinstance(payload, (dict, list))):
                    # An SSE iterator, drained here (its error is this
                    # reply's 500): the C++ front sends one buffer.
                    payload = b"".join(payload)
                else:
                    payload = json.dumps(payload).encode()
        except ShedError as exc:
            # The C++ reply carries no Retry-After header.
            return 503, json.dumps({"error": str(exc),
                                    "kind": exc.kind}).encode()
        except (KeyError, ValueError, TypeError) as exc:
            return 400, json.dumps({"error": str(exc)}).encode()
        except Exception as exc:
            return 500, json.dumps({"error": str(exc)}).encode()
        if ctype is not None:
            return status, payload, ctype
        return status, payload

    front = NativeHttpFront(port, fallback,
                            virtual_nodes=gateway.config.virtual_nodes,
                            fake_cached_latency_us=(
                                workers[0].config.fake_cached_latency_us))

    def join(w: WorkerNode) -> None:
        front.add_lane(w.node_id, w.cache, gateway.breaker_for(w.node_id))
        w.external_counters = (lambda name=w.node_id:
                               front.lane_counters(name))
        w.on_fault_change(lambda healthy, name=w.node_id:
                          front.set_lane_enabled(name, healthy))

    def follow(event: str, name: str, worker) -> None:
        if event == "remove":
            front.remove_lane(name)
        elif isinstance(worker, WorkerNode):
            join(worker)
        else:
            # An HTTP lane: on the ring, so that C++ routes as the gateway
            # does, but disabled: its requests go to Python.
            front.add_lane(name, NativeLRUCache(1, raw=True),
                           gateway.breaker_for(name))
            front.set_lane_enabled(name, False)

    for w in workers:
        join(w)
    gateway.on_membership(follow)
    front.start()
    return front
