"""The gateway (the port's copy of the ``Gateway`` of
``tpu_engine/serving/gateway.py``): consistent-hash routing over lanes,
each guarded by a circuit breaker, with ring-order failover. A lane is an
HTTP worker (a URL; its name ``host:port``) or an in-process
``WorkerNode`` (``LocalWorkerClient``; its name the worker's
``node_id``), which brings its model and role along.

A request goes to the ring's owner of its ``request_id`` (one is minted
when absent). When that lane fails, every other lane is tried in ring
order (``ConsistentHash.get_all_nodes``, ascending vnode hash from 0, not
clockwise from the owner). A lane fault (``WorkerError``) counts against
its breaker; a shed (``Overloaded``: the lane is draining, full or cannot
meet the deadline) fails over with no penalty, and a march that saw a
shed and found no lane ends as 503 ``overloaded``, never as the 500 "All
workers failed or unavailable". An expired deadline is a 503
``deadline_exceeded`` at admission, during failover or from a lane; each
dispatch forwards the budget left; a request without ``deadline_ms`` has
``default_deadline_ms`` (none by default). Each failover attempt waits
``backoff_delay`` (``retry_backoff_base_ms``, 0 by default: immediate;
each wait counted as ``backoff_waits``), and retries may be capped by a
global retry budget (off by default). A gateway shed carries Retry-After
``shed_retry_after_s``.

Models: in-process lanes are typed, and each model has a sub-ring of its
lanes. A request's ``model`` routes and fails over on that model's ring
(an unknown model is a 400); without one, a multi-model gateway uses the
first model registered (``default_model``). HTTP lanes carry no model: a
request naming a model none of the typed lanes serves probes the whole
ring while untyped lanes exist, and a lane's 400 for it moves on without
a penalty.

Streams are relayed frame by frame; a mid-stream lane fault (the
transport dying, or a retryable in-band error event that is not a
``shed``) counts against the lane's breaker.

What the JAX gateway adds over the reference, each off by default:

- **Overload control** (``overload_control``, ``overload_max_inflight``;
  ``tenant_rate``): an in-flight gauge over each request's whole
  residency (a stream's until its events end), the per-tenant token
  bucket (the request's ``tenant``), priority-tiered admission against
  the gauge (the request's ``priority``; an unknown value is a 400), and
  a Retry-After on every gateway shed that grows with the measured
  pressure (the gauge's fill, or the recent shed rate without a gauge).
- **Hedged dispatch** (``hedge_enabled``) of ``/infer`` and ``/score``,
  never of generation: once the primary has run longer than the best
  other lane's ``hedge_quantile`` latency (at least ``hedge_min_ms``), the
  next ring lane whose breaker admits is dispatched too; the first answer
  wins, the loser's is discarded, and the hedge draws on the retry
  budget.
- **Crash-tolerant streaming** (``failover_streams``): the gateway
  journals the tokens it relays, and a retryable mid-stream failure (a
  truncated body, a transport fault, a retryable error event, a drain
  shed) resumes the stream on another ring lane with the prompt plus
  the emitted tokens, the budget offset and the deadline left, splicing
  the continuation into one stream whose ``done`` event covers every
  token (``resumed``: the resumes). An end that cannot resume (the resume
  cap, the deadline, no lane) is the JAX terminal error event
  (``retryable``, ``trace_id``, ``tokens_emitted``, ``tokens``).
- **The health prober** (``health_probe_interval_s``): each interval
  every lane's ``/health`` on a connection of its own;
  ``health_probe_failures`` consecutive failures eject a lane from
  dispatch with no breaker penalty, the next success restores it. While
  every lane of the ring is ejected, ejection is ignored (fail open).
- **Live stream migration** (``migrate_streams``): ``remove_worker(lane,
  drain=True)`` exports each journaled stream the lane serves
  (``/admin/migrate``), dispatches its ``migrate_import`` continuation
  to the lane of the prompt's fingerprint (else the request_id's, else
  ring order) and hands it to the relay through the stream's
  ``_StreamRecord``, which splices it: zero re-prefilled tokens. Any
  failure falls back to the replay resume.
- **Disaggregated serving** (``disagg``): while the fleet has a lane of
  role ``prefill`` (read from ``/health`` at ``add_worker``) beside a
  decode-capable one, a stream's first segment is stamped ``handoff`` and
  lands on the prefill ring, its row parks after prefill, and a handoff
  orchestrator (a bounded pool of its own) exports it after prefill
  (``wait_prefill``) and continues it on the decode lane with the fewest
  journaled streams. Its ladder: no export (the hold is cancelled, the
  row decodes locally), no destination, or no splice (the replay
  resume). A blocking /generate rides the same path. ``set_worker_role``
  (``/admin/role``) flips a lane's role around a bounded drain (and
  migration), restoring the lane when the flip fails.
- **Prefix-affinity routing** (``prefix_affinity``): generate requests
  route on the fingerprint of the prompt's leading full blocks, with
  ring order when there is none, the lane is ejected or broken, skipped
  by a resume, or ``affinity_max_imbalance`` dispatches hotter than its
  least-loaded peer.
- **The fleet prefix directory** (``prefix_directory``,
  ``serving.prefix_directory``): fingerprint -> owner lane, seeded from
  the lanes' ``/health`` ``prefix_fingerprints`` by the prober and
  recorded at each generate dispatch, invalidated when a lane is
  removed, ejected or restored; a generate request whose owner is not
  its primary carries a ``prefix_hint`` for the serving lane to fetch.

``get_stats`` is the reference's ``/stats`` schema (``total_workers``,
``total_requests``, ``failovers``, ``circuit_breakers``), plus, gated as
in JAX: ``resilience`` once the layer is configured (a default deadline,
backoff, a retry budget, hedging) or has decided something, ``failover`` once streams fail over,
the prober runs or either decided something, ``migration``,
``handoff`` (with the ``roles`` map), ``affinity`` (with ``assigned``)
and ``prefix_directory`` (with the directory's entries) once their
feature is on or counted, ``overload`` once overload control or the
tenant bucket is on, ``slo`` with an objective and ``trace_ledger`` with
stitching.

Tracing (the JAX gateway's spans, in its ring ``tracer``): a ``route``
span per request with an ``attempt`` child per dispatch (kind primary,
retry or hedge) and zero-duration ``resilience``, ``overload``,
``affinity``, ``prefix_dir``, ``migration`` and ``kv_handoff`` markers,
one per counted decision (a family's ``SPAN_FIELDS``); a ``resume`` span
per stream resume and a ``prober`` marker per ejection or restore. The
request's context is forwarded to a lane only when the client sent a
``traceparent``. With ``trace_stitch`` a stream's dispatches carry its
root context, the stream ledger records the lanes that served it
(``admit``, ``handoff``, ``migrate`` and ``resume`` hops) and a
``stream`` root span closes it, so ``stitched_trace`` merges its spans
from every lane into one tree. The ``slo_*`` objectives
(``serving.slo``) read the lanes' TTFT and ITL and the gateway's own
stream completions: ``slo_status``.

``native_breakers=True`` makes every lane's breaker the C++ one
(``core.native.NativeCircuitBreaker``), which the combined server's native
front shares for its hit path. The autoscaler is not ported: it refuses
by name (``utils.config.refuse_unported``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import threading
import time
import uuid
from typing import Dict, List, Optional

from tpu_engine_torch.core.circuit_breaker import CircuitBreaker
from tpu_engine_torch.core.consistent_hash import ConsistentHash
from tpu_engine_torch.serving.clients import (
    HttpWorkerClient,
    LocalWorkerClient,
    WorkerError,
)
from tpu_engine_torch.serving.http import sse_event
from tpu_engine_torch.serving.overload import (
    OverloadCounters,
    SheddingStats,
    TenantRateLimiter,
    TIER_ADMIT_FRAC,
    TIER_NAMES,
    load_retry_after,
    parse_priority,
    tier_limit,
)
from tpu_engine_torch.serving.prefix_directory import PrefixDirectory
from tpu_engine_torch.serving.resilience import (
    AffinityCounters,
    FailoverCounters,
    HandoffCounters,
    LatencyTracker,
    MigrationCounters,
    PrefixDirCounters,
    ProbeStateMachine,
    ResilienceCounters,
    RetryBudget,
    backoff_delay,
)
from tpu_engine_torch.serving.slo import (
    OBJECTIVE_SOURCES,
    SloTracker,
    completion_hists,
)
from tpu_engine_torch.utils.config import GatewayConfig
from tpu_engine_torch.utils.deadline import (
    Deadline,
    DeadlineExceeded,
    Overloaded,
    ShedError,
)
from tpu_engine_torch.utils.tracing import (
    SpanRecorder,
    TraceContext,
    stitch_trace,
)


class GatewayError(Exception):
    pass


# The idempotent ops hedged dispatch may fire twice; generation never.
_HEDGEABLE_OPS = frozenset({"infer", "infer_raw", "score"})

# _try_node's answer for a lane that shed the request: a failure for
# failover, but told apart from a fault so a ring that only sheds answers
# 503, not 500.
_SHED = object()


def _ok(result) -> bool:
    return result is not None and result is not _SHED


def _parse_sse(frame: bytes) -> Optional[dict]:
    """One SSE frame -> its JSON payload, or None if it is not one."""
    try:
        text = frame.decode().strip()
    except Exception:
        return None
    if not text.startswith("data: "):
        return None
    try:
        evt = json.loads(text[len("data: "):])
    except Exception:
        return None
    return evt if isinstance(evt, dict) else None


class _StreamRecord:
    """One journaled stream's mobility state: the lane serving it, and the
    one-shot exchange through which a migration or handoff orchestrator
    hands the relay its continuation (iterator and destination lane). The
    exchange ends exactly once under ``_hlock``: offered, failed or
    abandoned; an orchestrator whose offer lost the race against the
    relay's timeout disposes of its continuation itself."""

    __slots__ = ("request_id", "payload", "deadline", "ctx", "lane",
                 "_hlock", "_ready", "_it", "_dest", "_error",
                 "_abandoned", "handoff", "spliced_handoff")

    def __init__(self, request_id: str, payload: dict, deadline, ctx,
                 lane: Optional[str]):
        self.request_id = request_id
        self.payload = payload
        self.deadline = deadline
        self.ctx = ctx
        self.lane = lane
        # True while the prefill -> decode handoff orchestrator owns the
        # stream's next migrated terminal (counted as a handoff, not a
        # migration); spliced_handoff: whether the latest splice was one,
        # so a later import refusal is counted in the right family.
        self.handoff = False
        self.spliced_handoff = False
        self._hlock = threading.Lock()
        self._ready = threading.Event()
        self._it = None
        self._dest: Optional[str] = None
        self._error: Optional[str] = None
        self._abandoned = False

    def offer(self, it, dest: str) -> bool:
        """Orchestrator: hand the continuation to the relay; False when
        the relay already gave up waiting (the caller disposes of
        ``it``)."""
        with self._hlock:
            if self._abandoned or self._ready.is_set():
                return False
            self._it, self._dest = it, dest
            self._ready.set()
            return True

    def fail(self, reason: str) -> None:
        """Orchestrator: no continuation is coming; the relay replays."""
        with self._hlock:
            if not self._abandoned and not self._ready.is_set():
                self._error = reason
                self._ready.set()

    def await_handoff(self, timeout_s: float):
        """Relay: the orchestrator's verdict, (iterator, lane) or None
        (failed or timed out). After a timeout the slot is abandoned (a
        late offer is refused); an offer that raced in before this lock
        still wins. The slot re-arms for a later migration."""
        ok = self._ready.wait(timeout=max(0.0, timeout_s))
        with self._hlock:
            if self._it is not None:
                out = (self._it, self._dest)
                self._abandoned = False
            else:
                out = None
                self._abandoned = not ok and self._error is None
            self._ready.clear()
            self._it = self._dest = self._error = None
            return out

    def rearm(self) -> None:
        """Relay: clear a stale abandonment when a new segment starts."""
        with self._hlock:
            if not self._ready.is_set():
                self._abandoned = False

    def pending_offer(self) -> bool:
        """Whether an offered continuation waits unconsumed."""
        with self._hlock:
            return self._ready.is_set() and self._it is not None

    def take_unconsumed(self):
        """Stream teardown: pop an offered continuation the relay never
        took, for the caller to dispose of."""
        with self._hlock:
            if self._ready.is_set() and self._it is not None:
                it = self._it
                self._it = self._dest = self._error = None
                self._ready.clear()
                return it
            return None


class _RouteTrace:
    """One request's trace state through the routing layers: the route
    span's context (attempts and decision markers parent here) and
    whether the client sent a traceparent (only then is the context
    forwarded to lanes, so an untraced request's wire bytes stay the
    same)."""

    __slots__ = ("request_id", "parent", "ctx", "outcome")

    def __init__(self, request_id: str, parent: Optional[TraceContext]):
        self.request_id = request_id
        self.parent = parent
        self.ctx = (parent.child() if parent is not None
                    else TraceContext.root(request_id))
        self.outcome = "error"

    @property
    def traced(self) -> bool:
        return self.parent is not None


class _StreamLedger:
    """The lanes that served each request_id, hop by hop (``admit``,
    ``resume``): the index the stitch walks to know whose rings hold a
    stream's spans. Entries outlive their streams (a stitch is read
    afterwards); a bounded FIFO with its own lock."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._llock = threading.Lock()

    def hop(self, request_id: str, lane: str, kind: str,
            trace_id: Optional[str] = None) -> None:
        with self._llock:
            ent = self._entries.get(request_id)
            if ent is None:
                while len(self._entries) >= self.capacity:
                    self._entries.popitem(last=False)
                ent = {"trace_id": trace_id, "hops": []}
                self._entries[request_id] = ent
            elif trace_id and not ent["trace_id"]:
                ent["trace_id"] = trace_id
            ent["hops"].append({"lane": lane, "kind": kind,
                                "ts": round(time.time(), 6)})

    def get(self, request_id: str) -> Optional[dict]:
        with self._llock:
            ent = self._entries.get(request_id)
            if ent is None:
                return None
            return {"trace_id": ent["trace_id"],
                    "hops": [dict(h) for h in ent["hops"]]}

    def summary(self) -> dict:
        with self._llock:
            return {"streams": len(self._entries),
                    "capacity": self.capacity,
                    "hops": sum(len(e["hops"])
                                for e in self._entries.values())}


class Gateway:
    def __init__(self, workers=None, config: Optional[GatewayConfig] = None,
                 native_breakers: bool = False):
        """``workers``: worker URLs (``host``, ``host:port`` or
        ``http://host:port``) and in-process ``WorkerNode`` lanes.
        ``native_breakers``: every lane's breaker is the C++ one."""
        self.config = config or GatewayConfig()
        self._native_breakers = bool(native_breakers)
        self._ring = ConsistentHash(self.config.virtual_nodes)
        # One sub-ring per model of the typed (in-process) lanes, the
        # untyped (HTTP) lanes, and the model of a request without one
        # on a multi-model gateway (the first registered).
        self._model_rings: Dict[str, ConsistentHash] = {}
        self._untyped: set = set()
        self.default_model: Optional[str] = None
        self._clients: Dict[str, object] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()
        self._total_requests = 0
        self._failovers = 0
        self.resilience = ResilienceCounters()
        self.failover = FailoverCounters()
        # Live stream migration and disaggregated serving: the journaled
        # streams the orchestrators find (under _lock), each decision
        # counted with a marker span; the role map (absent = "both",
        # under _lock) and the ring of prefill-capable lanes.
        self.migration = MigrationCounters()
        self._streams: Dict[str, _StreamRecord] = {}
        self.handoff = HandoffCounters()
        self._roles: Dict[str, str] = {}
        self._prefill_ring = ConsistentHash(self.config.virtual_nodes)
        self._handoff_exec: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        # Prefix-affinity routing: per-lane assignments and the recent
        # dispatch window of the imbalance fallback (under _lock).
        self.affinity = AffinityCounters()
        self._affinity_assigned: Dict[str, int] = {}
        self._lane_recent: Dict[str, collections.deque] = {}
        # The fleet prefix directory (under _lock); None when off.
        self.prefix_dir = PrefixDirCounters()
        self._prefix_dir_on = bool(self.config.prefix_directory)
        self._prefix_dir: Optional[PrefixDirectory] = (
            PrefixDirectory(self.config.prefix_directory_capacity)
            if self._prefix_dir_on else None)
        self._retry_budget = RetryBudget(self.config.retry_budget_ratio,
                                         self.config.retry_budget_min,
                                         self.config.retry_budget_window_s)
        # Per-lane latency windows of hedged primaries: a lane's own
        # slowness never raises the threshold it is judged by.
        self._latency: Dict[str, LatencyTracker] = {}
        self._hedge_pool: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self.overload = OverloadCounters()
        self._tenant_bucket: Optional[TenantRateLimiter] = (
            TenantRateLimiter(self.config.tenant_rate,
                              self.config.tenant_burst)
            if self.config.tenant_rate > 0 else None)
        # Requests inside the routing layer (under _lock): the gauge the
        # tier fractions admit against.
        self._inflight = 0
        self._shed_stats = SheddingStats()
        self._ejected: set = set()
        self._probe_state = ProbeStateMachine(
            self.config.health_probe_failures)
        self._prober_stop = threading.Event()
        self._prober_thread: Optional[threading.Thread] = None
        # The gateway's own span ring, the stream ledger (stitching on)
        # and the SLO tracker (an objective set).
        self.tracer = SpanRecorder(self.config.trace_capacity)
        self._ledger: Optional[_StreamLedger] = (
            _StreamLedger(self.config.trace_ledger_capacity)
            if self.config.trace_stitch else None)
        self._slo = SloTracker.from_config(self.config)
        for w in workers or []:
            self.add_worker(w)
        if self.config.health_probe_interval_s > 0:
            self._prober_thread = threading.Thread(
                target=self._probe_loop, name="gw-prober", daemon=True)
            self._prober_thread.start()

    def stop(self) -> None:
        """Stop the health prober (idempotent; routing keeps working)."""
        self._prober_stop.set()
        t = self._prober_thread
        if t is not None:
            t.join(timeout=5)
            self._prober_thread = None

    # -- membership -----------------------------------------------------------

    def add_worker(self, worker) -> str:
        """Register a lane: an HTTP worker's URL (lane name
        ``"host:port"``, untyped) or an in-process ``WorkerNode`` (lane
        name its ``node_id``, typed by its model, with its role)."""
        cfg = self.config
        model_name = None
        role = "both"
        if isinstance(worker, str):
            client = HttpWorkerClient(worker, timeout_s=cfg.worker_timeout_s,
                                      default_port=cfg.default_worker_port,
                                      gen_timeout_s=cfg.gen_timeout_s)
            name = client.url
            if cfg.disagg:
                # Role discovery (a URL carries none): one best-effort
                # /health read; no key or no answer reads "both".
                try:
                    role = str(client.health().get("role", "both"))
                except Exception:
                    role = "both"
        else:
            client = LocalWorkerClient(worker)
            name = worker.node_id
            model_name = worker.engine.spec.name
            role = str(worker.config.role or "both")
        if role not in ("prefill", "decode", "both"):
            role = "both"
        with self._lock:
            self._clients[name] = client
            self._breakers[name] = self._make_breaker()
            if role != "both":
                self._roles[name] = role
            if model_name is None:
                self._untyped.add(name)
        self._ring.add_node(name)
        if role != "decode":
            self._prefill_ring.add_node(name)
        if model_name is not None:
            with self._lock:
                ring = self._model_rings.get(model_name)
                if ring is None:
                    # Filled before it is published: a concurrent route
                    # never sees an empty ring of a registered model.
                    ring = ConsistentHash(cfg.virtual_nodes)
                    ring.add_node(name)
                    self._model_rings[model_name] = ring
                else:
                    ring.add_node(name)
                if self.default_model is None:
                    self.default_model = model_name
        return name

    def _make_breaker(self):
        cfg = self.config
        if self._native_breakers:
            from tpu_engine_torch.core.native import NativeCircuitBreaker

            return NativeCircuitBreaker(cfg.failure_threshold,
                                        cfg.success_threshold,
                                        cfg.breaker_timeout_s)
        return CircuitBreaker(cfg.failure_threshold, cfg.success_threshold,
                              cfg.breaker_timeout_s)

    def remove_worker(self, name: str, drain: bool = False) -> None:
        """Take a lane off the ring. ``drain=True`` first asks it to drain
        (new admissions shed 503 while in-flight work completes), waiting
        at most ``drain_timeout_s`` for its answer: a lane that does not
        answer is counted (``drain_failures``) and removed anyway. With
        ``migrate_streams`` every journaled stream the lane serves is then
        exported and continued on another lane with zero re-prefilled
        tokens before the lane leaves the ring; a stream whose migration
        fails falls back to the replay resume."""
        if drain:
            with self._lock:
                client = self._clients.get(name)
            if client is not None:
                err = self._bounded_drain(client, name)
                if err is not None:
                    self._migration_count(None, "drain_failures",
                                          lane=name, error=err[:120])
            if self.config.migrate_streams:
                self._migrate_lane_streams(name, client)
        self._ring.remove_node(name)
        self._prefill_ring.remove_node(name)
        with self._lock:
            rings = list(self._model_rings.values())
            self._clients.pop(name, None)
            self._breakers.pop(name, None)
            self._latency.pop(name, None)
            self._lane_recent.pop(name, None)
            self._untyped.discard(name)
            self._ejected.discard(name)
            self._roles.pop(name, None)
            # The departing lane's radix tree leaves with it: every
            # directory entry naming it is a dead hint.
            pd_dropped = (self._prefix_dir.invalidate_lane(name)
                          if self._prefix_dir is not None else None)
        if pd_dropped is not None:
            self._prefix_dir_count("invalidations", lane=name,
                                   action="remove", dropped=pd_dropped)
        self._probe_state.forget(name)
        for ring in rings:
            ring.remove_node(name)
        with self._lock:
            # Emptied sub-rings go, and the default moves off a model
            # whose last lane left.
            for mdl, ring in list(self._model_rings.items()):
                if not ring.get_all_nodes():
                    del self._model_rings[mdl]
            if self.default_model not in self._model_rings:
                self.default_model = (sorted(self._model_rings)[0]
                                      if self._model_rings else None)

    def _bounded_drain(self, client, name: str) -> Optional[str]:
        """None when ``client.drain()`` answered within
        ``drain_timeout_s``, else why not (the call is abandoned to its
        daemon thread)."""
        err: List[str] = ["drain timed out"]

        def run():
            try:
                client.drain()
                err[0] = ""
            except Exception as exc:
                err[0] = str(exc) or type(exc).__name__

        t = threading.Thread(target=run, name=f"gw-drain-{name}",
                             daemon=True)
        t.start()
        t.join(timeout=self.config.drain_timeout_s)
        return err[0] or None

    def worker_names(self) -> List[str]:
        return self._ring.get_all_nodes()

    def lane_clients(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._clients)

    def breaker_for(self, name: str) -> Optional[CircuitBreaker]:
        with self._lock:
            return self._breakers.get(name)

    # -- the health prober ----------------------------------------------------

    def _probe_loop(self) -> None:
        """Each interval, every lane's /health on a dedicated connection:
        a probe fails when the lane is unreachable or answers
        ``healthy: false``; the state machine's eject and restore move
        the lane out of and back into dispatch, with no breaker penalty
        and a ``prober`` marker span per eject or restore."""
        interval = self.config.health_probe_interval_s
        while not self._prober_stop.wait(interval):
            with self._lock:
                clients = dict(self._clients)
            for name, client in clients.items():
                try:
                    body = getattr(client, "probe_health",
                                   client.health)()
                    ok = bool(body.get("healthy", False))
                    # Directory seeding rides the same read: the lane's
                    # bounded radix summaries (with prefix fetch on).
                    if self._prefix_dir_on:
                        self._seed_prefix_dir(
                            name, body.get("prefix_fingerprints"))
                except Exception:
                    ok = False
                action = self._probe_state.record(name, ok)
                with self._lock:
                    present = name in self._clients
                if not present:
                    # Removed while this sweep held the stale snapshot.
                    self._probe_state.forget(name)
                    continue
                if action is None:
                    continue
                with self._lock:
                    if name not in self._clients:
                        continue
                    if action == "eject":
                        self._ejected.add(name)
                    else:
                        self._ejected.discard(name)
                self.failover.bump("prober_ejections" if action == "eject"
                                   else "prober_restores")
                self._prober_span(name, action)
                # Both void the lane's directory entries: an ejected lane
                # serves no fetch, a restored one may have restarted
                # empty.
                if self._prefix_dir_on:
                    with self._lock:
                        dropped = self._prefix_dir.invalidate_lane(name)
                    self._prefix_dir_count("invalidations", lane=name,
                                           action=action, dropped=dropped)

    def _prober_span(self, lane: str, action: str) -> None:
        """A zero-duration ``prober`` marker: which lane, when."""
        ctx = TraceContext.root(f"prober:{lane}").child()
        self.tracer.record(
            "prober", "prober", "gateway", 0,
            trace_id=ctx.trace_id, span_id=ctx.span_id,
            start_ts=time.time(), attrs={"lane": lane, "action": action})

    def ejected_lanes(self) -> List[str]:
        with self._lock:
            return sorted(self._ejected)

    # -- routes ---------------------------------------------------------------

    def route_request(self, payload: dict) -> dict:
        return self._route(payload, op="infer")

    def route_request_raw(self, payload: dict) -> bytes:
        """/infer with the lane's response bytes relayed unparsed."""
        return self._route(payload, op="infer_raw")

    def route_score(self, payload: dict) -> dict:
        return self._route(payload, op="score")

    def route_generate(self, payload: dict) -> dict:
        """/generate through the ring; while the fleet is split for
        disaggregated serving it rides the handoff path as a stream
        collapsed into the blocking answer."""
        if self._disagg_split() is not None:
            return self._generate_via_handoff(payload)
        return self._route(payload, op="generate")

    def route_generate_stream(self, payload: dict):
        """The serving lane's SSE frames, relayed as they arrive, its
        breaker fed by a mid-stream fault; with ``failover_streams``,
        ``migrate_streams`` or ``disagg`` the stream is journaled
        (``_stream_with_failover``): a retryable mid-stream failure
        resumes on another lane, and a migration or handoff splices its
        continuation."""
        cfg = self.config
        if cfg.failover_streams or cfg.migrate_streams or cfg.disagg:
            return self._stream_with_failover(payload)
        info: dict = {}
        it = self._route(payload, op="generate_stream", out_info=info)
        return self._breaker_watched(it, info.get("lane"))

    def _breaker_watched(self, it, lane: Optional[str]):
        """Relay ``it`` unchanged; a transport fault or a retryable
        in-band error event that is not a ``shed`` counts against the
        lane's breaker (a request fault and a shed do not)."""
        def watched():
            try:
                for frame in it:
                    if b'"done"' in frame:
                        evt = _parse_sse(frame)
                        if (evt is not None and evt.get("done")
                                and "error" in evt
                                and evt.get("retryable")
                                and not evt.get("shed")):
                            self._stream_fault_penalty(lane)
                    yield frame
            except (KeyError, ValueError, TypeError):
                raise
            except ShedError as exc:
                if exc.lane_suspect:
                    self._stream_fault_penalty(lane)
                raise
            except Exception:
                self._stream_fault_penalty(lane)
                raise
        return watched()

    def _stream_fault_penalty(self, lane: Optional[str]) -> None:
        breaker = self.breaker_for(lane) if lane else None
        if breaker is not None:
            breaker.record_failure()

    # -- crash-tolerant streaming ---------------------------------------------

    @staticmethod
    def _resume_payload(payload: dict, emitted: List[int], max_new: int,
                        deadline: Optional[Deadline]) -> dict:
        """The resume request: the emitted tokens appended to the prompt,
        the token budget offset by their count, and the deadline's budget
        left now (a resume never restarts the client's clock). Sampling
        folds the seed with the absolute position, so greedy and seeded
        continuations equal an unbroken run."""
        prompt = [int(t) for t in payload.get("prompt_tokens", ())]
        resume = {**payload,
                  "prompt_tokens": prompt + list(emitted),
                  "max_new_tokens": max_new - len(emitted)}
        if deadline is not None:
            resume["deadline_ms"] = max(0.0, deadline.remaining_ms())
        return resume

    def _stream_with_failover(self, payload: dict):
        """/generate/stream with the stream journal: the payload and every
        token relayed so far. A retryable mid-stream failure resumes on
        the next ring lane, skipping the lane that failed, through the
        retry budget and within the original deadline (a ``resume`` span
        each; the resuming lane's flight recorder dumps); a failure that
        cannot resume ends with the terminal error event. A ``migrated``
        terminal (the row was exported) waits for the migration or
        handoff orchestrator's continuation and splices it; without one
        the stream replays. While the fleet is split for disaggregated
        serving the first segment is stamped ``handoff`` and the handoff
        orchestrator takes the stream from its prefill lane to a decode
        lane. With ``trace_stitch`` every dispatch carries the stream's
        root context, the ledger records each lane (``admit``,
        ``handoff``, ``migrate``, ``resume``) and a ``stream`` root span
        records when the stream ends."""
        rid = payload.get("request_id")
        if rid is None:
            rid = uuid.uuid4().hex
            payload = {**payload, "request_id": rid}
        request_id = str(rid)
        deadline = Deadline.from_request(
            payload, default_ms=self.config.default_deadline_ms)
        try:
            max_new = int(payload.get("max_new_tokens", 32))
        except (TypeError, ValueError):
            # A malformed budget: the plain path answers it with a 400.
            return self._route(payload, op="generate_stream")
        parent = TraceContext.from_request(payload)
        ctx = (parent.child() if parent is not None
               else TraceContext.root(request_id))
        cfg = self.config
        ledger = self._ledger
        t_root = time.time()
        if ledger is not None:
            # Every segment (the first, each resume, each continuation)
            # joins the stream's root span; without stitching the payload
            # is untouched.
            payload = {**payload, "traceparent": ctx.to_traceparent()}
        # While the fleet is split, the first segment is stamped
        # `handoff`: it lands on a prefill lane, which parks the row after
        # prefill. The record keeps the unstamped payload, so resumes and
        # continuations never park.
        disagg = self._disagg_split() is not None
        dispatch_payload = payload
        if disagg:
            dispatch_payload = {
                **payload, "handoff": True,
                "handoff_park_ms": cfg.handoff_timeout_s * 1000.0}
        info: dict = {}
        # The first segment's admission keeps every plain-path answer
        # (shed, 400, no lane) before the 200 stream commits.
        first = self._route(dispatch_payload, op="generate_stream",
                            out_info=info)
        if ledger is not None:
            ledger.hop(request_id, info.get("lane") or "?", "admit",
                       ctx.trace_id)
        # Registered once admitted, so the orchestrators find it.
        record: Optional[_StreamRecord] = None
        if cfg.migrate_streams or disagg:
            record = _StreamRecord(request_id, payload, deadline, ctx,
                                   info.get("lane"))
            with self._lock:
                self._streams[request_id] = record
        if disagg and record is not None:
            lane = info.get("lane")
            with self._lock:
                lane_role = self._roles.get(lane, "both")
            if lane_role == "prefill":
                self._handoff_pool().submit(self._handoff_stream,
                                            record, lane)
            else:
                # Landed colocated (ring order past the prefill lanes): the
                # lane decodes it itself; release the park so the row
                # never waits out a window nobody will collect.
                self._handoff_pool().submit(self._cancel_colocated_hold,
                                            record, lane)

        def terminal_error(reason: str, retryable: bool,
                           emitted: List[int]) -> bytes:
            return sse_event({
                "done": True, "error": str(reason)[:300],
                "retryable": bool(retryable),
                "request_id": request_id, "trace_id": ctx.trace_id,
                "tokens_emitted": len(emitted),
                "tokens": list(emitted)})

        def spliced_inner():
            emitted: List[int] = []
            it = first
            lane = info.get("lane")
            resumes = 0
            while True:
                # (reason, retryable, lane_fault): lane_fault feeds the
                # lane's breaker; sheds and spent budgets do not.
                failure: Optional[tuple] = None
                finished = False
                migrated_evt = False
                try:
                    try:
                        for frame in it:
                            evt = _parse_sse(frame)
                            if evt is None:
                                yield frame
                                continue
                            if not evt.get("done"):
                                toks = evt.get("tokens")
                                if isinstance(toks, list):
                                    # Converted before the journal grows:
                                    # a malformed token never leaves the
                                    # journal ahead of the client.
                                    emitted.extend([int(t) for t in toks])
                                yield frame
                                continue
                            if "error" in evt:
                                # The lane's own classification decides
                                # (absent: not retryable); a `shed` lane
                                # is healthy; `migrated`: the row was
                                # exported, its continuation is coming.
                                retr = bool(evt.get("retryable", False))
                                migrated_evt = bool(evt.get("migrated"))
                                if (evt.get("import_refused")
                                        and record is not None):
                                    # The spliced continuation's import
                                    # was refused: the fallback belongs
                                    # to the migration or the handoff,
                                    # not to a lane fault.
                                    if record.spliced_handoff:
                                        self._handoff_count(
                                            "handoff_fallbacks",
                                            record=record, lane=lane,
                                            cause="import_refused")
                                    else:
                                        self._migration_count(
                                            record, "migration_fallbacks",
                                            lane=lane,
                                            cause="import_refused")
                                failure = (str(evt.get("error")), retr,
                                           retr
                                           and not evt.get("shed", False)
                                           and not migrated_evt
                                           and not evt.get(
                                               "import_refused", False))
                            else:
                                # The summary of the whole spliced stream.
                                done = {**evt, "request_id": request_id,
                                        "tokens": list(emitted)}
                                if resumes:
                                    done["resumed"] = resumes
                                yield sse_event(done)
                                finished = True
                            break
                        else:
                            # No terminal event: the lane died between
                            # frames (a killed process closes the socket).
                            failure = ("stream truncated mid-generation",
                                       True, True)
                    finally:
                        if finished:
                            # Read one step past the done event so an
                            # HTTP segment's connection returns clean.
                            try:
                                next(it)
                            except Exception:
                                pass
                        try:
                            it.close()
                        except Exception:
                            pass
                except DeadlineExceeded as exc:
                    failure = (str(exc), False, exc.lane_suspect)
                except ShedError as exc:
                    failure = (str(exc), True, False)
                except Exception as exc:
                    failure = (str(exc), True, True)
                if finished:
                    return
                reason, retryable, lane_fault = failure
                if migrated_evt and record is not None:
                    # The row was exported: wait for the orchestrator's
                    # continuation (within the transfer budget and the
                    # deadline) and splice it; any failure replays below.
                    is_handoff = record.handoff
                    wait_s = (cfg.handoff_timeout_s if is_handoff
                              else cfg.migrate_timeout_s) + 5.0
                    if deadline is not None:
                        wait_s = min(wait_s,
                                     max(0.0, deadline.remaining_s()))
                    handoff = record.await_handoff(wait_s)
                    if handoff is not None:
                        it, new_lane = handoff
                        lane = new_lane
                        record.lane = new_lane
                        record.spliced_handoff = is_handoff
                        if ledger is not None:
                            ledger.hop(request_id, new_lane or "?",
                                       "handoff" if is_handoff
                                       else "migrate", ctx.trace_id)
                        if is_handoff:
                            record.handoff = False
                            self._handoff_count("handoffs_spliced",
                                                record=record,
                                                lane=new_lane)
                            self.handoff.bump("tokens_handed_off",
                                              len(emitted))
                        else:
                            self._migration_count(record,
                                                  "streams_migrated",
                                                  lane=new_lane)
                            self.migration.bump("tokens_migrated",
                                                len(emitted))
                        continue
                    if is_handoff:
                        record.handoff = False
                        self._handoff_count("handoff_fallbacks",
                                            record=record, lane=lane)
                        reason = (f"handoff fell back to replay "
                                  f"({reason})")
                    else:
                        self._migration_count(record,
                                              "migration_fallbacks",
                                              lane=lane)
                        reason = (f"migration fell back to replay "
                                  f"({reason})")
                    retryable = True
                self.failover.bump("stream_failures")
                if lane_fault:
                    self._stream_fault_penalty(lane)
                if len(emitted) >= max_new > 0:
                    # The whole budget was delivered, only the terminal
                    # frame was lost: nothing to resume.
                    done = {"done": True, "request_id": request_id,
                            "tokens": list(emitted)}
                    if resumes:
                        done["resumed"] = resumes
                    yield sse_event(done)
                    return
                if not retryable:
                    yield terminal_error(reason, False, emitted)
                    return
                if deadline is not None and deadline.expired():
                    self.resilience.bump("deadline_expired")
                    yield terminal_error(
                        f"deadline exceeded after mid-stream failure "
                        f"({reason})", False, emitted)
                    return
                if resumes >= cfg.failover_max_resumes:
                    yield terminal_error(
                        f"stream failed after {resumes} resumes "
                        f"({reason})", True, emitted)
                    return
                # The resume's dispatch draws on the retry budget as any
                # failover does (the failed lane is skipped, so the march
                # charges one token per lane tried).
                resumes += 1
                replayed = len(emitted)
                self.failover.bump("resumes_attempted")
                self.failover.bump("tokens_replayed", replayed)
                resume = self._resume_payload(payload, emitted, max_new,
                                              deadline)
                nxt_info: dict = {}
                try:
                    it = self._route(resume, op="generate_stream",
                                     skip=(lane,) if lane else (),
                                     out_info=nxt_info)
                except Exception as exc:
                    self.failover.bump("resumes_failed")
                    self._resume_span(request_id, ctx, resumes, replayed,
                                      "failed", lane)
                    yield terminal_error(
                        f"resume dispatch failed ({exc})",
                        not isinstance(exc, DeadlineExceeded), emitted)
                    return
                self.failover.bump("resumes_succeeded")
                lane = nxt_info.get("lane")
                self._resume_span(request_id, ctx, resumes, replayed, "ok",
                                  lane)
                if ledger is not None:
                    ledger.hop(request_id, lane or "?", "resume",
                               ctx.trace_id)
                # A lane death is an anomaly: the resuming lane's flight
                # recorder dumps (a no-op without one).
                client = self.lane_clients().get(lane or "")
                if client is not None:
                    try:
                        client.flight_dump(f"failover_resume:{request_id}")
                    except Exception:
                        pass
                if record is not None:
                    # The replay segment owns the stream now: a later
                    # drain of its lane must find it.
                    record.lane = lane
                    record.rearm()

        def spliced():
            try:
                yield from spliced_inner()
            finally:
                if ledger is not None:
                    # The stream's root span (span_id ctx.span_id): every
                    # segment's route span and each hop marker parent here.
                    self.tracer.record(
                        request_id, "stream", "gateway",
                        (time.time() - t_root) * 1e6,
                        trace_id=ctx.trace_id, span_id=ctx.span_id,
                        parent_id=(parent.span_id
                                   if parent is not None else None),
                        start_ts=t_root, attrs={"stitched": True})
                if record is not None:
                    with self._lock:
                        if self._streams.get(request_id) is record:
                            del self._streams[request_id]
                    # A continuation offered but never taken (the stream
                    # ended another way): dispose of it, or its lane's
                    # admission slot stays held.
                    orphan = record.take_unconsumed()
                    if orphan is not None:
                        self._dispose_iter(orphan)
        return spliced()

    def _resume_span(self, request_id: str, ctx: TraceContext, index: int,
                     replayed: int, outcome: str,
                     lane: Optional[str]) -> None:
        """One ``resume`` span per resume attempt, under the stream's
        trace: resumes_attempted equals these spans."""
        child = ctx.child()
        self.tracer.record(
            request_id, "resume", "gateway", 0,
            trace_id=child.trace_id, span_id=child.span_id,
            parent_id=ctx.span_id, start_ts=time.time(),
            attrs={"resume": index, "tokens_replayed": replayed,
                   "outcome": outcome, "lane": lane or "?"})

    # -- live stream migration ------------------------------------------------

    def _migration_count(self, record: Optional[_StreamRecord],
                         decision: str, **attrs) -> None:
        """Bump a migration counter and record a zero-duration
        ``migration`` marker, under the stream's trace when there is
        one."""
        self.migration.bump(decision)
        if record is not None:
            child = record.ctx.child()
            rid, parent = record.request_id, record.ctx.span_id
        else:
            child = TraceContext.root(f"migration:{decision}").child()
            rid, parent = "migration", None
        self.tracer.record(
            rid, "migration", "gateway", 0,
            trace_id=child.trace_id, span_id=child.span_id,
            parent_id=parent, start_ts=time.time(),
            attrs={"decision": decision, **attrs})

    def active_streams(self) -> Dict[str, str]:
        """{request_id: serving lane} of every journaled stream the
        orchestrators can find."""
        with self._lock:
            return {rid: rec.lane or "?"
                    for rid, rec in self._streams.items()}

    def _migrate_lane_streams(self, name: str, client) -> None:
        """Export every journaled stream the draining lane serves and
        continue each on another lane, concurrently, each within its own
        deadline and the transfer budget. Returns once every migration
        settled and no offered continuation waits untaken (the caller may
        kill the source next: a relay that has not taken its continuation
        would read the dead socket first and replay)."""
        with self._lock:
            records = [r for r in self._streams.values() if r.lane == name]
        if not records:
            return
        futs = [self._pool().submit(self._migrate_stream, rec, name, client)
                for rec in records]
        concurrent.futures.wait(
            futs, timeout=self.config.migrate_timeout_s * 2.0 + 10.0)
        until = time.monotonic() + 5.0
        while time.monotonic() < until:
            with self._lock:
                live = [r for r in records
                        if self._streams.get(r.request_id) is r]
            if not any(r.pending_offer() for r in live):
                break
            time.sleep(0.05)

    def _migrate_stream(self, record: _StreamRecord, source: str,
                        client) -> None:
        """One stream's migration: export it off the source (its stream
        there ends with a ``migrated`` terminal), pick a destination,
        dispatch the ``migrate_import`` continuation and offer it to the
        relay. Every failure resolves the exchange as failed, and the
        relay's replay resume finishes the stream from the journal."""
        rid = record.request_id
        self._migration_count(record, "migrations_attempted", lane=source)
        deadline = record.deadline
        budget = self.config.migrate_timeout_s
        if deadline is not None:
            budget = min(budget, max(0.1, deadline.remaining_s()))
        export = None
        refused_cleanly = True
        try:
            reason = "source lane has no migrate surface"
            if client is not None:
                fut = self._pool().submit(client.migrate,
                                          {"request_id": rid}, budget)
                resp = fut.result(timeout=budget + 1.0)
                if resp.get("ok"):
                    export = {k: v for k, v in resp.items()
                              if k not in ("ok", "node_id")}
                else:
                    reason = str(resp.get("reason", "export refused"))
        except Exception as exc:
            refused_cleanly = False  # a late export may still land
            reason = f"export failed: {exc}"
        if export is None:
            # A clean refusal (the stream just finished, the row is still
            # prefilling) sends no terminal, so the fallback is armed only
            # when one may still arrive: a latched failure would poison a
            # later migration of the still-running stream.
            self._migration_count(record, "export_refusals", lane=source,
                                  reason=reason[:120])
            if not refused_cleanly:
                record.fail(reason)
            return
        try:
            dest = self._pick_migration_dest(record, source)
            if dest is None:
                self._migration_count(record, "destination_unavailable",
                                      lane=source)
                record.fail("no destination lane available")
                return
            cont = {**record.payload, "request_id": rid,
                    "migrate_import": export}
            if deadline is not None:
                cont["deadline_ms"] = max(0.0, deadline.remaining_ms())
            result = self._try_node(dest, cont, op="generate_stream")
            if not _ok(result):
                self._migration_count(record, "import_dispatch_failed",
                                      lane=dest)
                record.fail(f"destination {dest} refused the "
                            f"continuation")
                return
            if not record.offer(result, dest):
                # The relay timed out and replays: dispose of the orphan.
                self._dispose_iter(result)
        except Exception as exc:
            self._migration_count(record, "import_dispatch_failed",
                                  lane=source, error=str(exc)[:120])
            record.fail(f"migration failed: {exc}")

    def _pick_migration_dest(self, record: _StreamRecord,
                             source: str) -> Optional[str]:
        """The destination: the lane of the prompt's affinity fingerprint
        (its radix tree likely holds the prompt's blocks already), then
        the request_id's ring lane, then ring order; the first that is a
        member, not ejected and admitted by its breaker, never the
        source."""
        ring = self._payload_ring(record.payload)
        candidates: List[str] = []
        fp = self._affinity_fingerprint(record.payload)
        if fp is not None:
            try:
                candidates.append(ring.get_node(fp))
            except RuntimeError:
                pass
        try:
            candidates.append(ring.get_node(record.request_id))
        except RuntimeError:
            pass
        candidates += ring.get_all_nodes()
        seen = set()
        for lane in candidates:
            if lane == source or lane in seen:
                continue
            seen.add(lane)
            if self._lane_admits(lane):
                return lane
        return None

    def _payload_ring(self, payload: dict) -> ConsistentHash:
        """The ring of the payload's model (the default model's on a
        multi-model gateway without one), else the whole ring."""
        mdl = payload.get("model")
        with self._lock:
            if mdl is None and len(self._model_rings) > 1:
                mdl = self.default_model
            ring = (self._model_rings.get(str(mdl))
                    if mdl is not None else None)
        return ring if ring is not None else self._ring

    def _dispose_iter(self, it) -> None:
        """Run an orphaned stream iterator to its end in the background:
        the one way that releases the serving lane's admission slot and
        the pooled connection whether or not the generator started."""
        def drain():
            try:
                for _ in it:
                    pass
            except Exception:
                pass
            finally:
                try:
                    it.close()
                except Exception:
                    pass
        threading.Thread(target=drain, name="gw-migrate-dispose",
                         daemon=True).start()

    # -- disaggregated prefill/decode serving ---------------------------------

    def worker_roles(self) -> Dict[str, str]:
        """{lane: role} of every member lane (absent = "both")."""
        with self._lock:
            return {name: self._roles.get(name, "both")
                    for name in self._clients}

    def _disagg_split(self, ring: Optional[ConsistentHash] = None):
        """(prefill-capable, decode-capable) lanes of ``ring`` (default:
        every lane), or None unless disaggregated routing engages: the
        flag on, a dedicated prefill lane, and a decode-capable lane
        beside it. An all-"both" fleet routes as without the flag."""
        if not self.config.disagg:
            return None
        nodes = ring.get_all_nodes() if ring is not None else None
        with self._lock:
            if nodes is None:
                nodes = list(self._clients)
            roles = {n: self._roles.get(n, "both") for n in nodes}
        if not any(r == "prefill" for r in roles.values()):
            return None
        prefill = [n for n in nodes if roles[n] != "decode"]
        decode = [n for n in nodes if roles[n] != "prefill"]
        if not prefill or not decode:
            return None
        return prefill, decode

    def _lane_admits(self, lane: str) -> bool:
        """A member, not ejected, admitted by its breaker."""
        with self._lock:
            present = lane in self._clients
            ejected = lane in self._ejected
            breaker = self._breakers.get(lane)
        return (present and not ejected and breaker is not None
                and breaker.allow_request())

    def _handoff_count(self, decision: str,
                       record: Optional[_StreamRecord] = None,
                       trace: Optional[_RouteTrace] = None,
                       **attrs) -> None:
        """Bump a handoff counter and, for a span field, record a
        zero-duration ``kv_handoff`` marker under the stream's trace or
        the route span."""
        self.handoff.bump(decision)
        if decision not in HandoffCounters.SPAN_FIELDS:
            return
        if record is not None:
            child = record.ctx.child()
            rid, parent = record.request_id, record.ctx.span_id
        elif trace is not None:
            child = trace.ctx.child()
            rid, parent = trace.request_id, trace.ctx.span_id
        else:
            child = TraceContext.root(f"handoff:{decision}").child()
            rid, parent = "handoff", None
        self.tracer.record(
            rid, "kv_handoff", "gateway", 0,
            trace_id=child.trace_id, span_id=child.span_id,
            parent_id=parent, start_ts=time.time(),
            attrs={"decision": decision, **attrs})

    def _handoff_primary(self, ring: ConsistentHash, ring_primary: str,
                         payload: dict, skip: tuple,
                         trace: Optional[_RouteTrace]) -> str:
        """The primary of a stamped first segment: the prompt's affinity
        fingerprint (with prefix affinity on; else the request_id) on the
        prefill ring, then that ring's order, the first admitted
        prefill-capable lane; none admitted: ``ring_primary``
        (``prefill_unavailable``, the stream serves colocated)."""
        split = self._disagg_split(ring)
        if split is None:
            return ring_primary
        prefill_set = set(split[0])
        fp = (self._affinity_fingerprint(payload)
              if self.config.prefix_affinity else None)
        key = fp if fp is not None else str(
            payload.get("request_id") or "")
        candidates: List[str] = []
        try:
            candidates.append(self._prefill_ring.get_node(key))
        except RuntimeError:
            pass
        candidates += self._prefill_ring.get_all_nodes()
        seen = set()
        for lane in candidates:
            if lane in seen or lane in skip or lane not in prefill_set:
                continue
            seen.add(lane)
            if self._lane_admits(lane):
                self._handoff_count("prefill_routed", trace=trace,
                                    lane=lane)
                return lane
        self._handoff_count("prefill_unavailable", trace=trace)
        return ring_primary

    def set_worker_role(self, name: str, role: str) -> dict:
        """/admin/role: flip one lane's role at runtime. A bounded drain
        first (new admissions shed while the flip lands), its streams
        migrated off with ``migrate_streams``, then the lane's own flip,
        the undrain, and the role map and prefill ring. A failed flip
        undrains and reports: the lane keeps its old role everywhere."""
        role = str(role)
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be prefill|decode|both, got {role!r}")
        with self._lock:
            client = self._clients.get(name)
        if client is None:
            raise ValueError(f"unknown worker '{name}'")
        err = self._bounded_drain(client, name)
        drained = err is None
        if err is not None:
            # remove_worker's contract: counted, and the flip goes on.
            self._migration_count(None, "drain_failures", lane=name,
                                  error=err[:120])

        def _undrain():
            # Always (idempotent): a drain that timed out here may still
            # land, and this lane stays in the fleet.
            try:
                client.undrain()
            except Exception:
                pass

        if self.config.migrate_streams:
            try:
                self._migrate_lane_streams(name, client)
            except Exception as exc:
                _undrain()
                return {"ok": False, "node_id": name,
                        "error": f"migration leg failed: {exc}"[:300]}
        try:
            client.set_role(role)
        except Exception as exc:
            _undrain()
            return {"ok": False, "node_id": name, "error": str(exc)[:300]}
        _undrain()
        with self._lock:
            if role == "both":
                self._roles.pop(name, None)
            else:
                self._roles[name] = role
        if role == "decode":
            self._prefill_ring.remove_node(name)
        elif name not in self._prefill_ring.get_all_nodes():
            self._prefill_ring.add_node(name)
        self._handoff_count("role_flips", lane=name, role=role)
        return {"ok": True, "node_id": name, "role": role,
                "drained": drained}

    def _handoff_stream(self, record: _StreamRecord,
                        source: Optional[str]) -> None:
        """The prefill -> decode handoff of one stream (a handoff-pool
        thread): ask the source for an export after prefill (the command
        waits on its decode loop and snapshots the row, first token,
        sampling state and KV chain, as its prefill completes), pick a
        decode lane by load, dispatch the ``migrate_import``
        continuation and offer it to the relay. An unexported row's hold
        is cancelled and it decodes locally; an exported, unspliced
        stream replays."""
        rid = record.request_id
        record.handoff = True
        self._handoff_count("handoffs_attempted", record=record,
                            lane=source or "?")
        deadline = record.deadline
        budget = self.config.handoff_timeout_s
        if deadline is not None:
            budget = min(budget, max(0.1, deadline.remaining_s()))
        with self._lock:
            client = self._clients.get(source) if source else None
        export = None
        refused_cleanly = True
        reason = "source lane has no migrate surface"
        if client is not None:
            try:
                resp = client.migrate(
                    {"request_id": rid, "wait_prefill": True}, budget)
                if resp.get("ok"):
                    export = {k: v for k, v in resp.items()
                              if k not in ("ok", "node_id")}
                else:
                    reason = str(resp.get("reason", "export refused"))
            except Exception as exc:
                # A timed-out export may still land: a `migrated`
                # terminal may yet arrive.
                refused_cleanly = False
                reason = f"export failed: {exc}"
        if export is None:
            self._handoff_count("export_refusals", record=record,
                                lane=source or "?", reason=reason[:120])
            record.handoff = False
            if not refused_cleanly:
                record.fail(reason)
            self._cancel_source_hold(record, client, rid)
            return
        try:
            dests = self._handoff_candidates(record, source)
            if not dests:
                # The row left the source: the relay's replay finishes it.
                self._handoff_count("destination_unavailable",
                                    record=record, lane=source or "?")
                record.fail("no decode-capable destination lane")
                return
            cont = {**record.payload, "request_id": rid,
                    "migrate_import": export}
            cont.pop("handoff", None)
            cont.pop("handoff_park_ms", None)
            if deadline is not None:
                cont["deadline_ms"] = max(0.0, deadline.remaining_ms())
            result, dest = None, None
            for cand in dests:
                # A draining or full candidate sheds: try the next one.
                result = self._try_node(cand, cont, op="generate_stream")
                if _ok(result):
                    dest = cand
                    break
            if dest is None:
                self._handoff_count("dispatch_failed", record=record,
                                    lane=dests[0])
                record.fail("every decode lane refused the continuation")
                return
            if not record.offer(result, dest):
                self._dispose_iter(result)
        except Exception as exc:
            self._handoff_count("dispatch_failed", record=record,
                                lane=source or "?", error=str(exc)[:120])
            record.fail(f"handoff failed: {exc}")

    def _handoff_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        """The handoff orchestrators' own bounded pool: each waits up to
        ``handoff_timeout_s`` on its export, and must not starve hedged
        dispatches and drains."""
        with self._lock:
            if self._handoff_exec is None:
                self._handoff_exec = concurrent.futures.ThreadPoolExecutor(
                    max_workers=64, thread_name_prefix="gw-handoff")
            return self._handoff_exec

    def _cancel_colocated_hold(self, record: _StreamRecord,
                               lane: Optional[str]) -> None:
        """A stamped stream that landed on a non-prefill lane: no hop is
        coming, so release (or pre-empt) its park."""
        with self._lock:
            client = self._clients.get(lane) if lane else None
        self._cancel_source_hold(record, client, record.request_id)

    def _cancel_source_hold(self, record: _StreamRecord, client,
                            rid: str) -> None:
        """Best-effort release of a parked row after a failed export."""
        if client is None:
            return
        try:
            resp = client.migrate({"request_id": rid, "cancel": True}, 5.0)
            if resp.get("cancelled"):
                self._handoff_count("holds_cancelled", record=record)
        except Exception:
            pass

    def _handoff_candidates(self, record: _StreamRecord,
                            source: Optional[str]) -> List[str]:
        """Decode-capable destinations, best first: the fewest journaled
        streams, ring order on ties; never the source, an ejected lane or
        one whose breaker is open (a draining lane sheds at dispatch and
        the caller walks on)."""
        ring = self._payload_ring(record.payload)
        split = self._disagg_split(ring)
        decode = split[1] if split else ring.get_all_nodes()
        with self._lock:
            load: Dict[str, int] = {}
            for rec in self._streams.values():
                if rec.lane:
                    load[rec.lane] = load.get(rec.lane, 0) + 1
        order = {n: i for i, n in enumerate(ring.get_all_nodes())}
        cands = [n for n in decode if n != source and self._lane_admits(n)]
        cands.sort(key=lambda n: (load.get(n, 0), order.get(n, len(order))))
        return cands

    def _generate_via_handoff(self, payload: dict) -> dict:
        """Blocking /generate while the fleet is split: the handoff path
        as a stream, collapsed into the blocking answer. Admission
        refusals raise before any frame; a terminal error event is a
        gateway failure."""
        it = self._stream_with_failover(payload)
        final = None
        try:
            for frame in it:
                evt = _parse_sse(frame)
                if evt is not None and evt.get("done"):
                    final = evt
        finally:
            try:
                it.close()
            except Exception:
                pass
        if final is None:
            raise GatewayError("stream ended without a terminal event")
        if "error" in final:
            raise GatewayError(str(final["error"]))
        return {k: v for k, v in final.items() if k != "done"}

    # -- prefix-affinity routing ----------------------------------------------

    def _affinity_fingerprint(self, payload: dict) -> Optional[str]:
        """The prompt's leading full blocks (``affinity_block_size``
        tokens each, at most ``affinity_prefix_blocks``), the grain the
        lanes' radix trees share at: ``"prefix:"`` and the tokens. None
        without a full block or with a malformed prompt."""
        toks = payload.get("prompt_tokens")
        if not isinstance(toks, (list, tuple)):
            return None
        cfg = self.config
        bs = max(1, int(cfg.affinity_block_size))
        n = min((len(toks) // bs) * bs,
                bs * max(1, int(cfg.affinity_prefix_blocks)))
        if n <= 0:
            return None
        try:
            return "prefix:" + ",".join(str(int(t)) for t in toks[:n])
        except (TypeError, ValueError):
            return None

    def _count_lane_dispatch(self, lane: str) -> None:
        """One generate dispatch in the lane's recent window (kept only
        while the imbalance fallback reads it; trimmed on write)."""
        if int(self.config.affinity_max_imbalance) <= 0:
            return
        now = time.monotonic()
        horizon = now - self.config.affinity_window_s
        with self._lock:
            dq = self._lane_recent.get(lane)
            if dq is None:
                dq = self._lane_recent[lane] = collections.deque()
            while dq and dq[0] < horizon:
                dq.popleft()
            dq.append(now)

    def _recent_dispatches(self, lanes) -> Dict[str, int]:
        horizon = time.monotonic() - self.config.affinity_window_s
        out = {}
        with self._lock:
            for lane in lanes:
                dq = self._lane_recent.get(lane)
                while dq and dq[0] < horizon:
                    dq.popleft()
                out[lane] = len(dq) if dq else 0
        return out

    def _affinity_count(self, trace: Optional[_RouteTrace], decision: str,
                        lane: Optional[str] = None) -> None:
        """Bump an affinity counter and record a zero-duration
        ``affinity`` marker under the route span."""
        self.affinity.bump(decision)
        if trace is not None:
            child = trace.ctx.child()
            attrs = {"decision": decision}
            if lane is not None:
                attrs["lane"] = lane
            self.tracer.record(
                trace.request_id, "affinity", "gateway", 0,
                trace_id=child.trace_id, span_id=child.span_id,
                parent_id=trace.ctx.span_id, start_ts=time.time(),
                attrs=attrs)

    def _affinity_primary(self, ring: ConsistentHash, ring_primary: str,
                          payload: dict, skip: tuple,
                          trace: Optional[_RouteTrace]) -> str:
        """The lane owning the prompt's fingerprint, or ``ring_primary``
        (the request_id's lane) when there is no fingerprint, the lane is
        skipped (a resume off it), ejected or its breaker open, or it had
        ``affinity_max_imbalance`` more recent dispatches than its
        least-loaded peer."""
        fp = self._affinity_fingerprint(payload)
        if fp is None:
            self._affinity_count(trace, "no_fingerprint")
            return ring_primary
        try:
            lane = ring.get_node(fp)
        except RuntimeError:
            return ring_primary
        if skip and lane in skip:
            self._affinity_count(trace, "resume_skips", lane=lane)
            return ring_primary
        with self._lock:
            ejected = lane in self._ejected
            breaker = self._breakers.get(lane)
        if ejected or breaker is None or not breaker.allow_request():
            self._affinity_count(trace, "ejected_fallbacks", lane=lane)
            return ring_primary
        imb = int(self.config.affinity_max_imbalance)
        if imb > 0 and lane != ring_primary:
            recent = self._recent_dispatches(ring.get_all_nodes())
            if recent.get(lane, 0) - min(recent.values()) >= imb:
                self._affinity_count(trace, "imbalance_fallbacks",
                                     lane=lane)
                return ring_primary
        self._affinity_count(trace, "affinity_routed", lane=lane)
        with self._lock:
            self._affinity_assigned[lane] = (
                self._affinity_assigned.get(lane, 0) + 1)
        return lane

    # -- the fleet prefix directory -------------------------------------------

    def _prefix_dir_count(self, decision: str,
                          trace: Optional[_RouteTrace] = None,
                          **attrs) -> None:
        """Bump a directory counter and record a zero-duration
        ``prefix_dir`` marker, under the route span when there is one
        (hints, lookup misses), else at a root of its own (seeds,
        invalidations)."""
        self.prefix_dir.bump(decision)
        span_attrs = {"decision": decision,
                      **{k: v for k, v in attrs.items() if v is not None}}
        if trace is not None:
            child = trace.ctx.child()
            self.tracer.record(
                trace.request_id, "prefix_dir", "gateway", 0,
                trace_id=child.trace_id, span_id=child.span_id,
                parent_id=trace.ctx.span_id, start_ts=time.time(),
                attrs=span_attrs)
        else:
            ctx = TraceContext.root(f"prefix_dir:{decision}").child()
            self.tracer.record(
                "prefix_dir", "prefix_dir", "gateway", 0,
                trace_id=ctx.trace_id, span_id=ctx.span_id,
                start_ts=time.time(), attrs=span_attrs)

    def _seed_prefix_dir(self, lane: str, summaries) -> None:
        """A lane's /health radix summaries into directory entries: one
        ``seeded`` bump and span a sweep that recorded any (evictions are
        a value with no span)."""
        if not isinstance(summaries, list) or not summaries:
            return
        recorded = evicted = deepest = 0
        for entry in summaries[:32]:
            if not isinstance(entry, dict):
                continue
            fp = self._affinity_fingerprint(
                {"prompt_tokens": entry.get("tokens")})
            try:
                blocks = int(entry.get("blocks", 0))
            except (TypeError, ValueError):
                continue
            if fp is None or blocks <= 0:
                continue
            with self._lock:
                if lane not in self._clients:
                    return  # removed mid-sweep
                cur = self._prefix_dir.lookup(fp)
                if (cur is not None and cur["lane"] == lane
                        and cur["blocks"] >= blocks):
                    continue  # known this deep (LRU-touched)
                evicted += self._prefix_dir.record(fp, lane, blocks)
            recorded += 1
            deepest = max(deepest, blocks)
        if evicted:
            self.prefix_dir.bump("evictions", evicted)
        if recorded:
            self._prefix_dir_count("seeded", lane=lane,
                                   entries=recorded, deepest=deepest)

    def _attach_prefix_hint(self, payload: dict, primary: str,
                            trace: Optional[_RouteTrace]) -> None:
        """Stamp the fingerprint's owner lane on a generate payload as
        ``prefix_hint`` (``lane``, ``fingerprint``, ``blocks``, ``addr``),
        so the lane that serves it, wherever routing lands it, can fetch
        the owner's chain. No hint without a full block, without a live
        owner (a lookup miss), or when the owner is the primary. The hint
        rides the payload through failover."""
        fp = self._affinity_fingerprint(payload)
        if fp is None:
            return
        with self._lock:
            entry = self._prefix_dir.lookup(fp)
            client = (self._clients.get(entry["lane"])
                      if entry is not None else None)
        if entry is None or client is None:
            self._prefix_dir_count("lookup_misses", trace=trace)
            return
        if entry["lane"] == primary:
            return
        hint = {"lane": entry["lane"], "fingerprint": fp,
                "blocks": int(entry["blocks"])}
        addr = getattr(client, "url", None)  # in-process lanes have none
        if addr:
            hint["addr"] = addr
        payload["prefix_hint"] = hint
        self._prefix_dir_count("hints_attached", trace=trace,
                               lane=entry["lane"],
                               blocks=int(entry["blocks"]))

    def _record_prefix_owner(self, payload: dict, lane: str) -> None:
        """After a generate dispatch: the lane that served it indexed the
        prompt in its radix tree, so it owns the fingerprint's chain (a
        live deeper entry on another lane is kept; an unchanged entry is
        only LRU-touched, with no bump)."""
        fp = self._affinity_fingerprint(payload)
        if fp is None:
            return
        toks = payload.get("prompt_tokens") or ()
        blocks = len(toks) // max(1, int(self.config.affinity_block_size))
        if blocks <= 0:
            return
        with self._lock:
            if lane not in self._clients:
                return
            cur = self._prefix_dir.lookup(fp)
            if (cur is not None and cur["lane"] == lane
                    and cur["blocks"] >= blocks):
                return
            evicted = self._prefix_dir.record(fp, lane, blocks)
        if evicted:
            self.prefix_dir.bump("evictions", evicted)
        self._prefix_dir_count("recorded", lane=lane, blocks=blocks)

    # -- routing --------------------------------------------------------------

    def _overload_on(self) -> bool:
        return (self.config.overload_control
                or self._tenant_bucket is not None)

    def _route(self, payload: dict, op: str, skip: tuple = (),
               out_info: Optional[dict] = None):
        """``skip``: lanes this route may not use (a resume skips the lane
        its stream just failed on). ``out_info`` gets ``{"lane": name}``
        of the lane that answered. With overload control the in-flight
        gauge holds the request for its whole residency: a stream's until
        its events end."""
        overload_on = self._overload_on()
        with self._lock:
            self._total_requests += 1
            if overload_on:
                self._inflight += 1
        self._retry_budget.record_request()
        rid = payload.get("request_id")
        if rid is None:
            rid = uuid.uuid4().hex
            payload = {**payload, "request_id": rid}
        request_id = str(rid)
        trace = _RouteTrace(request_id, TraceContext.from_request(payload))
        t0 = time.perf_counter()
        start = time.time()
        handed_off = False
        try:
            result = self._route_inner(payload, op, request_id, trace,
                                       skip, out_info)
            trace.outcome = "ok"
            if overload_on and op == "generate_stream":
                result = self._inflight_watched(result)
                handed_off = True
            return result
        except ShedError as exc:
            trace.outcome = exc.kind
            raise
        finally:
            if overload_on:
                if not handed_off:
                    with self._lock:
                        self._inflight -= 1
                self._shed_stats.record(trace.outcome == "overloaded")
            self.tracer.record(
                request_id, "route", "gateway",
                (time.perf_counter() - t0) * 1e6,
                trace_id=trace.ctx.trace_id, span_id=trace.ctx.span_id,
                parent_id=(trace.parent.span_id if trace.parent is not None
                           else None),
                start_ts=start, attrs={"op": op, "outcome": trace.outcome})

    def _count(self, trace: Optional[_RouteTrace], decision: str) -> None:
        """Bump a resilience counter and record a zero-duration
        ``resilience`` marker under the request's route span."""
        self.resilience.bump(decision)
        if trace is not None:
            child = trace.ctx.child()
            self.tracer.record(
                trace.request_id, "resilience", "gateway", 0,
                trace_id=child.trace_id, span_id=child.span_id,
                parent_id=trace.ctx.span_id, start_ts=time.time(),
                attrs={"decision": decision})

    def _route_inner(self, payload: dict, op: str, request_id: str,
                     trace: _RouteTrace, skip: tuple,
                     out_info: Optional[dict]):
        deadline = Deadline.from_request(
            payload, default_ms=self.config.default_deadline_ms)
        if deadline is not None and deadline.expired():
            self._count(trace, "deadline_rejected")
            raise self._shed(DeadlineExceeded(
                "deadline exceeded at gateway admission"))
        if self._overload_on():
            self._overload_admit(payload, trace)
        # A request's model picks its sub-ring, for routing and failover;
        # without one a multi-model gateway uses its default model. A
        # model no typed lane serves probes the whole ring while untyped
        # (HTTP) lanes exist: each lane's model check decides, a mismatch
        # failing over without a penalty.
        mdl = payload.get("model")
        probing = False
        with self._lock:
            if mdl is None and len(self._model_rings) > 1:
                mdl = self.default_model
            if mdl is not None:
                ring = self._model_rings.get(str(mdl))
                if ring is None and self._untyped:
                    ring, probing = self._ring, True
            else:
                ring = self._ring
            known = sorted(self._model_rings) if ring is None else ()
        if ring is None:
            raise ValueError(f"unknown model '{mdl}'; serving {known}")
        try:
            primary = ring.get_node(request_id)
        except RuntimeError:  # every lane was removed
            raise GatewayError(f"no workers available for model '{mdl}'")
        if payload.get("handoff") and op == "generate_stream":
            # A stamped first segment: the prefill ring picks its primary,
            # ring order over everyone is the colocated fallback.
            primary = self._handoff_primary(ring, primary, payload, skip,
                                            trace)
        elif (self.config.prefix_affinity
                and op in ("generate", "generate_stream")):
            primary = self._affinity_primary(ring, primary, payload, skip,
                                             trace)
        # The prefix tier after any primary choice: it never changes the
        # lane, only what the serving lane may skip prefilling.
        if (self._prefix_dir_on and op in ("generate", "generate_stream")
                and "prefix_hint" not in payload):
            self._attach_prefix_hint(payload, primary, trace)
        if skip and primary in skip:
            with self._lock:
                self._failovers += 1
            return self._failover(ring, primary, payload, op, probing,
                                  deadline, trace, skip=skip,
                                  out_info=out_info)
        if self.config.hedge_enabled and op in _HEDGEABLE_OPS:
            return self._route_hedged(ring, primary, payload, op, probing,
                                      deadline, trace)
        result = self._try_node(primary,
                                self._with_deadline(payload, deadline),
                                op=op, probing=probing, out_info=out_info,
                                ring=ring, trace=trace)
        if not _ok(result):
            with self._lock:
                self._failovers += 1
            result = self._failover(ring, primary, payload, op, probing,
                                    deadline, trace, skip=skip,
                                    shed_seen=result is _SHED,
                                    out_info=out_info)
        return result

    @staticmethod
    def _with_deadline(payload: dict, deadline: Optional[Deadline]) -> dict:
        """The payload with the budget left now (none: unchanged)."""
        if deadline is None:
            return payload
        return {**payload, "deadline_ms": max(0.0, deadline.remaining_ms())}

    def _shed(self, exc):
        """Stamp a gateway shed with its Retry-After:
        ``shed_retry_after_s``, or with overload control that base scaled
        by the measured pressure."""
        base = self.config.shed_retry_after_s
        if self.config.overload_control:
            exc.retry_after_s = load_retry_after(base,
                                                 self._overload_pressure())
        else:
            exc.retry_after_s = base
        return exc

    def _failover(self, ring: ConsistentHash, primary: str, payload: dict,
                  op: str, probing: bool, deadline: Optional[Deadline],
                  trace: Optional[_RouteTrace] = None, skip: tuple = (),
                  shed_seen: bool = False,
                  out_info: Optional[dict] = None):
        """Every other lane (not in ``skip``) in ring order, within the
        deadline and the retry budget, each attempt after its
        ``backoff_delay`` (clamped to the deadline; counted as
        ``backoff_waits``)."""
        cfg = self.config
        attempt = 0
        for node in ring.get_all_nodes():
            if node == primary or node in skip:
                continue
            if deadline is not None and deadline.expired():
                self._count(trace, "deadline_expired")
                raise self._shed(DeadlineExceeded(
                    "deadline exceeded during failover"))
            if not self._retry_budget.try_acquire():
                self._count(trace, "retry_budget_exhausted")
                if shed_seen:
                    raise self._shed(Overloaded(
                        "retry budget exhausted after a lane shed the "
                        "request (overloaded, not failed)"))
                raise GatewayError(
                    "retry budget exhausted (retries capped at "
                    f"{cfg.retry_budget_ratio:.0%} of recent "
                    "requests)")
            delay = backoff_delay(attempt, cfg.retry_backoff_base_ms,
                                  cfg.retry_backoff_max_ms, cfg.retry_jitter)
            if delay > 0:
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline.remaining_s()))
                self._count(trace, "backoff_waits")
                time.sleep(delay)
            self._count(trace, "retries")
            result = self._try_node(node,
                                    self._with_deadline(payload, deadline),
                                    op=op, probing=probing,
                                    out_info=out_info, ring=ring,
                                    trace=trace, kind="retry")
            if _ok(result):
                return result
            shed_seen = shed_seen or result is _SHED
            attempt += 1
        if shed_seen:
            raise self._shed(Overloaded(
                "all lanes shed the request (overloaded or draining)"))
        raise GatewayError("All workers failed or unavailable")

    # -- overload control -----------------------------------------------------

    def _inflight_watched(self, it):
        """Relay a stream unchanged; the in-flight gauge drops once when it
        ends (exhausted, failed or closed by the client)."""
        def watched():
            try:
                yield from it
            finally:
                with self._lock:
                    self._inflight -= 1
        return watched()

    def _overload_pressure(self) -> float:
        """The gauge's fill with ``overload_max_inflight``, else the recent
        shed rate: 0 when idle, growing with refusals."""
        if self.config.overload_max_inflight > 0:
            with self._lock:
                inflight = self._inflight
            return inflight / self.config.overload_max_inflight
        return self._shed_stats.pressure()

    def _overload_count(self, trace: Optional[_RouteTrace], decision: str,
                        **attrs) -> None:
        """Bump an overload counter and record a zero-duration
        ``overload`` marker under the request's route span."""
        self.overload.bump(decision)
        if trace is not None:
            child = trace.ctx.child()
            self.tracer.record(
                trace.request_id, "overload", "gateway", 0,
                trace_id=child.trace_id, span_id=child.span_id,
                parent_id=trace.ctx.span_id, start_ts=time.time(),
                attrs={"decision": decision, **attrs})

    def _overload_admit(self, payload: dict,
                        trace: Optional[_RouteTrace] = None) -> None:
        """The tenant bucket first (fairness is not a question of
        congestion), then tier admission against the gauge: below-top
        tiers shed past their fraction, every tier at the full limit.
        Each refusal records an ``overload`` marker."""
        cfg = self.config
        if self._tenant_bucket is not None:
            tenant = str(payload.get("tenant", "default"))
            ok, wait = self._tenant_bucket.allow(tenant)
            if not ok:
                self._overload_count(trace, "rate_limited", tenant=tenant)
                exc = self._shed(Overloaded(
                    f"tenant '{tenant}' over its rate limit "
                    f"({cfg.tenant_rate:g} req/s)"))
                # Never sooner than a token can exist.
                exc.retry_after_s = max(exc.retry_after_s, wait)
                exc.cause = "rate_limit"
                raise exc
        if not cfg.overload_control:
            return
        # Validated whenever the switch is on, gauge or no gauge.
        tier = parse_priority(payload)
        limit = cfg.overload_max_inflight
        if limit <= 0:
            return
        with self._lock:
            inflight = self._inflight  # this request included
        if inflight > limit:
            self._overload_count(trace, "shed_depth", tier=TIER_NAMES[tier])
            exc = self._shed(Overloaded(
                f"gateway at max in-flight {limit}"))
            exc.cause = "depth"
            raise exc
        if (tier < len(TIER_ADMIT_FRAC) - 1
                and inflight > tier_limit(limit, tier)):
            self._overload_count(trace, "shed_tier", tier=TIER_NAMES[tier])
            exc = self._shed(Overloaded(
                f"gateway shedding priority tier '{TIER_NAMES[tier]}' "
                f"at {inflight}/{limit} in flight"))
            exc.cause = "tier"
            raise exc

    # -- hedged dispatch ------------------------------------------------------

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        # Every hedged dispatch rides this pool (one or two threads per
        # request in flight); threads start on demand.
        with self._lock:
            if self._hedge_pool is None:
                self._hedge_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=256, thread_name_prefix="gw-hedge")
            return self._hedge_pool

    def _lane_tracker(self, node: str) -> LatencyTracker:
        with self._lock:
            tracker = self._latency.get(node)
            if tracker is None:
                tracker = self._latency[node] = LatencyTracker()
            return tracker

    def _hedge_threshold_s(self, primary: Optional[str] = None) -> float:
        """How long to wait on ``primary`` before hedging: the lowest
        ``hedge_quantile`` latency of the other lanes with at least
        ``hedge_min_samples`` samples, floored at ``hedge_min_ms`` (None:
        every lane, for /stats)."""
        cfg = self.config
        thr = cfg.hedge_min_ms / 1000.0
        with self._lock:
            trackers = [t for n, t in self._latency.items() if n != primary]
        quantiles = [t.quantile(cfg.hedge_quantile) for t in trackers
                     if len(t) >= cfg.hedge_min_samples]
        quantiles = [q for q in quantiles if q is not None]
        if quantiles:
            thr = max(thr, min(quantiles))
        return thr

    def _route_hedged(self, ring: ConsistentHash, primary: str,
                      payload: dict, op: str, probing: bool,
                      deadline: Optional[Deadline],
                      trace: Optional[_RouteTrace] = None):
        """Wait the threshold on the primary; if it is slow (not failed),
        dispatch the next ring lane whose breaker admits as well and take
        the first answer (the two are sibling ``attempt`` spans, kinds
        primary and hedge). Every primary answer feeds its lane's latency
        window."""
        pool = self._pool()
        p_started = threading.Event()
        t_start: list = [None]

        def _primary_task():
            t_start[0] = time.perf_counter()
            p_started.set()
            return self._try_node(primary,
                                  self._with_deadline(payload, deadline),
                                  op, probing, ring=ring, trace=trace)

        p_fut = pool.submit(_primary_task)

        def _record_primary(fut):
            try:
                r = fut.result()
            except BaseException:
                return
            if _ok(r) and t_start[0] is not None:
                self._lane_tracker(primary).record(
                    time.perf_counter() - t_start[0])

        p_fut.add_done_callback(_record_primary)
        # The hedge timer starts once the primary really runs: hedging a
        # dispatch still queued in a saturated pool would only add load.
        if not p_started.wait(timeout=None if deadline is None
                              else max(0.0, deadline.remaining_s())):
            p_fut.cancel()
            self._count(trace, "deadline_expired")
            raise self._shed(DeadlineExceeded(
                "deadline exceeded before primary dispatch started"))
        thr = self._hedge_threshold_s(primary)
        deadline_clamped = (deadline is not None
                            and deadline.remaining_s() < thr)
        if deadline_clamped:
            thr = max(0.0, deadline.remaining_s())
        try:
            result = p_fut.result(timeout=thr)
        except concurrent.futures.TimeoutError:
            if deadline_clamped:
                # The client's budget ran out, not the lane's threshold:
                # a hedge now would be shed on arrival.
                return self._await_primary(p_fut, ring, primary, payload,
                                           op, probing, deadline, trace)
        else:
            if _ok(result):
                return result
            # The primary failed fast: plain failover.
            with self._lock:
                self._failovers += 1
            return self._failover(ring, primary, payload, op, probing,
                                  deadline, trace,
                                  shed_seen=result is _SHED)

        hedge_node = next(
            (n for n in ring.get_all_nodes()
             if n != primary and self._breaker_allows(n)), None)
        if hedge_node is None or not self._retry_budget.try_acquire():
            if hedge_node is not None:
                self._count(trace, "retry_budget_exhausted")
            return self._await_primary(p_fut, ring, primary, payload, op,
                                       probing, deadline, trace)
        self._count(trace, "hedges")
        h_fut = pool.submit(self._try_node, hedge_node,
                            self._with_deadline(payload, deadline),
                            op, probing, ring=ring, trace=trace,
                            kind="hedge")
        pending = {p_fut: primary, h_fut: hedge_node}
        first_error: Optional[BaseException] = None
        shed_seen = False
        while pending:
            timeout = (None if deadline is None
                       else max(0.0, deadline.remaining_s()))
            done, _ = concurrent.futures.wait(
                list(pending), timeout=timeout,
                return_when=concurrent.futures.FIRST_COMPLETED)
            if not done:
                self._count(trace, "deadline_expired")
                raise self._shed(DeadlineExceeded(
                    "deadline exceeded awaiting hedged dispatch"))
            for fut in done:
                pending.pop(fut)
                try:
                    result = fut.result()
                except BaseException as exc:
                    first_error = first_error or exc
                    continue
                if _ok(result):
                    self._count(trace, "hedge_wins" if fut is h_fut
                                else "hedge_losses")
                    return result
                shed_seen = shed_seen or result is _SHED
        # Both failed or shed: failover over the rest.
        with self._lock:
            self._failovers += 1
        try:
            return self._failover(ring, primary, payload, op, probing,
                                  deadline, trace, skip=(hedge_node,),
                                  shed_seen=shed_seen)
        except GatewayError:
            if first_error is not None:
                raise first_error
            raise

    def _await_primary(self, p_fut, ring: ConsistentHash, primary: str,
                       payload: dict, op: str, probing: bool,
                       deadline: Optional[Deadline],
                       trace: Optional[_RouteTrace] = None):
        """No hedge: wait on the primary alone (within the deadline), then
        fail over if it failed."""
        timeout = (None if deadline is None
                   else max(0.0, deadline.remaining_s()))
        try:
            result = p_fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            self._count(trace, "deadline_expired")
            raise self._shed(DeadlineExceeded(
                "deadline exceeded awaiting primary lane"))
        if _ok(result):
            return result
        with self._lock:
            self._failovers += 1
        return self._failover(ring, primary, payload, op, probing, deadline,
                              trace, shed_seen=result is _SHED)

    def _breaker_allows(self, node: str) -> bool:
        with self._lock:
            breaker = self._breakers.get(node)
        return breaker is not None and breaker.allow_request()

    # -- one dispatch ---------------------------------------------------------

    def _try_node(self, node: str, payload: dict, op: str = "infer",
                  probing: bool = False, out_info: Optional[dict] = None,
                  ring: Optional[ConsistentHash] = None,
                  trace: Optional[_RouteTrace] = None,
                  kind: str = "primary"):
        """One breaker-gated dispatch: the response, None (failed: fail
        over) or ``_SHED``. A lane the prober ejected is skipped with no
        penalty, unless every lane of ``ring`` is ejected (fail open: the
        breakers decide a total outage). A dispatch records an
        ``attempt`` span (``kind`` primary, retry or hedge) under the
        route span; a traced request forwards the attempt's context."""
        with self._lock:
            client = self._clients.get(node)
            breaker = self._breakers.get(node)
            ejected = node in self._ejected
        if client is None or breaker is None:
            return None
        if ejected:
            peers = ring.get_all_nodes() if ring is not None else None
            with self._lock:
                if peers is None:
                    peers = list(self._clients)
                all_ejected = all(p in self._ejected for p in peers)
            if not all_ejected:
                return None
        if not breaker.allow_request():
            return None
        ctx = None
        if trace is not None:
            ctx = trace.ctx.child()
            if trace.traced:
                payload = {**payload, "traceparent": ctx.to_traceparent()}
        t0 = time.perf_counter()
        start = time.time()
        outcome = "error"
        try:
            response = getattr(client, op)(payload)
            outcome = "ok"
            if op in ("generate", "generate_stream"):
                if self.config.prefix_affinity:
                    self._count_lane_dispatch(node)
                if self._prefix_dir_on:
                    # The lane indexed this prompt at admission: it owns
                    # the fingerprint's chain now.
                    self._record_prefix_owner(payload, node)
        except WorkerError:
            breaker.record_failure()
            outcome = "failed"
            return None
        except Overloaded:
            # Healthy but busy: fail over with no breaker penalty.
            self._count(trace, "shed_overloaded")
            outcome = "shed"
            return _SHED
        except DeadlineExceeded as exc:
            # No other lane can help a spent budget; a lane that held the
            # request past it unanswered is still penalised.
            if exc.lane_suspect:
                breaker.record_failure()
            self._count(trace, "deadline_expired")
            outcome = "deadline"
            raise self._shed(DeadlineExceeded(
                f"deadline exceeded at lane {node}"))
        except ValueError:
            if probing:
                outcome = "wrong_model"
                return None  # a lane of another model: no penalty
            raise
        finally:
            if trace is not None:
                self.tracer.record(
                    trace.request_id, "attempt", "gateway",
                    (time.perf_counter() - t0) * 1e6,
                    trace_id=ctx.trace_id, span_id=ctx.span_id,
                    parent_id=trace.ctx.span_id, start_ts=start,
                    attrs={"lane": node, "kind": kind, "outcome": outcome})
        breaker.record_success()
        if out_info is not None:
            out_info["lane"] = node
        return response

    # -- observability --------------------------------------------------------

    def get_stats(self) -> dict:
        with self._lock:
            items = list(self._breakers.items())
            total, failovers = self._total_requests, self._failovers
            inflight = self._inflight
            active_streams = len(self._streams)
            roles = {n: self._roles.get(n, "both")
                     for n in sorted(self._clients)}
            aff_assigned = dict(self._affinity_assigned)
            prefix_dir_state = (self._prefix_dir.stats()
                                if self._prefix_dir is not None else None)
        cfg = self.config
        out = {
            "total_workers": len(items),
            "total_requests": total,
            "failovers": failovers,
            "circuit_breakers": [
                {"node": node, "state": br.state_name(),
                 "failures": br.failure_count,
                 "successes": br.success_count}
                for node, br in items],
        }
        if self._resilience_configured() or self.resilience.any_nonzero():
            res = self.resilience.as_dict()
            if self._retry_budget.enabled:
                res["retry_budget"] = self._retry_budget.stats()
            if cfg.hedge_enabled:
                res["hedge_threshold_ms"] = round(
                    self._hedge_threshold_s() * 1000.0, 3)
            out["resilience"] = res
        if (cfg.failover_streams or cfg.health_probe_interval_s > 0
                or self.failover.any_nonzero()):
            fo = self.failover.as_dict()
            fo["ejected_lanes"] = self.ejected_lanes()
            out["failover"] = fo
        if cfg.migrate_streams or self.migration.any_nonzero():
            mig = self.migration.as_dict()
            mig["active_streams"] = active_streams
            out["migration"] = mig
        if cfg.disagg or self.handoff.any_nonzero():
            ho = self.handoff.as_dict()
            ho["roles"] = roles
            out["handoff"] = ho
        if cfg.prefix_affinity or self.affinity.any_nonzero():
            aff = self.affinity.as_dict()
            aff["assigned"] = aff_assigned
            out["affinity"] = aff
        if prefix_dir_state is not None or self.prefix_dir.any_nonzero():
            pd = self.prefix_dir.as_dict()
            if prefix_dir_state is not None:
                pd.update(prefix_dir_state)
            out["prefix_directory"] = pd
        if (cfg.overload_control or self._tenant_bucket is not None
                or self.overload.any_nonzero()):
            ov = self.overload.as_dict()
            ov["pressure"] = round(self._overload_pressure(), 4)
            ov["inflight"] = inflight
            if cfg.overload_max_inflight > 0:
                ov["max_inflight"] = cfg.overload_max_inflight
            if self._tenant_bucket is not None:
                ov["tenants"] = self._tenant_bucket.tenants()
            out["overload"] = ov
        if self._slo is not None:
            slo = self.slo_status()
            if slo is not None:
                out["slo"] = slo
        if self._ledger is not None:
            out["trace_ledger"] = self._ledger.summary()
        return out

    def _resilience_configured(self) -> bool:
        cfg = self.config
        return (cfg.default_deadline_ms is not None or cfg.hedge_enabled
                or cfg.retry_budget_ratio is not None
                or cfg.retry_backoff_base_ms > 0)

    def slo_status(self, named_hists: Optional[dict] = None
                   ) -> Optional[dict]:
        """The /admin/slo payload, or None without an objective. TTFT and
        ITL read ``named_hists`` (``{family: {node: histogram}}``); the
        port's lanes are HTTP workers, whose histograms live behind their
        /metrics text, so without it those objectives see no samples.
        Completion reads the gateway's own stream spans (failover time
        included)."""
        if self._slo is None:
            return None
        named_hists = named_hists or {}
        by_objective = {}
        for name, family in OBJECTIVE_SOURCES.items():
            if family is None:
                by_objective[name] = completion_hists([self.tracer])
            else:
                by_objective[name] = list(
                    (named_hists.get(family) or {}).values())
        return self._slo.status(by_objective)

    def slo_pressure(self, named_hists: Optional[dict] = None) -> float:
        """The worst objective's burn in [0, 1] (0.0 without a
        tracker)."""
        if self._slo is None:
            return 0.0
        return SloTracker.pressure(self.slo_status(named_hists) or {})

    def stitched_trace(self, request_id: str) -> dict:
        """The /admin/trace/<request_id> body: the request's spans from
        the gateway and every lane (each lane's /trace/export; a lane the
        ledger names that left the ring is asked directly) merged into
        one tree, with the ledger's trace id and hops when it has the
        stream. A lane that does not answer contributes nothing."""
        entry = (self._ledger.get(request_id)
                 if self._ledger is not None else None)
        fragments = {"gateway": self.tracer.snapshot()}
        lanes = self.lane_clients()
        for hop in (entry or {}).get("hops", ()):
            lane = hop.get("lane") or ""
            if lane and lane not in lanes and ":" in lane:
                lanes[lane] = HttpWorkerClient(lane, timeout_s=3.0)
        for lane, client in lanes.items():
            try:
                spans = client.trace_spans()
            except Exception:
                continue
            if spans:
                fragments.setdefault(lane, spans)
        out = stitch_trace(fragments, request_id,
                           trace_id=(entry or {}).get("trace_id"))
        if entry is not None:
            out["hops"] = entry["hops"]
        return out
