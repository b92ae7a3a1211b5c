"""The gateway (the port's copy of the ``Gateway`` core of
``tpu_engine/serving/gateway.py``): consistent-hash routing over HTTP
workers, each lane guarded by a circuit breaker, with ring-order failover.

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
none. Failover is immediate, and its retries may be capped by a global
retry budget (off by default). A
request naming a ``model`` probes the ring: a lane's 400 for it moves on
without a penalty.

Streams are relayed frame by frame; a mid-stream lane fault (the
transport dying, or a retryable in-band error event that is not a
``shed``) counts against the lane's breaker.

``get_stats`` is the reference's ``/stats`` schema (``total_workers``,
``total_requests``, ``failovers``, ``circuit_breakers``), plus the
``resilience`` block once the resilience layer is configured or has
decided something, and the ``migration`` block once a bounded drain has
failed.

Lanes are HTTP workers only. In-process lanes, stream resume, migration,
hedging, the health prober, disaggregated roles, prefix affinity and the
prefix directory, overload control, the autoscaler, SLO objectives and
trace stitching are not ported: each refuses by name
(``utils.config.refuse_unported``).
"""

from __future__ import annotations

import json
import threading
import uuid
from typing import Dict, List, Optional

from tpu_engine_torch.core.circuit_breaker import CircuitBreaker
from tpu_engine_torch.core.consistent_hash import ConsistentHash
from tpu_engine_torch.serving.clients import HttpWorkerClient, WorkerError
from tpu_engine_torch.serving.resilience import (
    MigrationCounters,
    ResilienceCounters,
    RetryBudget,
)
from tpu_engine_torch.utils.config import GatewayConfig
from tpu_engine_torch.utils.deadline import (
    Deadline,
    DeadlineExceeded,
    Overloaded,
    ShedError,
)


class GatewayError(Exception):
    pass


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


class Gateway:
    def __init__(self, workers=None, config: Optional[GatewayConfig] = None):
        """``workers``: worker URLs (``host``, ``host:port`` or
        ``http://host:port``)."""
        self.config = config or GatewayConfig()
        self._ring = ConsistentHash(self.config.virtual_nodes)
        self._clients: Dict[str, HttpWorkerClient] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()
        self._total_requests = 0
        self._failovers = 0
        self.resilience = ResilienceCounters()
        self.migration = MigrationCounters()
        self._retry_budget = RetryBudget(self.config.retry_budget_ratio,
                                         self.config.retry_budget_min,
                                         self.config.retry_budget_window_s)
        for w in workers or []:
            self.add_worker(w)

    # -- membership -----------------------------------------------------------

    def add_worker(self, worker) -> str:
        """Register an HTTP worker; its lane name is ``client.url``
        (``"host:port"``)."""
        if not isinstance(worker, str):
            raise NotImplementedError(
                "in-process lanes (LocalWorkerClient) are not yet ported to "
                "tpu_engine_torch's gateway (queued with the combined serve "
                "command, ROADMAP.md §A 16.7); pass worker URLs")
        cfg = self.config
        client = HttpWorkerClient(worker, timeout_s=cfg.worker_timeout_s,
                                  default_port=cfg.default_worker_port,
                                  gen_timeout_s=cfg.gen_timeout_s)
        name = client.url
        with self._lock:
            self._clients[name] = client
            self._breakers[name] = CircuitBreaker(cfg.failure_threshold,
                                                  cfg.success_threshold,
                                                  cfg.breaker_timeout_s)
        self._ring.add_node(name)
        return name

    def remove_worker(self, name: str, drain: bool = False) -> None:
        """Take a lane off the ring. ``drain=True`` first asks it to drain
        (new admissions shed 503 while in-flight work completes), waiting
        at most ``drain_timeout_s`` for its answer: a lane that does not
        answer is counted (``drain_failures``) and removed anyway."""
        if drain:
            with self._lock:
                client = self._clients.get(name)
            if client is not None and not self._bounded_drain(client):
                self.migration.bump("drain_failures")
        self._ring.remove_node(name)
        with self._lock:
            self._clients.pop(name, None)
            self._breakers.pop(name, None)

    def _bounded_drain(self, client: HttpWorkerClient) -> bool:
        """Whether ``client.drain()`` answered within ``drain_timeout_s``
        (the call is abandoned to its daemon thread otherwise)."""
        ok: List[bool] = []

        def run():
            try:
                client.drain()
                ok.append(True)
            except Exception:
                pass

        t = threading.Thread(target=run, name=f"gw-drain-{client.url}",
                             daemon=True)
        t.start()
        t.join(timeout=self.config.drain_timeout_s)
        return bool(ok)

    def worker_names(self) -> List[str]:
        return self._ring.get_all_nodes()

    def breaker_for(self, name: str) -> Optional[CircuitBreaker]:
        with self._lock:
            return self._breakers.get(name)

    # -- routes ---------------------------------------------------------------

    def route_request(self, payload: dict) -> dict:
        return self._route(payload, op="infer")

    def route_request_raw(self, payload: dict) -> bytes:
        """/infer with the lane's response bytes relayed unparsed."""
        return self._route(payload, op="infer_raw")

    def route_score(self, payload: dict) -> dict:
        return self._route(payload, op="score")

    def route_generate(self, payload: dict) -> dict:
        return self._route(payload, op="generate")

    def route_generate_stream(self, payload: dict):
        """The serving lane's SSE frames, relayed as they arrive, its
        breaker fed by a mid-stream fault."""
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

    # -- routing --------------------------------------------------------------

    def _route(self, payload: dict, op: str,
               out_info: Optional[dict] = None):
        """``out_info`` gets ``{"lane": name}`` of the lane that
        answered."""
        with self._lock:
            self._total_requests += 1
        self._retry_budget.record_request()
        rid = payload.get("request_id")
        if rid is None:
            rid = uuid.uuid4().hex
            payload = {**payload, "request_id": rid}
        return self._route_inner(payload, op, str(rid), out_info)

    def _route_inner(self, payload: dict, op: str, request_id: str,
                     out_info: Optional[dict]):
        deadline = Deadline.from_request(payload)
        if deadline is not None and deadline.expired():
            self.resilience.bump("deadline_rejected")
            raise DeadlineExceeded("deadline exceeded at gateway admission")
        # HTTP lanes carry no model metadata: a request naming a model
        # probes the ring and each lane's model check decides, a mismatch
        # failing over without a penalty.
        mdl = payload.get("model")
        probing = mdl is not None
        with self._lock:
            if probing and not self._clients:
                raise ValueError(f"unknown model '{mdl}'; serving []")
        ring = self._ring
        try:
            primary = ring.get_node(request_id)
        except RuntimeError:  # every lane was removed
            raise GatewayError(f"no workers available for model '{mdl}'")
        result = self._try_node(primary,
                                self._with_deadline(payload, deadline),
                                op=op, probing=probing, out_info=out_info)
        if not _ok(result):
            with self._lock:
                self._failovers += 1
            result = self._failover(ring, primary, payload, op, probing,
                                    deadline, shed_seen=result is _SHED,
                                    out_info=out_info)
        return result

    @staticmethod
    def _with_deadline(payload: dict, deadline: Optional[Deadline]) -> dict:
        """The payload with the budget left now (none: unchanged)."""
        if deadline is None:
            return payload
        return {**payload, "deadline_ms": max(0.0, deadline.remaining_ms())}

    def _failover(self, ring: ConsistentHash, primary: str, payload: dict,
                  op: str, probing: bool, deadline: Optional[Deadline],
                  shed_seen: bool = False,
                  out_info: Optional[dict] = None):
        """Every other lane in ring order, within the deadline and the
        retry budget."""
        for node in ring.get_all_nodes():
            if node == primary:
                continue
            if deadline is not None and deadline.expired():
                self.resilience.bump("deadline_expired")
                raise DeadlineExceeded("deadline exceeded during failover")
            if not self._retry_budget.try_acquire():
                self.resilience.bump("retry_budget_exhausted")
                if shed_seen:
                    raise Overloaded(
                        "retry budget exhausted after a lane shed the "
                        "request (overloaded, not failed)")
                raise GatewayError(
                    "retry budget exhausted (retries capped at "
                    f"{self.config.retry_budget_ratio:.0%} of recent "
                    "requests)")
            self.resilience.bump("retries")
            result = self._try_node(node,
                                    self._with_deadline(payload, deadline),
                                    op=op, probing=probing,
                                    out_info=out_info)
            if _ok(result):
                return result
            shed_seen = shed_seen or result is _SHED
        if shed_seen:
            raise Overloaded(
                "all lanes shed the request (overloaded or draining)")
        raise GatewayError("All workers failed or unavailable")

    def _try_node(self, node: str, payload: dict, op: str = "infer",
                  probing: bool = False,
                  out_info: Optional[dict] = None):
        """One breaker-gated dispatch: the response, None (failed: fail
        over) or ``_SHED``."""
        with self._lock:
            client = self._clients.get(node)
            breaker = self._breakers.get(node)
        if client is None or breaker is None or not breaker.allow_request():
            return None
        try:
            response = getattr(client, op)(payload)
        except WorkerError:
            breaker.record_failure()
            return None
        except Overloaded:
            # Healthy but busy: fail over with no breaker penalty.
            self.resilience.bump("shed_overloaded")
            return _SHED
        except DeadlineExceeded as exc:
            # No other lane can help a spent budget; a lane that held the
            # request past it unanswered is still penalised.
            if exc.lane_suspect:
                breaker.record_failure()
            self.resilience.bump("deadline_expired")
            raise DeadlineExceeded(f"deadline exceeded at lane {node}")
        except ValueError:
            if probing:
                return None  # a lane of another model: no penalty
            raise
        breaker.record_success()
        if out_info is not None:
            out_info["lane"] = node
        return response

    # -- observability --------------------------------------------------------

    def get_stats(self) -> dict:
        with self._lock:
            items = list(self._breakers.items())
            total, failovers = self._total_requests, self._failovers
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
        if self._retry_budget.enabled or self.resilience.any_nonzero():
            res = self.resilience.as_dict()
            if self._retry_budget.enabled:
                res["retry_budget"] = self._retry_budget.stats()
            out["resilience"] = res
        if self.migration.any_nonzero():
            mig = self.migration.as_dict()
            mig["active_streams"] = 0
            out["migration"] = mig
        return out
