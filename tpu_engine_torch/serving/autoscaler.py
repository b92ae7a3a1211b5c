"""The elastic fleet (the port's copy of ``tpu_engine/serving/autoscaler.py``):
a closed loop over the gateway that grows and shrinks the set of lanes
with their load, through the gateway's own primitives.

- **Signal**: each lane's ``/health`` folded into one pressure
  (``lane_pressure``: the AIMD limit's fill, else the admission queue's,
  else decode-slot occupancy; an engaged brownout reads saturated), and
  the mean over the lanes that answered.
- **Scale up**: probe, then register. A lane from the provider (or one
  named by ``/admin/fleet add``) joins the rings only after its
  ``/health`` answers healthy within ``autoscale_spawn_timeout_s``; one
  that never does goes back to the provider and latches the named
  ``spawn-wedged`` state while the fleet serves on.
- **Scale down**: ``Gateway.remove_worker(drain=True)``, the bounded
  drain and (with ``migrate_streams``) the live migration of the lane's
  streams, with the replay resume as the last rung. The removal runs on
  an actuator pool under a bound; past it the lane latches
  ``drain-wedged`` and the loop goes on.
- **Rebalance** (``autoscale_rebalance_band`` > 1, with ``disagg``): one
  lane's role flips through ``Gateway.set_worker_role`` when the
  prefill:decode pressure ratio leaves the band, re-armed only once it
  is back inside band/2.

Every decision bumps a ``FleetCounters`` field and drops a ``fleet``
marker span (``Gateway._fleet_count``), so the counters equal the spans.
Decisions are idempotent (adding a member answers ``already-member``,
removing a stranger ``unknown-lane``). ``autoscale`` off: no controller
thread and no ``/stats`` ``fleet`` block; ``/admin/fleet`` runs the same
actuators on an unstarted controller.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Dict, List, Optional

from tpu_engine_torch.serving.clients import HttpWorkerClient

# The named degraded-but-serving states.
DEGRADED_SPAWN_WEDGED = "spawn-wedged"
DEGRADED_DRAIN_WEDGED = "drain-wedged"


def lane_pressure(health: dict) -> Optional[float]:
    """One lane's ``/health`` body as a pressure >= 0 (1.0: saturated):
    admitted depth over the AIMD limit (else over ``max_queue_depth``),
    else active decode rows over slots; an engaged brownout stage raises
    it to at least 1.0. None when the body carries no load signal (the
    lane drops out of the mean rather than reading idle)."""
    if not isinstance(health, dict):
        return None
    p: Optional[float] = None
    adm = health.get("admission")
    if isinstance(adm, dict):
        depth = float(adm.get("queue_depth", 0) or 0)
        adaptive = adm.get("adaptive")
        limit = 0.0
        if isinstance(adaptive, dict):
            limit = float(adaptive.get("limit", 0) or 0)
        if limit <= 0:
            limit = float(adm.get("max_queue_depth", 0) or 0)
        if limit > 0:
            p = depth / limit
    if p is None:
        gen = health.get("generator")
        if isinstance(gen, dict):
            slots = float(gen.get("n_slots", 0) or 0)
            if slots > 0:
                p = float(gen.get("active", 0) or 0) / slots
    bo = health.get("brownout")
    if isinstance(bo, dict) and int(bo.get("stage", 0) or 0) > 0:
        p = max(p or 0.0, 1.0)
    return None if p is None else max(0.0, p)


class StandbyLaneProvider:
    """A pool of pre-launched worker addresses: ``spawn`` leases the
    first (None when the pool is dry), ``retire`` and ``destroy`` hand it
    back, so a lane that never probed healthy is screened again next
    time. Thread-safe."""

    def __init__(self, addresses: Optional[List[str]] = None):
        self._lock = threading.Lock()
        self._standby: List[str] = list(addresses or [])
        self._leased: set = set()

    def add(self, address: str) -> None:
        with self._lock:
            if address not in self._standby and address not in self._leased:
                self._standby.append(address)

    def spawn(self) -> Optional[str]:
        with self._lock:
            if not self._standby:
                return None
            addr = self._standby.pop(0)
            self._leased.add(addr)
            return addr

    def destroy(self, handle) -> None:
        self.retire(handle)

    def retire(self, handle) -> None:
        with self._lock:
            addr = str(handle)
            self._leased.discard(addr)
            if addr not in self._standby:
                self._standby.append(addr)

    def capacity(self) -> int:
        with self._lock:
            return len(self._standby)


class InProcessLaneProvider:
    """Lanes made in this process by ``factory(index)`` (a ``WorkerNode``,
    or anything with a ``node_id`` and ``get_health``), at most
    ``max_lanes`` live (0: unbounded). ``retire`` takes the lane or its
    name (the controller retires by name), stops it and reports it to
    ``on_retire``; so does it for a lane made elsewhere and ``adopt``-ed
    (the combined server's static lanes), which counts against no
    capacity. A factory that raises spawns nothing."""

    def __init__(self, factory, max_lanes: int = 0, on_retire=None):
        self._factory = factory
        self._max = int(max_lanes)
        self._on_retire = on_retire
        self._lock = threading.Lock()
        self._by_name: Dict[str, object] = {}
        self._adopted: Dict[str, object] = {}
        self._next_idx = 0

    def adopt(self, worker) -> None:
        with self._lock:
            self._adopted[str(getattr(worker, "node_id", worker))] = worker

    def spawn(self):
        with self._lock:
            if self._max and len(self._by_name) >= self._max:
                return None
            idx = self._next_idx
            self._next_idx += 1
        try:
            worker = self._factory(idx)
        except Exception:
            return None
        if worker is not None:
            with self._lock:
                self._by_name[str(getattr(worker, "node_id", worker))] = \
                    worker
        return worker

    def destroy(self, handle) -> None:
        self.retire(handle)

    def retire(self, handle) -> None:
        name = str(getattr(handle, "node_id", handle))
        with self._lock:
            worker = self._by_name.pop(name, None)
            adopted = self._adopted.pop(name, None)
        worker = worker if worker is not None else adopted
        if worker is None:
            worker = handle if not isinstance(handle, str) else None
        if worker is None:
            return
        stop = getattr(worker, "stop", None)
        if callable(stop):
            try:
                stop()
            except Exception:
                pass
        if self._on_retire is not None:
            try:
                self._on_retire(worker)
            except Exception:
                pass

    def capacity(self) -> Optional[int]:
        with self._lock:
            if not self._max:
                return None  # unbounded
            return max(0, self._max - len(self._by_name))


class FleetAutoscaler:
    """The gateway's elastic-fleet controller. ``start()`` runs the loop:
    each ``autoscale_interval_s`` a tick observes the lanes, publishes
    the mean pressure, clears a ``spawn-wedged`` lane that has since
    joined, and takes at most one decision (a role flip, a spawn or a
    retirement) within the lane clamps and the cooldown, holding it when
    no lane could be observed (and a retirement when any lane could
    not). ``scale_up``, ``scale_down`` and ``rebalance`` are the
    actuators, shared with ``/admin/fleet``; they touch none of the
    loop's state, so an unstarted controller serves them alike."""

    def __init__(self, gateway, provider=None, config=None):
        self.gateway = gateway
        self.provider = provider
        self.config = config if config is not None else gateway.config
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The bounded actuator pool: a wedged removal holds one worker
        # past its bound instead of the caller. Made on demand, since
        # /admin/fleet outlives stop().
        self._exec: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._exec_lock = threading.Lock()
        # The loop's own state (touched only by _tick).
        self._last_action_ts = 0.0
        self._rebalance_armed = True

    # -- lifecycle ------------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_event.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._thread = None
        # /admin/fleet goes on working: re-arm the probe gate's wait and
        # retire the actuator pool (the next action makes another).
        self._stop_event.clear()
        with self._exec_lock:
            ex, self._exec = self._exec, None
        if ex is not None:
            ex.shutdown(wait=False)

    def _actuators(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._exec_lock:
            if self._exec is None:
                self._exec = concurrent.futures.ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="fleet-actuator")
            return self._exec

    def _run(self) -> None:
        interval = max(0.05, float(self.config.autoscale_interval_s))
        while not self._stop_event.wait(interval):
            try:
                self._tick()
            except Exception:
                pass  # one tick's failure never ends the loop

    # -- observation ----------------------------------------------------------

    def observe(self) -> Dict[str, Optional[float]]:
        """Each lane's pressure (None: unreachable or no load signal),
        read on the probe connection of an HTTP lane, so a pool held by
        long streams never reads as pressure 0."""
        out: Dict[str, Optional[float]] = {}
        for lane, client in self.gateway.lane_clients().items():
            try:
                probe = getattr(client, "probe_health", None)
                health = probe(timeout_s=2.0) if callable(probe) \
                    else client.health()
                out[lane] = lane_pressure(health)
            except Exception:
                out[lane] = None
        return out

    def fleet_pressure(self, samples: Dict[str, Optional[float]]) -> float:
        vals = [v for v in samples.values() if v is not None]
        return sum(vals) / len(vals) if vals else 0.0

    # -- the closed loop ------------------------------------------------------

    def _tick(self) -> None:
        gw = self.gateway
        samples = self.observe()
        lanes = sorted(samples)
        mean = self.fleet_pressure(samples)
        if getattr(self.config, "autoscale_slo_feed", False):
            # The SLO feed only adds pressure: a burning budget may scale
            # up an idle-looking fleet, never hide a saturated one.
            try:
                mean = max(mean, gw.slo_pressure())
            except Exception:
                pass
        gw.fleet_observe(mean)
        blind = sum(1 for v in samples.values() if v is None)

        # No sample: no basis for any decision. A partly blind fleet may
        # grow but never shrink: the lane that cannot be read may be the
        # loaded one.
        if blind == len(samples):
            gw._fleet_count("decisions_held", reason="blind",
                            pressure=round(mean, 4))
            return

        # A spawn-wedged lane that has since joined clears its state;
        # drain-wedged stays latched until an operator clears it.
        for lane, reason in list(gw.fleet_status()["degraded"].items()):
            if reason == DEGRADED_SPAWN_WEDGED and lane in samples:
                gw.fleet_clear_degraded(lane)

        if self._maybe_rebalance(samples):
            return

        n = len(lanes)
        up = mean > float(self.config.autoscale_up_pressure)
        down = mean < float(self.config.autoscale_down_pressure)
        if not up and not down:
            return
        max_lanes = int(self.config.autoscale_max_lanes)
        min_lanes = max(1, int(self.config.autoscale_min_lanes))
        if up and max_lanes and n >= max_lanes:
            gw._fleet_count("decisions_held", reason="max-lanes",
                            pressure=round(mean, 4))
            return
        if up and (self.provider is None
                   or self.provider.capacity() == 0):
            gw._fleet_count("decisions_held", reason="provider-exhausted",
                            pressure=round(mean, 4))
            return
        if down and n <= min_lanes:
            gw._fleet_count("decisions_held", reason="min-lanes",
                            pressure=round(mean, 4))
            return
        if down and blind:
            gw._fleet_count("decisions_held", reason="blind",
                            pressure=round(mean, 4))
            return
        now = time.monotonic()
        if now - self._last_action_ts \
                < float(self.config.autoscale_cooldown_s):
            gw._fleet_count("decisions_held", reason="cooldown",
                            pressure=round(mean, 4))
            return
        if up:
            res = self.scale_up()
        else:
            victim = self._pick_victim(samples)
            if victim is None:
                gw._fleet_count("decisions_held", reason="no-victim",
                                pressure=round(mean, 4))
                return
            res = self.scale_down(name=victim)
        if res.get("status") != "already-member":
            self._last_action_ts = time.monotonic()

    def _maybe_rebalance(self, samples: Dict[str, Optional[float]]) -> bool:
        """Flip one lane between prefill and decode when the pressure
        ratio leaves the band (re-armed inside band/2), never leaving a
        role with no lane. True when a flip was actuated."""
        band = float(self.config.autoscale_rebalance_band)
        if band <= 1.0 or not self.config.disagg:
            return False
        roles = self.gateway.worker_roles()
        pre = [v for l, v in samples.items()
               if v is not None and roles.get(l) == "prefill"]
        dec = [v for l, v in samples.items()
               if v is not None and roles.get(l) in ("decode", "both")]
        if not pre or not dec:
            return False
        eps = 1e-3
        ratio = (sum(pre) / len(pre) + eps) / (sum(dec) / len(dec) + eps)
        if not self._rebalance_armed:
            if 2.0 / band <= ratio <= band / 2.0:
                self._rebalance_armed = True
            return False
        now = time.monotonic()
        if now - self._last_action_ts \
                < float(self.config.autoscale_cooldown_s):
            return False
        target_role = None
        if ratio > band and sum(
                1 for l in samples if roles.get(l) in ("decode", "both")) > 1:
            # The prefill side is starved: the least-pressed decode lane.
            target_role = "prefill"
            pool = [l for l in samples
                    if roles.get(l) in ("decode", "both")]
        elif ratio < 1.0 / band and sum(
                1 for l in samples if roles.get(l) == "prefill") > 1:
            target_role = "decode"
            pool = [l for l in samples if roles.get(l) == "prefill"]
        if target_role is None:
            return False
        victim = min(pool, key=lambda l: (samples.get(l) or 0.0, l))
        self._rebalance_armed = False
        res = self.rebalance(victim, target_role)
        if res.get("ok"):
            self._last_action_ts = time.monotonic()
        return True

    def _pick_victim(self, samples: Dict[str, Optional[float]]) \
            -> Optional[str]:
        """The lane to retire: observed, neither degraded nor ejected, the
        least by (ring weight, journaled streams, pressure, name), so the
        emptiest drains and the fewest streams migrate; under disagg
        never the last lane of a role."""
        gw = self.gateway
        degraded = gw.fleet_status()["degraded"]
        streams: Dict[str, int] = {}
        for _rid, lane in gw.active_streams().items():
            streams[lane] = streams.get(lane, 0) + 1
        roles = gw.worker_roles()
        # Every member's ring weight is 1 (the port's rings carry no
        # topology weights), a lane that left since the sample's 0.
        members = gw.lane_clients()
        role_counts: Dict[str, int] = {}
        for lane in samples:
            role_counts[roles.get(lane, "both")] = \
                role_counts.get(roles.get(lane, "both"), 0) + 1
        candidates = []
        for lane, p in samples.items():
            if p is None or lane in degraded:
                continue
            if gw._probe_state.ejected(lane):
                continue
            role = roles.get(lane, "both")
            if self.config.disagg and role in ("prefill", "decode") \
                    and role_counts.get(role, 0) <= 1:
                continue
            candidates.append(
                (int(lane in members), streams.get(lane, 0), p, lane))
        if not candidates:
            return None
        return min(candidates)[3]

    # -- actuators (the loop's and /admin/fleet's) ----------------------------

    def scale_up(self, worker=None) -> dict:
        """Probe, then register: take a lane (``worker``, an address or an
        in-process lane, or the provider's next), poll its /health until
        healthy, and only then add it to the rings. None healthy within
        ``autoscale_spawn_timeout_s``: the provider takes it back and the
        fleet latches ``spawn-wedged``."""
        gw = self.gateway
        cfg = self.config
        from_provider = worker is None
        if from_provider:
            worker = self.provider.spawn() if self.provider is not None \
                else None
            if worker is None:
                gw._fleet_count("scale_up_attempted", source="provider")
                gw._fleet_count("scale_up_failed",
                                reason="provider-exhausted")
                return {"ok": False, "status": "provider-exhausted"}
        if isinstance(worker, str):
            probe_client = HttpWorkerClient(
                worker, timeout_s=cfg.worker_timeout_s,
                default_port=cfg.default_worker_port, pool_size=2)
            name_hint = probe_client.url
            probe = lambda: probe_client.probe_health(timeout_s=2.0)
        else:
            name_hint = str(getattr(worker, "node_id", worker))
            probe = worker.get_health
        if name_hint in gw.lane_clients():
            return {"ok": True, "status": "already-member",
                    "worker": name_hint}
        gw._fleet_count("scale_up_attempted", worker=name_hint)
        deadline = time.monotonic() + float(cfg.autoscale_spawn_timeout_s)
        healthy = False
        while time.monotonic() < deadline:
            try:
                if bool(probe().get("healthy")):
                    healthy = True
                    break
            except Exception:
                pass
            if self._stop_event.wait(0.2):
                break
        if not healthy:
            gw.fleet_enter_degraded(name_hint, DEGRADED_SPAWN_WEDGED)
            gw._fleet_count("scale_up_failed", worker=name_hint,
                            reason=DEGRADED_SPAWN_WEDGED)
            if from_provider and self.provider is not None:
                try:
                    self.provider.destroy(worker)
                except Exception:
                    pass
            return {"ok": False, "status": DEGRADED_SPAWN_WEDGED,
                    "worker": name_hint}
        name = gw.add_worker(worker)
        gw.fleet_clear_degraded(name)
        gw._fleet_count("scale_up_completed", worker=name)
        return {"ok": True, "status": "registered", "worker": name}

    def scale_down(self, name: Optional[str] = None,
                   manual: bool = False) -> dict:
        """Retire one lane (``name``, else the victim) through the bounded
        drain, the live migration of its streams and its removal from the
        rings. Past ``drain_timeout_s + 2 migrate_timeout_s + 15`` s the
        lane latches ``drain-wedged`` and the call returns with the fleet
        serving; a drain call that failed inside a removal that completed
        latches the same state while the membership still shrinks."""
        gw = self.gateway
        if name is None:
            name = self._pick_victim(
                {l: 0.0 for l in gw.lane_clients()})
            if name is None:
                return {"ok": False, "status": "no-victim"}
        if name not in gw.lane_clients():
            return {"ok": False, "status": "unknown-lane", "worker": name}
        gw._fleet_count("scale_down_attempted", worker=name,
                        manual=manual)
        before = gw.migration.get("drain_failures")
        budget = (float(self.config.drain_timeout_s)
                  + 2.0 * float(self.config.migrate_timeout_s) + 15.0)
        fut = self._actuators().submit(gw.remove_worker, name, True)
        try:
            fut.result(timeout=budget)
        except concurrent.futures.TimeoutError:
            gw.fleet_enter_degraded(name, DEGRADED_DRAIN_WEDGED)
            gw._fleet_count("scale_down_failed", worker=name,
                            reason="actuator-timeout")
            return {"ok": False, "status": DEGRADED_DRAIN_WEDGED,
                    "worker": name}
        except Exception as exc:
            gw._fleet_count("scale_down_failed", worker=name,
                            reason="remove-error")
            return {"ok": False, "status": "remove-failed",
                    "worker": name, "error": str(exc)[:200]}
        wedged = gw.migration.get("drain_failures") > before
        if wedged:
            gw.fleet_enter_degraded(name, DEGRADED_DRAIN_WEDGED)
        if self.provider is not None \
                and hasattr(self.provider, "retire"):
            try:
                self.provider.retire(name)
            except Exception:
                pass
        gw._fleet_count("scale_down_completed", worker=name,
                        wedged=wedged)
        return {"ok": True,
                "status": "removed-degraded" if wedged else "removed",
                "worker": name}

    def rebalance(self, name: str, role: str) -> dict:
        """Flip one lane's role through ``Gateway.set_worker_role`` (the
        drain, migration, role change and undrain of /admin/role)."""
        gw = self.gateway
        gw._fleet_count("rebalance_attempted", worker=name, role=role)
        if name not in gw.lane_clients():
            gw._fleet_count("rebalance_failed", worker=name,
                            reason="unknown-lane")
            return {"ok": False, "status": "unknown-lane", "worker": name}
        try:
            res = gw.set_worker_role(name, role)
        except Exception as exc:
            gw._fleet_count("rebalance_failed", worker=name,
                            reason="flip-error")
            return {"ok": False, "status": "rebalance-failed",
                    "worker": name, "error": str(exc)[:200]}
        if res.get("ok"):
            gw._fleet_count("rebalance_completed", worker=name, role=role)
            return {"ok": True, "status": "rebalanced", "worker": name,
                    "role": role}
        gw._fleet_count("rebalance_failed", worker=name,
                        reason="flip-refused")
        return {"ok": False, "status": "rebalance-failed", "worker": name,
                "error": str(res.get("error", ""))[:200]}
