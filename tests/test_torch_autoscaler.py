"""The port's elastic fleet (``tpu_engine_torch.serving.autoscaler``, the
gateway's fleet surface, ``/admin/fleet`` and ``serve_combined`` with
``autoscale``) on the CPU, against the JAX package's:

- a counterpart of each test of ``tests/test_autoscaler.py``: the
  counters and the defaults-off schema, pressure folding, the probe gate
  and idempotency, the named ``spawn-wedged`` and ``drain-wedged`` states,
  a retirement through live stream migration (the stream token for token
  as an uninterrupted run), the role flip, the closed loop's clamps,
  cooldown, blind hold and hysteresis, the loop's start and stop, the
  manual surface on a stopped loop, both providers and the drain-pressure
  stat;
- parity with the live JAX code on the same inputs: ``lane_pressure``
  over a seeded corpus of /health bodies (within 1e-12), ``_tick``'s
  decision sequence over scripted per-lane samples through stub lanes
  (identical membership, counters, held reasons and spans),
  ``fleet_admin``'s bodies for every action and named failure, and the
  ``/stats`` ``fleet`` block;
- with the defaults, no controller thread and the reference /stats;
- the combined server: a minted lane shares the static lanes' weight
  tensors, joins the C++ front's ring and leaves it when retired (no hit
  answered or counted for it after), and its scheduler gives its device
  state back; the closed loop grows a paged gpt2-small-test fleet under
  a burst and retires a lane under a trickle with its stream migrated,
  every stream token-identical to a static fleet's.
"""

import http.client
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from tpu_engine.serving import autoscaler as jas
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.serving.resilience import FleetCounters as JaxFleetCounters
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.serving.app import serve_combined, stop_combined
from tpu_engine_torch.serving.autoscaler import (
    DEGRADED_DRAIN_WEDGED,
    DEGRADED_SPAWN_WEDGED,
    FleetAutoscaler,
    InProcessLaneProvider,
    StandbyLaneProvider,
    lane_pressure,
)
from tpu_engine_torch.serving.gateway import Gateway, _parse_sse
from tpu_engine_torch.serving.resilience import FleetCounters
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

MLP_KW = dict(model="mlp", dtype="float32", batch_buckets=(1, 2),
              device="cpu")
GEN_KW = dict(model="gpt2-small-test", dtype="float32",
              gen_scheduler="continuous", gen_step_chunk=2,
              gen_kv_block_size=16, gen_kv_blocks=40,
              gen_prefill_chunk=16, gen_max_batch_size=4, device="cpu")
PROMPT = [5, 9, 3, 17, 4, 22, 8]
# A dead address (port 9, discard): its /health never answers.
DEAD = "127.0.0.1:9"


def _mlp(node_id):
    return WorkerNode(WorkerConfig(node_id=node_id, **MLP_KW))


def _fleet_spans(gw):
    return [s for s in gw.tracer.snapshot() if s["op"] == "fleet"]


def assert_counters_match_spans(gw):
    fl = gw.fleet.as_dict()
    spans = [s["attrs"]["decision"] for s in _fleet_spans(gw)]
    for f in FleetCounters.SPAN_FIELDS:
        assert spans.count(f) == fl[f], (f, fl, spans)


@pytest.fixture(scope="module")
def gen_fleet():
    """Two continuous lanes on one weight tree."""
    workers = [WorkerNode(WorkerConfig(node_id="g0", **GEN_KW))]
    workers.append(WorkerNode(WorkerConfig(node_id="g1", **GEN_KW),
                              params=workers[0].engine.params))
    yield workers
    for w in workers:
        w.stop()


# -- counters and the defaults-off schema ---------------------------------------------

def test_fleet_counters_schema():
    c = FleetCounters()
    assert not c.any_nonzero()
    for f in FleetCounters.FIELDS:
        assert c.get(f) == 0
    c.bump("scale_up_attempted")
    assert c.as_dict()["scale_up_attempted"] == 1 and c.any_nonzero()
    assert FleetCounters.SPAN_FIELDS == FleetCounters.FIELDS
    assert FleetCounters.FIELDS == JaxFleetCounters.FIELDS
    assert FleetCounters.SPAN_FIELDS == JaxFleetCounters.SPAN_FIELDS


def test_defaults_off_stats_schema_and_no_controller():
    gw = Gateway([_mlp("w1")], GatewayConfig())
    try:
        assert set(gw.get_stats()) == {"total_workers", "total_requests",
                                       "failovers", "circuit_breakers"}
        assert gw._autoscaler is None
        assert not [t for t in threading.enumerate()
                    if t.name == "fleet-autoscaler"]
        st = gw.fleet_admin({"action": "status"})
        assert st["ok"] and st["state"] == "steady"
        assert st["autoscale"] is False
        # The status read makes no /stats block and no thread.
        assert "fleet" not in gw.get_stats()
        assert not gw._autoscaler.running
    finally:
        gw.stop()


def test_stats_fleet_block_appears_with_flag_or_activity():
    gw = Gateway([_mlp("w1")], GatewayConfig(autoscale=True))
    try:
        fl = gw.get_stats()["fleet"]
        assert fl["lanes"] == 1 and fl["degraded"] == {}
        for f in FleetCounters.FIELDS:
            assert fl[f] == 0
    finally:
        gw.stop()


# -- pressure folding -------------------------------------------------------------------

def test_lane_pressure_folds_health_signals():
    assert lane_pressure({"admission": {
        "queue_depth": 3, "max_queue_depth": 12,
        "adaptive": {"limit": 6}}}) == pytest.approx(0.5)
    assert lane_pressure({"admission": {
        "queue_depth": 3, "max_queue_depth": 12}}) == pytest.approx(0.25)
    assert lane_pressure({"generator": {"active": 2, "n_slots": 4}}) \
        == pytest.approx(0.5)
    assert lane_pressure({"generator": {"active": 0, "n_slots": 4},
                          "brownout": {"stage": 2}}) == pytest.approx(1.0)
    assert lane_pressure({"healthy": True}) is None
    assert lane_pressure(None) is None


def _health_corpus(n: int = 400) -> list:
    """Seeded /health bodies with every combination of the signals
    lane_pressure reads, present, absent, zero or None."""
    rng = np.random.default_rng(21)
    out = []
    for _ in range(n):
        h = {"healthy": bool(rng.integers(2))}
        if rng.random() < 0.6:
            adm = {"queue_depth": int(rng.integers(0, 40))}
            if rng.random() < 0.7:
                adm["max_queue_depth"] = [0, None, int(rng.integers(1, 64))][
                    int(rng.integers(3))]
            if rng.random() < 0.5:
                adm["adaptive"] = {"limit": [0, None, float(
                    rng.uniform(0.5, 48))][int(rng.integers(3))]}
            h["admission"] = adm
        if rng.random() < 0.6:
            h["generator"] = {"active": int(rng.integers(0, 9)),
                              "n_slots": [0, None, int(rng.integers(1, 9))][
                                  int(rng.integers(3))]}
        if rng.random() < 0.4:
            h["brownout"] = {"stage": int(rng.integers(0, 5))}
        out.append(h)
    return out + [None, [], "x", {}]


def test_lane_pressure_matches_jax_over_a_seeded_corpus():
    seen = set()
    for h in _health_corpus():
        got, want = lane_pressure(h), jas.lane_pressure(h)
        assert (got is None) == (want is None), h
        if got is not None:
            assert abs(got - want) <= 1e-12, h
            seen.add("over" if got > 1.0 else "value")
        else:
            seen.add("none")
    assert seen == {"none", "value", "over"}


# -- manual actuators (the /admin/fleet surface) ----------------------------------------

def test_scale_up_probe_gate_and_idempotency():
    gw = Gateway([_mlp("w1")], GatewayConfig())
    w2 = _mlp("w2")
    try:
        ctl = gw._fleet_controller()
        res = ctl.scale_up(worker=w2)
        assert res == {"ok": True, "status": "registered", "worker": "w2"}
        assert "w2" in gw.worker_names()
        before = gw.fleet.as_dict()
        assert ctl.scale_up(worker=w2)["status"] == "already-member"
        assert gw.fleet.as_dict() == before
        assert_counters_match_spans(gw)
    finally:
        gw.stop()
        w2.stop()


def test_scale_up_spawn_wedged_named_state_still_serving():
    gw = Gateway([_mlp("w1")],
                 GatewayConfig(autoscale_spawn_timeout_s=0.6))
    try:
        res = gw.fleet_admin({"action": "add", "worker": DEAD})
        assert res["ok"] is False and res["status"] == DEGRADED_SPAWN_WEDGED
        st = gw.fleet_status()
        assert st["state"] == "degraded:spawn-wedged"
        assert st["degraded"] == {DEAD: DEGRADED_SPAWN_WEDGED}
        assert gw.worker_names() == ["w1"]
        assert gw.route_request({"request_id": "r1",
                                 "input_data": [1.0] * 784})["node_id"]
        fl = gw.get_stats()["fleet"]
        assert fl["scale_up_failed"] == 1 and fl["degraded_entered"] == 1
        assert_counters_match_spans(gw)
        assert gw.fleet_admin({"action": "clear",
                               "worker": DEAD})["status"] == "cleared"
        assert gw.fleet_admin({"action": "clear",
                               "worker": DEAD})["status"] == "not-degraded"
        assert gw.fleet_status()["state"] == "steady"
    finally:
        gw.stop()


def test_scale_down_unknown_lane_and_missing_args():
    gw = Gateway([_mlp("w1")], GatewayConfig())
    try:
        assert gw.fleet_admin({"action": "remove",
                               "worker": "ghost"})["status"] == "unknown-lane"
        assert gw.fleet_admin({"action": "remove"})["status"] \
            == "missing-worker"
        assert gw.fleet_admin({"action": "add"})["status"] \
            == "missing-worker"
        assert gw.fleet_admin({"action": "rebalance",
                               "worker": "w1"})["status"] \
            == "missing-worker-or-role"
        assert gw.fleet_admin({"action": "bogus"})["status"] \
            == "unknown-action:bogus"
    finally:
        gw.stop()


def test_scale_down_drain_wedged_named_state_lane_still_removed():
    w1, w2 = _mlp("w1"), _mlp("w2")
    gw = Gateway([w1, w2], GatewayConfig(drain_timeout_s=1.0))
    try:
        def boom():
            raise ConnectionError("lane killed mid-drain")

        gw.lane_clients()["w2"].drain = boom
        res = gw._fleet_controller().scale_down(name="w2", manual=True)
        assert res["ok"] is True and res["status"] == "removed-degraded"
        assert gw.worker_names() == ["w1"]
        st = gw.fleet_status()
        assert st["degraded"] == {"w2": DEGRADED_DRAIN_WEDGED}
        assert st["state"] == "degraded:drain-wedged"
        assert gw.route_request({"request_id": "r1",
                                 "input_data": [1.0] * 784})["node_id"]
        fl = gw.get_stats()["fleet"]
        assert fl["scale_down_completed"] == 1
        assert fl["degraded_entered"] == 1
        assert gw.migration.get("drain_failures") == 1
        assert_counters_match_spans(gw)
    finally:
        gw.stop()
        w1.stop()
        w2.stop()


def _consume(gw, rid, prompt, max_new, armed=None, at=3):
    """Run one stream through ``gw`` on a thread; returns (thread, its
    tokens, a one-slot list for the terminal event)."""
    toks, final = [], [None]

    def run():
        for frame in gw.route_generate_stream(
                {"request_id": rid, "prompt_tokens": prompt,
                 "max_new_tokens": max_new}):
            evt = _parse_sse(frame)
            if evt is None:
                continue
            if evt.get("done"):
                final[0] = evt
                break
            if "tokens" in evt:
                toks.extend(evt["tokens"])
                if armed is not None and len(toks) >= at:
                    armed.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, toks, final


def test_scale_down_rides_live_stream_migration(gen_fleet):
    gw = Gateway(gen_fleet, GatewayConfig(migrate_streams=True,
                                          migrate_timeout_s=20.0))
    try:
        lane = gw._ring.get_node("el-0")
        control = gen_fleet[0].generator.generate(
            [PROMPT], max_new_tokens=16)[0]
        armed = threading.Event()
        t, toks, final = _consume(gw, "el-0", PROMPT, 16, armed)
        assert armed.wait(120), "stream never reached the drain point"
        res = gw._fleet_controller().scale_down(name=lane, manual=True)
        assert res["ok"] and res["status"] == "removed", res
        t.join(timeout=120)
        assert final[0] is not None and toks == control
        assert lane not in gw.worker_names()
        assert gw.fleet_status()["state"] == "steady"
        assert gw.migration.get("streams_migrated") == 1
        assert_counters_match_spans(gw)
    finally:
        gw.stop()
        for w in gen_fleet:
            w.undrain()


def test_rebalance_through_admin_role(gen_fleet):
    gw = Gateway(gen_fleet, GatewayConfig(disagg=True))
    try:
        res = gw.fleet_admin({"action": "rebalance", "worker": "g0",
                              "role": "prefill"})
        assert res["ok"] and res["status"] == "rebalanced"
        assert gw.worker_roles()["g0"] == "prefill"
        bad = gw.fleet_admin({"action": "rebalance", "worker": "g0",
                              "role": "sideways"})
        assert bad["ok"] is False and bad["status"] == "rebalance-failed"
        fl = gw.get_stats()["fleet"]
        assert fl["rebalance_completed"] == 1
        assert fl["rebalance_failed"] == 1
        assert_counters_match_spans(gw)
    finally:
        gw.fleet_admin({"action": "rebalance", "worker": "g0",
                        "role": "both"})
        gw.stop()


# -- the closed loop (synchronous ticks) ------------------------------------------------

class _TickHarness:
    """A controller whose observation reads scripted pressures; ticks run
    synchronously."""

    def __init__(self, gw, provider, pressures, scaler=FleetAutoscaler,
                 config=GatewayConfig, **cfg_over):
        cfg = config(**{"autoscale": True, "autoscale_cooldown_s": 0.0,
                        "autoscale_min_lanes": 1, **cfg_over})
        self.ctl = scaler(gw, provider=provider, config=cfg)
        self.pressures = pressures
        self.ctl.observe = lambda: {
            lane: self.pressures.get(lane, 0.0)
            for lane in gw.lane_clients()}


def test_tick_scales_up_then_down_with_clamps_and_cooldown():
    gw = Gateway([_mlp("w1")], GatewayConfig())
    extra = []

    def factory(idx):
        w = _mlp(f"spawn_{idx + 1}")
        extra.append(w)
        return w

    provider = InProcessLaneProvider(factory, max_lanes=4)
    try:
        h = _TickHarness(gw, provider, {}, autoscale_max_lanes=2,
                         autoscale_spawn_timeout_s=5.0)
        ctl = h.ctl
        h.pressures = {"w1": 1.0, "spawn_1": 1.0}
        ctl._tick()
        assert sorted(gw.worker_names()) == ["spawn_1", "w1"]
        ctl._tick()
        assert sorted(gw.worker_names()) == ["spawn_1", "w1"]
        assert gw.fleet.get("decisions_held") == 1
        ctl.config.autoscale_cooldown_s = 60.0
        ctl._last_action_ts = time.monotonic()
        h.pressures = {"w1": 0.0, "spawn_1": 0.0}
        ctl._tick()
        assert sorted(gw.worker_names()) == ["spawn_1", "w1"]
        assert gw.fleet.get("decisions_held") == 2
        ctl.config.autoscale_cooldown_s = 0.0
        ctl._last_action_ts = 0.0
        ctl._tick()
        assert len(gw.worker_names()) == 1
        ctl._tick()
        assert len(gw.worker_names()) == 1
        assert gw.fleet.get("decisions_held") == 3
        fl = gw.get_stats()["fleet"]
        assert fl["scale_up_completed"] == 1
        assert fl["scale_down_completed"] == 1
        assert_counters_match_spans(gw)
    finally:
        gw.stop()
        for w in extra:
            w.stop()


def test_tick_publishes_pressure_and_clears_spawn_wedge():
    gw = Gateway([_mlp("w1")], GatewayConfig())
    try:
        h = _TickHarness(gw, None, {"w1": 0.5})
        gw.fleet_enter_degraded("w1", DEGRADED_SPAWN_WEDGED)
        h.ctl._tick()
        assert gw.get_stats()["fleet"]["pressure"] == pytest.approx(0.5)
        assert gw.fleet_status()["state"] == "steady"
        assert gw.fleet.get("degraded_cleared") == 1
        assert_counters_match_spans(gw)
    finally:
        gw.stop()


def test_tick_blind_hold_never_retires_unobserved_fleet():
    w1, w2 = _mlp("b1"), _mlp("b2")
    gw = Gateway([w1, w2], GatewayConfig())
    extra = []

    def factory(idx):
        w = _mlp(f"bspawn_{idx + 1}")
        extra.append(w)
        return w

    provider = InProcessLaneProvider(factory, max_lanes=4)
    try:
        h = _TickHarness(gw, provider, {}, autoscale_max_lanes=4,
                         autoscale_spawn_timeout_s=5.0)
        ctl = h.ctl
        h.pressures = {"b1": None, "b2": None}
        ctl._tick()
        assert len(gw.worker_names()) == 2
        assert gw.fleet.get("decisions_held") == 1
        h.pressures = {"b1": 0.0, "b2": None}
        ctl._tick()
        assert len(gw.worker_names()) == 2
        assert gw.fleet.get("decisions_held") == 2
        assert not gw.fleet.get("scale_down_attempted")
        h.pressures = {"b1": 1.0, "b2": None}
        ctl._tick()
        assert len(gw.worker_names()) == 3
        assert gw.get_stats()["fleet"]["scale_up_completed"] == 1
        assert_counters_match_spans(gw)
    finally:
        gw.stop()
        w1.stop()
        w2.stop()
        for w in extra:
            w.stop()


def test_rebalance_arm_hysteresis():
    w = [_mlp(f"w{i}") for i in range(4)]
    gw = Gateway(w, GatewayConfig(disagg=True))
    try:
        gw._roles.update({"w0": "prefill", "w1": "prefill",
                          "w2": "decode", "w3": "decode"})
        flips = []
        h = _TickHarness(gw, None, {}, disagg=True,
                         autoscale_rebalance_band=2.0)
        ctl = h.ctl
        ctl.rebalance = lambda lane, role: (
            flips.append((lane, role)) or {"ok": True})
        samples = {"w0": 0.8, "w1": 0.8, "w2": 0.2, "w3": 0.2}
        assert ctl._maybe_rebalance(samples) is True
        assert flips == [("w2", "prefill")]
        assert ctl._maybe_rebalance(samples) is False
        assert len(flips) == 1
        assert ctl._maybe_rebalance(
            {"w0": 0.5, "w1": 0.5, "w2": 0.5, "w3": 0.5}) is False
        ctl._last_action_ts = 0.0
        assert ctl._maybe_rebalance(samples) is True
        assert len(flips) == 2
    finally:
        gw.stop()
        for x in w:
            x.stop()


def test_run_loop_starts_and_stops_cleanly():
    gw = Gateway([_mlp("w1")],
                 GatewayConfig(autoscale=True, autoscale_interval_s=0.05))
    try:
        ctl = gw.engage_autoscaler(provider=StandbyLaneProvider())
        assert ctl.running and gw.fleet_status()["autoscale"] is True
        deadline = time.monotonic() + 10.0  # a few live ticks
        while gw.get_stats()["fleet"].get("pressure") is None:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        ctl.stop()
        assert not ctl.running
        assert_counters_match_spans(gw)
    finally:
        gw.stop()


def test_manual_surface_survives_loop_stop():
    w1, w2 = _mlp("m1"), _mlp("m2")
    gw = Gateway([w1, w2], GatewayConfig(autoscale=True,
                                         autoscale_interval_s=0.05))
    try:
        ctl = gw.engage_autoscaler(provider=StandbyLaneProvider())
        ctl.stop()
        assert not ctl.running
        res = gw.fleet_admin({"action": "remove", "worker": "m2"})
        assert res["status"] == "removed"
        assert gw.worker_names() == ["m1"]
        assert_counters_match_spans(gw)
    finally:
        gw.stop()
        w1.stop()
        w2.stop()


# -- providers --------------------------------------------------------------------------

def test_standby_provider_lease_cycle():
    p = StandbyLaneProvider(["a:1", "b:2"])
    assert p.capacity() == 2
    first = p.spawn()
    assert first == "a:1" and p.capacity() == 1
    p.retire("a:1")
    assert p.capacity() == 2
    assert p.spawn() and p.spawn()
    assert p.spawn() is None and p.capacity() == 0


def test_inprocess_provider_stops_retired_lanes():
    stopped = []

    class FakeLane:
        def __init__(self, idx):
            self.node_id = f"lane{idx}"

        def stop(self):
            stopped.append(self.node_id)

    dropped = []
    p = InProcessLaneProvider(lambda i: FakeLane(i), max_lanes=1,
                              on_retire=dropped.append)
    lane = p.spawn()
    assert lane.node_id == "lane0" and p.capacity() == 0
    assert p.spawn() is None
    p.retire("lane0")
    assert stopped == ["lane0"] and len(dropped) == 1
    assert p.capacity() == 1

    def broken(_i):
        raise RuntimeError("no room on the card")

    q = InProcessLaneProvider(broken)
    assert q.spawn() is None and q.capacity() is None


def test_drain_pressure_stat_gated_on_draining(gen_fleet):
    w = gen_fleet[0]
    assert "drain_pressure" not in w.generator.stats()
    assert w.drain() == "draining"
    try:
        st = w.generator.stats()
        assert st["drain_pressure"] == pytest.approx(
            st["active"] / max(1, w.generator.n_slots))
    finally:
        assert w.undrain() == "undrained"
    assert "drain_pressure" not in w.generator.stats()


# -- parity with the JAX controller, through stub lanes ---------------------------------

class StubLane:
    """An in-process lane both packages' gateways take: a name, a model,
    a role, a /health body, a drain and a flight recorder."""

    def __init__(self, node_id: str):
        self.node_id = node_id
        self.engine = SimpleNamespace(spec=SimpleNamespace(name="stub"))
        self.config = SimpleNamespace(role="both", tp=1)
        self.stopped = False

    def get_health(self) -> dict:
        return {"healthy": True, "node_id": self.node_id}

    def drain(self) -> str:
        return "draining"

    def undrain(self) -> str:
        return "undrained"

    def flight_dump(self, reason: str):
        return None

    def stop(self) -> None:
        self.stopped = True


# (pressures by lane, whether the cooldown holds) of each scripted tick;
# lanes absent from a step read 0.0.
TICKS = (
    ({"s1": None, "s2": None}, False),            # blind: held
    ({"s1": 0.5, "s2": 0.6}, False),              # in band: nothing
    ({"s1": 1.0, "s2": 0.9}, False),              # up: spawn_1
    ({"s1": 1.0, "s2": 1.0, "spawn_1": 1.0}, True),   # cooldown: held
    ({"s1": 1.0, "s2": 1.0, "spawn_1": 1.0}, False),  # up: spawn_2
    ({"s1": 1.0, "s2": 1.0, "spawn_1": 1.0,
      "spawn_2": 1.0}, False),                    # max lanes: held
    ({"s1": 0.0, "s2": None}, False),             # down, partly blind
    ({"s1": 0.1, "s2": 0.0, "spawn_1": 0.05}, False),  # down: s2
    ({"s1": 0.1}, True),                          # cooldown: held
    ({"s1": 0.2}, False),                         # down: spawn_1
    ({}, False),                                  # min lanes: held
    ({"s1": 0.9, "spawn_2": 0.9}, False),         # up: spawn_3
    ({"s1": 0.9, "spawn_2": 0.9, "spawn_3": 0.9}, False),  # provider dry
    ({"s1": 0.5, "spawn_2": 0.5, "spawn_3": 0.5}, False),  # in band
)


def _drive_ticks(gw_cls, cfg_cls, scaler_cls, provider_cls) -> list:
    """The scripted ticks through one package's controller: after each,
    (members, counters, the fleet status, the /stats fleet block)."""
    made = []

    def factory(idx):
        lane = StubLane(f"spawn_{idx + 1}")
        made.append(lane)
        return lane

    gw = gw_cls([StubLane("s1"), StubLane("s2")], cfg_cls())
    trace = []
    try:
        provider = provider_cls(factory, max_lanes=2)
        h = _TickHarness(gw, provider, {}, scaler=scaler_cls,
                         config=cfg_cls, autoscale_max_lanes=4,
                         autoscale_min_lanes=2,
                         autoscale_spawn_timeout_s=5.0,
                         autoscale_up_pressure=0.75,
                         autoscale_down_pressure=0.25)
        for pressures, cooling in TICKS:
            h.pressures = pressures
            h.ctl.config.autoscale_cooldown_s = 60.0 if cooling else 0.0
            h.ctl._last_action_ts = time.monotonic() if cooling else 0.0
            h.ctl._tick()
            trace.append((sorted(gw.worker_names()), gw.fleet.as_dict(),
                          gw.fleet_status(), gw.get_stats()["fleet"]))
        spans = [(s["attrs"]["decision"], s["attrs"].get("reason"),
                  s["attrs"].get("worker"), s["attrs"].get("pressure"))
                 for s in gw.tracer.snapshot() if s["op"] == "fleet"]
        trace.append(spans)
        trace.append(sorted(lane.node_id for lane in made
                            if lane.stopped))
    finally:
        gw.stop()
    return trace


def test_tick_decisions_match_jax():
    got = _drive_ticks(Gateway, GatewayConfig, FleetAutoscaler,
                       InProcessLaneProvider)
    want = _drive_ticks(JaxGateway, JaxGatewayConfig, jas.FleetAutoscaler,
                        jas.InProcessLaneProvider)
    assert got == want
    decisions = [d for d, *_ in got[-2]]
    reasons = {r for d, r, *_ in got[-2] if d == "decisions_held"}
    assert reasons == {"blind", "cooldown", "max-lanes", "min-lanes",
                       "provider-exhausted"}
    assert decisions.count("scale_up_completed") == 3
    assert decisions.count("scale_down_completed") == 2
    assert got[-1] == ["spawn_1"]
    assert got[-3][0] == ["s1", "spawn_2", "spawn_3"]


def _admin_sequence(gw_cls, cfg_cls) -> list:
    """Every /admin/fleet action and named failure through one package's
    gateway, and its /stats fleet block after."""
    gw = gw_cls([StubLane("s1"), StubLane("s2")],
                cfg_cls(autoscale_spawn_timeout_s=0.3))
    try:
        out = [gw.fleet_admin(p) for p in (
            {}, {"action": "status"}, {"action": "add"},
            {"action": "add", "worker": DEAD},
            {"action": "status"},
            {"action": "clear", "worker": DEAD},
            {"action": "clear", "worker": DEAD},
            {"action": "clear"},
            {"action": "remove"}, {"action": "remove", "worker": "ghost"},
            {"action": "rebalance", "worker": "s1"},
            {"action": "rebalance", "worker": "ghost", "role": "prefill"},
            {"action": "bogus-" + "x" * 100},
            {"action": "remove", "worker": "s2"},
            {"action": "status"})]
        out.append(gw.get_stats()["fleet"])
        out.append(sorted(s["attrs"]["decision"]
                          for s in gw.tracer.snapshot()
                          if s["op"] == "fleet"))
        return out
    finally:
        gw.stop()


def test_fleet_admin_bodies_match_jax():
    got = _admin_sequence(Gateway, GatewayConfig)
    want = _admin_sequence(JaxGateway, JaxGatewayConfig)
    assert got == want
    statuses = [r.get("status") for r in got[:-2]]
    assert {"missing-worker", DEGRADED_SPAWN_WEDGED, "cleared",
            "not-degraded", "unknown-lane", "missing-worker-or-role",
            "removed"} <= set(statuses)
    assert got[-2]["lanes"] == 1


def test_metrics_fleet_family_matches_jax():
    """The /stats fleet block renders as JAX's tpu_engine_fleet_* family,
    byte for byte."""
    from tpu_engine.utils.metrics import render_prometheus as jax_render
    from tpu_engine_torch.utils.metrics import render_prometheus

    texts = []
    for gw_cls, cfg_cls in ((Gateway, GatewayConfig),
                            (JaxGateway, JaxGatewayConfig)):
        gw = gw_cls([StubLane("s1")], cfg_cls(autoscale=True))
        try:
            gw.fleet_observe(0.4375)
            gw.fleet_enter_degraded(DEAD, DEGRADED_SPAWN_WEDGED)
            gw._fleet_count("decisions_held", reason="cooldown")
            texts.append(gw.get_stats())
        finally:
            gw.stop()
    assert texts[0] == texts[1]
    got, want = render_prometheus([], texts[0]), jax_render([], texts[1])
    assert got == want
    assert "tpu_engine_fleet_" in (got.decode() if isinstance(got, bytes)
                                   else got)


# -- the combined server ----------------------------------------------------------------

def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _params_ptrs(w) -> list:
    return [t.data_ptr() for t in _leaves(w.engine.params)]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if hasattr(tree, "data_ptr") else []


def test_combined_minted_lane_shares_weights_and_follows_the_front():
    """A lane minted in the combined server shares the static lanes'
    weight tensors, joins the C++ front's ring (its repeats answered in
    C++), and once retired leaves the ring: no hit is answered or counted
    for it, and the ring equals the gateway's membership at each step."""
    gw, workers, srv = serve_combined(
        model="mlp", lanes=2, port=0, native_front=True,
        worker_config=WorkerConfig(**MLP_KW),
        gateway_config=GatewayConfig(port=0, autoscale=True,
                                     autoscale_interval_s=3600.0,
                                     autoscale_max_lanes=3))
    try:
        def rings_agree():
            return sorted(srv.ring_nodes()) == sorted(gw.worker_names())

        assert rings_agree() and gw._autoscaler.running
        res = gw._autoscaler.scale_up()
        assert res == {"ok": True, "status": "registered",
                       "worker": "worker_3"}
        minted = workers[-1]
        assert minted.node_id == "worker_3" and len(workers) == 3
        assert _params_ptrs(minted) == _params_ptrs(workers[0])
        assert rings_agree() and "worker_3" in srv.ring_nodes()
        rids = [r for r in (f"m{i}" for i in range(400))
                if gw._ring.get_node(r) == "worker_3"][:4]
        inp = np.random.default_rng(3).standard_normal(784).tolist()
        answers = [_call(srv.port, "POST", "/infer",
                         {"request_id": r, "input_data": inp})[1]
                   for r in rids]
        assert {a["node_id"] for a in answers} == {"worker_3"}
        assert [a["cached"] for a in answers] == [False, True, True, True]
        assert srv.lane_counters("worker_3") == (3, 3)
        status, body = _call(srv.port, "POST", "/admin/fleet",
                             {"action": "remove", "worker": "worker_3"})
        assert status == 200 and body["status"] == "removed"
        assert rings_agree() and "worker_3" not in srv.ring_nodes()
        assert minted not in workers and len(workers) == 2
        after = [_call(srv.port, "POST", "/infer",
                       {"request_id": r, "input_data": inp})[1]
                 for r in rids]
        assert all(a["node_id"] != "worker_3" for a in after)
        assert srv.lane_counters("worker_3") == (0, 0)
        _, st = _call(srv.port, "GET", "/stats")
        assert st["fleet"]["lanes"] == 2
        assert st["fleet"]["scale_up_completed"] == 1
        assert st["fleet"]["scale_down_completed"] == 1
        assert_counters_match_spans(gw)
    finally:
        stop_combined(gw, workers, srv)


def test_combined_http_lane_joins_the_front_ring_disabled():
    """An HTTP lane added to a C++-fronted server joins the front's ring
    (so that C++ routes as the gateway does) with its hits left to
    Python, and leaves it when removed."""
    from tpu_engine_torch.serving.app import serve_worker

    extra, esrv = serve_worker(WorkerConfig(port=0, node_id="http_lane",
                                            **MLP_KW))
    gw, workers, srv = serve_combined(
        model="mlp", lanes=1, port=0, native_front=True,
        worker_config=WorkerConfig(**MLP_KW))
    try:
        addr = f"127.0.0.1:{esrv.port}"
        res = gw.fleet_admin({"action": "add", "worker": addr})
        assert res["status"] == "registered"
        assert sorted(srv.ring_nodes()) == sorted(gw.worker_names())
        rid = next(r for r in (f"h{i}" for i in range(400))
                   if gw._ring.get_node(r) == addr)
        inp = [0.5] * 784
        for _ in range(2):
            _, ans = _call(srv.port, "POST", "/infer",
                           {"request_id": rid, "input_data": inp})
            assert ans["node_id"] == "http_lane"
        assert srv.lane_counters(addr) == (0, 0)
        assert gw.fleet_admin({"action": "remove",
                               "worker": addr})["status"] == "removed"
        assert srv.ring_nodes() == ["worker_1"]
    finally:
        stop_combined(gw, workers, srv)
        esrv.stop()
        extra.stop()


def _jax_weights():
    """gpt2-small-test's JAX weights in the port's layout (f32, CPU)."""
    from tpu_engine.models.registry import _ensure_builtin_models_imported
    from tpu_engine.models.registry import create_model as jcreate

    _ensure_builtin_models_imported()
    jp = jcreate("gpt2-small-test").init(jax.random.PRNGKey(0))
    return convert.params_from_jax(
        jax.tree.map(np.asarray, jp), create_model("gpt2-small-test").config,
        device="cpu", dtype="float32")


ELASTIC_GEN = dict(GEN_KW, gen_mixed_step=True, gen_mixed_token_budget=16,
                   gen_max_batch_size=8)


def test_combined_closed_loop_grows_and_shrinks_with_identical_streams(
        tmp_path):
    """The closed loop over a paged mixed gpt2-small-test fleet (ticks run
    by hand against the real observation and actuators): a burst of 8
    streams on 2 lanes reads above 0.30 and mints worker_3, which probes
    healthy, joins and serves; a trickle of one long stream per lane
    reads below 0.20 and retires a lane (static or minted alike), its
    stream migrated with no token replayed. Every stream equals the same request on a
    static two-lane fleet on the same weights; no block leaks; the
    retired lane's pool is released."""
    from tpu_engine_torch.utils.checkpoint import save_params

    ckpt = save_params(str(tmp_path / "gpt2"), _jax_weights())
    cfg = WorkerConfig(model_path=ckpt, **ELASTIC_GEN)
    rng = np.random.default_rng(7)
    burst = [[int(t) for t in rng.integers(1, 256, int(n))]
             for n in rng.integers(5, 30, 8)]
    long_prompts = [[int(t) for t in rng.integers(1, 256, 9)]
                    for _ in range(3)]
    # The control: the same requests on a static fleet, one at a time.
    cgw, cws, csrv = serve_combined(model="gpt2-small-test", lanes=2,
                                    port=0, native_front=False,
                                    worker_config=cfg)
    try:
        control = {}
        for i, p in enumerate(burst):
            control[f"b{i}"] = cgw.route_generate(
                {"request_id": f"b{i}", "prompt_tokens": p,
                 "max_new_tokens": 24})["tokens"]
        for i, p in enumerate(long_prompts):
            control[f"l{i}"] = cgw.route_generate(
                {"request_id": f"l{i}", "prompt_tokens": p,
                 "max_new_tokens": 40})["tokens"]
    finally:
        stop_combined(cgw, cws, csrv)
    gw, workers, srv = serve_combined(
        model="gpt2-small-test", lanes=2, port=0, native_front=False,
        worker_config=cfg,
        gateway_config=GatewayConfig(
            port=0, autoscale=True, migrate_streams=True,
            autoscale_interval_s=3600.0, autoscale_min_lanes=2,
            autoscale_max_lanes=3, autoscale_up_pressure=0.30,
            autoscale_down_pressure=0.20, autoscale_cooldown_s=0.0,
            autoscale_spawn_timeout_s=5.0))
    ctl = gw._autoscaler
    try:
        got = {}
        armed = threading.Event()
        runs = [(_consume(gw, f"b{i}", p, 24, armed, at=1), f"b{i}")
                for i, p in enumerate(burst)]
        assert armed.wait(60)
        deadline = time.monotonic() + 60
        while gw.fleet.get("scale_up_completed") == 0:
            assert time.monotonic() < deadline, gw.fleet.as_dict()
            ctl._tick()
            time.sleep(0.01)
        assert gw.fleet.get("scale_up_attempted") == 1
        assert sorted(gw.worker_names()) == ["worker_1", "worker_2",
                                             "worker_3"]
        minted = next(w for w in workers if w.node_id == "worker_3")
        assert _params_ptrs(minted) == _params_ptrs(workers[0])
        lanes = list(workers)
        for (t, toks, final), rid in runs:
            t.join(timeout=120)
            assert final[0] is not None and "error" not in final[0], rid
            got[rid] = toks
        # The trickle: one long stream on each lane.
        longs = []
        for i, p in enumerate(long_prompts):
            rid = next(r for r in (f"l{i}" if j == 0 else f"l{i}.{j}"
                                   for j in range(400))
                       if gw._ring.get_node(r) == f"worker_{i + 1}")
            armed = threading.Event()
            longs.append((_consume(gw, rid, p, 40, armed, at=2), f"l{i}",
                          armed))
        for _run, _rid, ev in longs:
            assert ev.wait(60)
        before = gw.migration.get("streams_migrated")
        ctl._tick()
        assert gw.fleet.get("scale_down_completed") == 1, \
            gw.fleet.as_dict()
        assert len(gw.worker_names()) == 2
        assert gw.migration.get("streams_migrated") == before + 1
        retired = [w for w in lanes if w.node_id not in gw.worker_names()]
        for (t, toks, final), rid, _ev in longs:
            t.join(timeout=120)
            assert final[0] is not None and "error" not in final[0], rid
            got[rid] = toks
        assert got == control
        assert gw.failover.get("tokens_replayed") == 0
        assert len(retired) == 1 and retired[0] not in workers
        pool = retired[0].generator._pool
        assert pool.caches is None and pool.scales is None
        for w in workers:
            st = w.generator.stats()
            kp = st["kv_pool"]
            assert st["active"] == 0
            assert kp["blocks_free"] + kp["radix_nodes"] \
                == kp["blocks_total"]
        assert_counters_match_spans(gw)
        _, body = _call(srv.port, "GET", "/stats")
        assert {"lanes", "pressure", "degraded"} <= set(body["fleet"])
    finally:
        stop_combined(gw, workers, srv)
