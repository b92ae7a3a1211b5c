"""Prefix-affinity routing in the port's gateway
(tpu_engine_torch.serving.gateway, ``prefix_affinity``) against the JAX
package's Gateway, on the CPU. Both gateways stand in front of the same
scripted generate lanes served over HTTP (the lanes of
tests/test_affinity_routing.py: a deterministic token function), one at a
time with the lanes reset between them, and each case compares the
port's answers, routing, ``affinity`` block and ``affinity`` marker spans
with JAX's exactly:

- the fingerprint equals JAX's for the same payloads: block-aligned,
  capped at ``affinity_prefix_blocks``, None without a full block;
- requests sharing a prefix converge on one lane whatever their ids;
- each fallback to the request_id ring: no fingerprint, an ejected lane,
  an open breaker, the imbalance window, a resume skipping the dead
  affinity lane (the stream spliced); a draining lane sheds and fails
  over with no breaker penalty;
- streams are byte-identical with affinity on and off, the payload is
  untouched, and with the defaults /stats has no ``affinity`` block;
- the counters equal the marker spans, decision by decision.
"""

import json
import threading

import pytest

from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.serving.resilience import AffinityCounters as JaxCounters
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine_torch.serving.gateway import Gateway
from tpu_engine_torch.serving.http import JsonHttpServer, sse_event
from tpu_engine_torch.serving.resilience import AffinityCounters
from tpu_engine_torch.utils.config import GatewayConfig
from tpu_engine_torch.utils.deadline import Overloaded

SHARED = list(range(100, 132))  # two full blocks at block size 16


def deterministic_tokens(prompt, max_new):
    toks, ctx = [], list(prompt)
    for _ in range(max_new):
        t = (sum(ctx) * 31 + len(ctx)) % 211
        toks.append(t)
        ctx.append(t)
    return toks


class GenLane:
    """A scripted generate lane over HTTP: ``shed`` refuses every
    admission (a draining lane's 503), ``down`` fails like a dead worker,
    ``die_after`` truncates its first stream after that many tokens."""

    def __init__(self, name):
        self.name = name
        self.shed = self.down = False
        self.die_after = None
        self.reset()
        self.server = JsonHttpServer(0, host="127.0.0.1")
        self.server.route("POST", "/generate",
                          lambda b: (200, self.generate(b)))
        self.server.route("POST", "/generate/stream",
                          lambda b: (200, self.stream(b)))
        self.server.route("GET", "/health", lambda _b: (200, {
            "healthy": True, "node_id": self.name}))
        self.server.start(background=True)
        self.url = f"127.0.0.1:{self.server.port}"

    def reset(self):
        self.calls = 0
        self.payloads = []

    def _admit(self, payload):
        self.calls += 1
        self.payloads.append(dict(payload))
        if self.shed:
            raise Overloaded(f"{self.name} draining")
        if self.down:
            raise RuntimeError(f"{self.name} down")
        return deterministic_tokens(payload["prompt_tokens"],
                                    payload.get("max_new_tokens", 8))

    def generate(self, payload):
        toks = self._admit(payload)
        return {"request_id": payload["request_id"], "tokens": toks,
                "node_id": self.url, "generate_time_us": 1}

    def stream(self, payload):
        toks = self._admit(payload)
        arm = self.die_after is not None and self.calls == 1

        def events():
            for i, t in enumerate(toks):
                if arm and i >= self.die_after:
                    return  # a truncated body: the kill -9 signature
                yield sse_event({"tokens": [t]})
            yield sse_event({"done": True, "tokens": toks,
                             "node_id": self.url,
                             "request_id": payload["request_id"]})
        return events()


@pytest.fixture(scope="module")
def lanes():
    made = [GenLane(f"w{i}") for i in range(3)]
    yield made
    for lane in made:
        lane.server.stop(drain_s=0)


@pytest.fixture(autouse=True)
def _heal(lanes):
    yield
    for lane in lanes:
        lane.shed = lane.down = False
        lane.die_after = None
        lane.reset()


def _gateways(lanes, **kw):
    urls = [ln.url for ln in lanes]
    return [Gateway(urls, GatewayConfig(**kw)),
            JaxGateway(urls, JaxGatewayConfig(**kw))]


def both(lanes, fn, **kw):
    """``fn(gw)`` through the port's and JAX's gateway in turn (lanes
    reset before each, their switches kept); returns [port, JAX]."""
    out = []
    for gw in _gateways(lanes, **kw):
        for ln in lanes:
            ln.reset()
        try:
            out.append(fn(gw))
        finally:
            gw.stop()
    return out


def affinity_lane(gw, prompt):
    return gw._ring.get_node(gw._affinity_fingerprint(
        {"prompt_tokens": prompt}))


def off_ring_rids(gw, lane, n=8):
    """Request ids whose ring primary is not ``lane``."""
    return [r for r in (f"q{i}" for i in range(500))
            if gw._ring.get_node(r) != lane][:n]


def consume(it):
    toks, final = [], None
    for frame in it:
        evt = json.loads(frame.decode().strip()[len("data: "):])
        if evt.get("done"):
            final = evt
        else:
            toks.extend(evt.get("tokens", ()))
    return toks, final


def spans_by_decision(gw):
    out = {}
    for s in gw.tracer.snapshot():
        if s["op"] == "affinity":
            d = s["attrs"]["decision"]
            out[d] = out.get(d, 0) + 1
    return out


def test_counters_schema_matches_jax():
    assert AffinityCounters.FIELDS == JaxCounters.FIELDS
    c = AffinityCounters()
    assert not c.any_nonzero()
    c.bump("affinity_routed", 2)
    assert c.as_dict()["affinity_routed"] == 2 and c.any_nonzero()


FP_CASES = {
    "two-blocks": {"prompt_tokens": SHARED},
    "partial-tail": {"prompt_tokens": SHARED + [1, 2]},
    "past-the-cap": {"prompt_tokens": SHARED + list(range(64))},
    "short": {"prompt_tokens": [1, 2, 3]},
    "empty": {"prompt_tokens": []},
    "malformed": {"prompt_tokens": ["x"] * 20},
    "not-a-list": {"prompt_tokens": "abc"},
    "stateless": {"input_data": [1.0, 2.0]},
}


@pytest.mark.parametrize("cfg", [{}, {"affinity_block_size": 8,
                                      "affinity_prefix_blocks": 2}],
                         ids=["defaults", "bs8-cap2"])
@pytest.mark.parametrize("case", sorted(FP_CASES))
def test_fingerprint_equals_jax(lanes, case, cfg):
    gw, jgw = _gateways(lanes, prefix_affinity=True, **cfg)
    try:
        payload = FP_CASES[case]
        assert (gw._affinity_fingerprint(payload)
                == jgw._affinity_fingerprint(payload))
        if case == "partial-tail" or (case == "past-the-cap" and cfg):
            # A partial block, and blocks past the cap, never enter it.
            assert (gw._affinity_fingerprint(payload)
                    == gw._affinity_fingerprint(FP_CASES["two-blocks"]))
    finally:
        gw.stop()
        jgw.stop()


def test_shared_prefix_converges_like_jax(lanes):
    def run(gw):
        served = [gw.route_generate(
            {"request_id": f"r{i}", "prompt_tokens": SHARED + [i, 7 * i],
             "max_new_tokens": 1})["node_id"] for i in range(9)]
        return served, gw.get_stats()["affinity"], spans_by_decision(gw)
    port, jax_ = both(lanes, run, prefix_affinity=True)
    assert port == jax_
    served, aff, spans = port
    assert len(set(served)) == 1
    assert aff["affinity_routed"] == 9 and aff["assigned"] == {served[0]: 9}
    assert spans == {"affinity_routed": 9}


def test_short_prompt_takes_the_request_id_ring(lanes):
    def run(gw):
        out = gw.route_generate({"request_id": "tiny-1",
                                 "prompt_tokens": [1, 2, 3],
                                 "max_new_tokens": 1})
        return (out["node_id"] == gw._ring.get_node("tiny-1"),
                gw.get_stats()["affinity"], spans_by_decision(gw))
    port, jax_ = both(lanes, run, prefix_affinity=True)
    assert port == jax_ and port[0]
    assert port[1]["no_fingerprint"] == 1


@pytest.mark.parametrize("how", ["ejected", "breaker"])
def test_unavailable_affinity_lane_falls_back_like_jax(lanes, how):
    def run(gw):
        aff = affinity_lane(gw, SHARED + [0])
        if how == "ejected":
            gw._ejected.add(aff)
        else:
            for _ in range(gw.config.failure_threshold):
                gw.breaker_for(aff).record_failure()
        rid = off_ring_rids(gw, aff, 1)[0]
        out = gw.route_generate({"request_id": rid,
                                 "prompt_tokens": SHARED + [0],
                                 "max_new_tokens": 1})
        fell_back = (out["node_id"] != aff
                     and out["node_id"] == gw._ring.get_node(rid))
        restored = None
        if how == "ejected":
            gw._ejected.discard(aff)
            restored = gw.route_generate(
                {"request_id": rid, "prompt_tokens": SHARED + [0],
                 "max_new_tokens": 1})["node_id"] == aff
        return fell_back, restored, gw.get_stats()["affinity"], \
            spans_by_decision(gw)
    port, jax_ = both(lanes, run, prefix_affinity=True)
    assert port == jax_
    assert port[0] and port[2]["ejected_fallbacks"] == 1
    assert port[1] in (True, None)


def test_draining_affinity_lane_fails_over_without_penalty(lanes):
    def run(gw):
        aff = affinity_lane(gw, SHARED + [0])
        lane = next(ln for ln in lanes if ln.url == aff)
        lane.shed = True
        try:
            out = gw.route_generate({"request_id": "d1",
                                     "prompt_tokens": SHARED + [0],
                                     "max_new_tokens": 1})
        finally:
            lane.shed = False
        return (out["node_id"] != aff, gw.breaker_for(aff).state_name(),
                gw.get_stats()["affinity"])
    port, jax_ = both(lanes, run, prefix_affinity=True)
    assert port == jax_ and port[0] and port[1] == "CLOSED"


def test_imbalance_fallback_matches_jax(lanes):
    def run(gw):
        aff = affinity_lane(gw, SHARED + [0])
        got = [gw.route_generate({"request_id": r,
                                  "prompt_tokens": SHARED + [i],
                                  "max_new_tokens": 1})["node_id"]
               for i, r in enumerate(off_ring_rids(gw, aff, 8))]
        return aff, got, gw.get_stats()["affinity"], spans_by_decision(gw)
    port, jax_ = both(lanes, run, prefix_affinity=True,
                      affinity_max_imbalance=2)
    assert port == jax_
    aff, got, st, _ = port
    assert got[0] == got[1] == aff and any(g != aff for g in got[2:])
    assert st["imbalance_fallbacks"] > 0
    assert st["affinity_routed"] + st["imbalance_fallbacks"] == 8


def test_dead_affinity_lane_serves_via_failover(lanes):
    def run(gw):
        aff = affinity_lane(gw, SHARED + [0])
        lane = next(ln for ln in lanes if ln.url == aff)
        lane.down = True
        try:
            out = gw.route_generate({"request_id": "f1",
                                     "prompt_tokens": SHARED + [0],
                                     "max_new_tokens": 2})
        finally:
            lane.down = False
        return out["node_id"] != aff, out["tokens"]
    port, jax_ = both(lanes, run, prefix_affinity=True)
    assert port == jax_
    assert port == (True, deterministic_tokens(SHARED + [0], 2))


def test_streams_identical_with_affinity_on_and_off(lanes):
    req = {"request_id": "same", "prompt_tokens": SHARED + [3],
           "max_new_tokens": 6}
    off = [list(gw.route_generate_stream(dict(req)))
           for gw in _gateways(lanes)]
    on = [list(gw.route_generate_stream(dict(req)))
          for gw in _gateways(lanes, prefix_affinity=True)]
    # Byte-identical through both gateways under each setting.
    assert on[0] == on[1] and off[0] == off[1]

    def content(frames):
        # The serving lane may differ with affinity on: its name aside,
        # the stream is the same.
        out = []
        for f in frames:
            evt = json.loads(f.decode().strip()[len("data: "):])
            evt.pop("node_id", None)
            out.append(evt)
        return out
    assert content(on[0]) == content(off[0])


def test_payload_untouched_and_defaults_off(lanes):
    def run(gw):
        gw.route_generate({"request_id": "p1",
                           "prompt_tokens": SHARED + [2],
                           "max_new_tokens": 4})
        served = next(ln for ln in lanes if ln.payloads).payloads[0]
        return served, gw.get_stats()
    port, jax_ = both(lanes, run, prefix_affinity=True)
    assert port == jax_
    assert port[0] == {"request_id": "p1", "prompt_tokens": SHARED + [2],
                       "max_new_tokens": 4}
    port, jax_ = both(lanes, run)
    assert port == jax_ and "affinity" not in port[1]


def test_resume_skips_the_dead_affinity_lane_like_jax(lanes):
    prompt = SHARED + [4]

    def run(gw):
        aff = affinity_lane(gw, prompt)
        next(ln for ln in lanes if ln.url == aff).die_after = 3
        toks, final = consume(gw.route_generate_stream(
            {"request_id": "c1", "prompt_tokens": prompt,
             "max_new_tokens": 8}))
        resumed = [ln.payloads[-1]["prompt_tokens"] for ln in lanes
                   if ln.url != aff and ln.payloads]
        return toks, final, resumed, gw.get_stats()["affinity"], \
            spans_by_decision(gw)
    port, jax_ = both(lanes, run, prefix_affinity=True,
                      failover_streams=True)
    assert port == jax_
    toks, final, resumed, aff, _ = port
    control = deterministic_tokens(prompt, 8)
    assert toks == control and final["tokens"] == control
    assert final["resumed"] == 1 and resumed == [prompt + control[:3]]
    assert aff["resume_skips"] == 1


def test_counters_match_marker_spans_under_concurrency(lanes):
    gw = Gateway([ln.url for ln in lanes],
                 GatewayConfig(prefix_affinity=True,
                               affinity_max_imbalance=3))
    try:
        def send(i):
            prompt = SHARED + [i] if i % 3 else [i]
            gw.route_generate({"request_id": f"s{i}",
                               "prompt_tokens": prompt,
                               "max_new_tokens": 1})
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        aff = gw.get_stats()["affinity"]
        spans = spans_by_decision(gw)
        for field in AffinityCounters.FIELDS:
            assert spans.get(field, 0) == aff[field], (field, aff, spans)
        assert sum(aff[f] for f in AffinityCounters.FIELDS) == 12
    finally:
        gw.stop()
