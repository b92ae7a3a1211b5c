"""Crash-tolerant streaming, the health prober, hedged dispatch and gateway
overload control in the port's gateway (tpu_engine_torch.serving.gateway)
against the JAX package's Gateway, on the CPU. Both gateways stand in
front of the same scripted lanes, served over HTTP on localhost (the
lanes of tests/test_failover.py: a position-dependent token function, so
a resume with a wrong offset changes every later token), one gateway at a
time with the lanes reset between them:

- every retryable mid-stream failure (a truncated body, a dropped
  connection, a retryable error event, a shed event) resumes on the
  other lane with prompt + emitted tokens and the budget offset, and the
  spliced stream, its done event, the resume request, the failover block
  and the breakers are JAX's; so are the terminal error events of the
  ends that cannot resume (a non-retryable event, the resume cap, the
  retry budget, a spent deadline, every lane down), the synthesized done
  of a fully delivered budget, and the defaults' plain relay;
- the prober ejects an unreachable or unhealthy lane with no breaker
  penalty and restores it, fails open when every lane is ejected, and
  forgets a removed lane, as JAX's does; probe_health answers on its own
  connection while the data pool is exhausted;
- a hedged /score in front of a slow lane is answered by the other lane
  and counted as JAX counts it; /generate is never hedged;
- tier admission against the in-flight gauge, the tenant bucket and the
  load-derived Retry-After shed as JAX's do; a stream holds the gauge
  until it ends; a defaults-only gateway's /stats is byte-identical to
  JAX's after the same traffic, priority and tenant fields included;
- through a real small port lane (gpt2-small-test, f32) a resumed stream
  equals the unbroken one, greedy, seeded and with controls, and a
  stream failed by the scheduler's device-step recovery resumes to the
  unbroken tokens;
- the gateway command's new flags reach GatewayConfig.
Comparisons are exact, except a measured latency threshold."""

import json
import queue
import threading
import time

import pytest

from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.serving.clients import HttpWorkerClient, WorkerError
from tpu_engine_torch.serving.gateway import Gateway, _parse_sse
from tpu_engine_torch.serving.http import JsonHttpServer, sse_event
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig
from tpu_engine_torch.utils.deadline import Overloaded

REQ = {"prompt_tokens": [5, 9, 3], "max_new_tokens": 10}


def deterministic_tokens(prompt, max_new):
    toks, ctx = [], list(prompt)
    for _ in range(max_new):
        t = (sum(ctx) * 31 + len(ctx)) % 211
        toks.append(t)
        ctx.append(t)
    return toks


class Lane:
    """A scripted worker over HTTP. ``die_after`` ends the first stream
    after that many token frames: ``truncate`` (the body ends with no
    terminal event), ``raise`` (the connection drops mid-body),
    ``error_event`` (the worker's terminal error event, ``retryable`` or
    not), ``shed_event`` (a terminal event of a shed); later calls
    stream to the end. ``always_die`` ends every stream after two."""

    def __init__(self, name, die_after=None, mode="truncate",
                 retryable=True, admit_fail=False, always_die=False,
                 score_delay=0.0, sleep_after=0.0):
        self.name = name
        self.die_after, self.mode = die_after, mode
        self.retryable, self.admit_fail = retryable, admit_fail
        self.always_die, self.score_delay = always_die, score_delay
        self.sleep_after = sleep_after
        self.reachable, self.healthy = True, True
        self.reset()
        self.server = JsonHttpServer(0, host="127.0.0.1")
        self.server.route("POST", "/generate/stream",
                          lambda b: (200, self.stream(b)))
        self.server.route("POST", "/score", lambda b: (200, self.score(b)))
        self.server.route("POST", "/infer", lambda b: (200, self.infer(b)))
        self.server.route("POST", "/generate",
                          lambda b: (200, self.generate(b)))
        self.server.route("GET", "/health", lambda _b: (200, self.health()))
        self.server.start(background=True)
        self.url = f"127.0.0.1:{self.server.port}"

    def reset(self):
        self.calls = 0
        self.payloads = []
        self.scores = 0

    def stream(self, payload):
        self.calls += 1
        self.payloads.append(dict(payload))
        if self.admit_fail:
            raise RuntimeError(f"{self.name} down")
        arm = self.always_die or (self.calls == 1
                                  and self.die_after is not None)
        die_after = 2 if self.always_die else self.die_after
        toks = deterministic_tokens(payload["prompt_tokens"],
                                    payload.get("max_new_tokens", 32))

        def events():
            for i, t in enumerate(toks):
                if arm and i >= die_after:
                    if self.mode == "raise":
                        raise ConnectionResetError("lane died")
                    if self.mode in ("error_event", "shed_event"):
                        exc = (Overloaded("lane draining")
                               if self.mode == "shed_event"
                               else RuntimeError("device-step failure")
                               if self.retryable else ValueError("bad row"))
                        yield sse_event(WorkerNode._stream_error(
                            exc, payload["request_id"], "tw", i))
                    if self.sleep_after:
                        time.sleep(self.sleep_after)
                    return
                yield sse_event({"tokens": [t]})
            yield sse_event({"done": True, "tokens": toks,
                             "node_id": self.name,
                             "request_id": payload["request_id"]})
        return events()

    def generate(self, payload):
        self.calls += 1
        return {"request_id": payload["request_id"], "node_id": self.name,
                "tokens": deterministic_tokens(payload["prompt_tokens"], 3)}

    def score(self, payload):
        self.scores += 1
        if self.score_delay:
            time.sleep(self.score_delay)
        return {"request_id": payload["request_id"], "logprobs": [-1.0],
                "total_logprob": -1.0, "node_id": self.name,
                "score_time_us": 1}

    def infer(self, payload):
        return {"request_id": payload["request_id"], "output_data": [1.0],
                "node_id": self.name, "cached": False,
                "inference_time_us": 10}

    def health(self):
        if not self.reachable:
            raise RuntimeError("probe refused")
        return {"healthy": self.healthy, "node_id": self.name}

    def close(self):
        self.server.stop(drain_s=0)


@pytest.fixture
def lanes():
    made = []

    def make(*specs):
        out = [Lane(**spec) for spec in specs]
        made.extend(out)
        return out
    yield make
    stops = [threading.Thread(target=lane.close) for lane in made]
    for t in stops:
        t.start()
    for t in stops:
        t.join(timeout=10)


def _gateways(urls, **kw):
    kw.setdefault("failover_streams", True)
    return [(name, cls(list(urls), cfg_cls(**kw))) for name, cls, cfg_cls in
            (("port", Gateway, GatewayConfig),
             ("jax", JaxGateway, JaxGatewayConfig))]


def primary_rid(gw, url, prefix="r"):
    return next(f"{prefix}{i}" for i in range(2000)
                if gw._ring.get_node(f"{prefix}{i}") == url)


def consume(it):
    events = [_parse_sse(f) for f in it]
    toks = [t for e in events[:-1] if e and "tokens" in e
            for t in e["tokens"]]
    return toks, events[-1], events


def _breakers(gw):
    return {e["node"]: (e["state"], e["failures"])
            for e in gw.get_stats()["circuit_breakers"]}


def both(lane_list, fn, **kw):
    """``fn(gw)`` through the port's and JAX's gateway in turn (lanes
    reset before each); returns [port result, JAX result]."""
    out = []
    for _name, gw in _gateways([ln.url for ln in lane_list], **kw):
        for ln in lane_list:
            ln.reset()
        try:
            out.append(fn(gw))
        finally:
            gw.stop()
    return out


def _stream_run(flaky, req=REQ):
    def run(gw):
        rid = primary_rid(gw, flaky.url)
        toks, final, events = consume(gw.route_generate_stream(
            dict(req, request_id=rid)))
        st = gw.get_stats()
        return toks, final, st.get("failover"), _breakers(gw), \
            st.get("resilience")
    return run


# -- crash-tolerant streaming -------------------------------------------------

@pytest.mark.parametrize("mode,penalised", [
    ("truncate", True), ("raise", True), ("error_event", True),
    ("shed_event", False)])
def test_splice_identity_across_failure_modes_matches_jax(lanes, mode,
                                                          penalised):
    flaky, stable = lanes(dict(name="flaky", die_after=4, mode=mode),
                          dict(name="stable"))
    port, ref = both([flaky, stable], _stream_run(flaky))
    control = deterministic_tokens(REQ["prompt_tokens"],
                                   REQ["max_new_tokens"])
    assert port == ref
    toks, final, fo, breakers, _res = port
    assert toks == control and final["tokens"] == control
    assert final["resumed"] == 1 and "error" not in final
    assert fo["stream_failures"] == fo["resumes_attempted"] == \
        fo["resumes_succeeded"] == 1 and fo["tokens_replayed"] == 4
    assert breakers[flaky.url][1] == int(penalised)
    resume = stable.payloads[-1]
    assert resume["prompt_tokens"] == REQ["prompt_tokens"] + control[:4]
    assert resume["max_new_tokens"] == REQ["max_new_tokens"] - 4


@pytest.mark.parametrize("case", ["non_retryable", "delivered", "cap",
                                  "budget_zero", "budget_one",
                                  "all_down"])
def test_stream_ends_match_jax(lanes, case):
    spec = {"non_retryable": (dict(die_after=4, mode="error_event",
                                   retryable=False), {}, {}),
            "delivered": (dict(die_after=10), {}, {}),
            "cap": (dict(always_die=True), dict(always_die=True),
                    dict(failover_max_resumes=2)),
            "budget_zero": (dict(die_after=3), {},
                            dict(retry_budget_ratio=0.0,
                                 retry_budget_min=0)),
            "budget_one": (dict(die_after=3), {},
                           dict(retry_budget_ratio=0.0,
                                retry_budget_min=1)),
            "all_down": (dict(die_after=3), dict(admit_fail=True), {})}
    f_kw, s_kw, g_kw = spec[case]
    flaky, stable = lanes(dict(name="flaky", **f_kw),
                          dict(name="stable", **s_kw))
    port, ref = both([flaky, stable], _stream_run(flaky), **g_kw)
    assert port == ref
    toks, final, fo, _br, _res = port
    control = deterministic_tokens(REQ["prompt_tokens"], 10)
    if case in ("delivered", "budget_one"):
        assert toks == control and final["tokens"] == control
        assert "error" not in final
    else:
        assert final["retryable"] is (case != "non_retryable")
        assert final["tokens_emitted"] == len(toks) == len(final["tokens"])
        assert final["trace_id"] and final["tokens"] == toks
    if case == "cap":
        assert "2 resumes" in final["error"] and len(toks) == 6
        assert fo["stream_failures"] == 3
    if case == "budget_zero":
        assert "retry budget" in final["error"] and fo["resumes_failed"] == 1


def test_expired_deadline_blocks_resume_like_jax(lanes):
    flaky, stable = lanes(dict(name="flaky", die_after=3, sleep_after=0.7),
                          dict(name="stable"))
    port, ref = both([flaky, stable], _stream_run(
        flaky, dict(REQ, deadline_ms=600)))
    for toks, final, fo, _br, res in (port, ref):
        assert final["retryable"] is False and "deadline" in final["error"]
        assert len(toks) == 3 and fo["resumes_attempted"] == 0
        assert res["deadline_expired"] == 1
    assert port[:3] == ref[:3]
    assert stable.calls == 0


def test_resume_forwards_the_deadline_left(lanes):
    flaky, stable = lanes(dict(name="flaky", die_after=3),
                          dict(name="stable"))
    sent = []

    def run(gw):
        _stream_run(flaky, dict(REQ, deadline_ms=60_000))(gw)
        sent.append(stable.payloads[-1]["deadline_ms"])
    both([flaky, stable], run)
    assert all(0 < d <= 60_000 for d in sent)


def test_failover_off_relays_the_truncation_like_jax(lanes):
    flaky, stable = lanes(dict(name="flaky", die_after=3),
                          dict(name="stable"))

    def run(gw):
        rid = primary_rid(gw, flaky.url)
        frames = list(gw.route_generate_stream(dict(REQ, request_id=rid)))
        return [_parse_sse(f) for f in frames], gw.get_stats()
    port, ref = both([flaky, stable], run, failover_streams=False)
    assert port == ref
    events, stats = port
    assert len(events) == 3 and not any(e.get("done") for e in events)
    assert "failover" not in stats and stable.calls == 0


# -- the health prober --------------------------------------------------------

def _wait(pred, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _prober_pair(urls, failures):
    return [gw for _n, gw in _gateways(
        urls, failover_streams=False, health_probe_interval_s=0.05,
        health_probe_failures=failures)]


@pytest.mark.parametrize("fault", ["unreachable", "unhealthy"])
def test_prober_ejects_and_restores_like_jax(lanes, fault):
    w1, w2 = lanes(dict(name="w1"), dict(name="w2"))
    gws = _prober_pair([w1.url, w2.url], 2)
    try:
        setattr(w1, "reachable" if fault == "unreachable" else "healthy",
                False)
        for gw in gws:
            assert _wait(lambda: gw.ejected_lanes() == [w1.url])
        for gw in gws:
            rid = primary_rid(gw, w1.url)
            toks, final, _ = consume(gw.route_generate_stream(
                dict(REQ, request_id=rid)))
            assert final["node_id"] == "w2"
            assert _breakers(gw)[w1.url] == ("CLOSED", 0)
        w1.reachable = w1.healthy = True
        for gw in gws:
            assert _wait(lambda: gw.ejected_lanes() == [])
        fos = [gw.get_stats()["failover"] for gw in gws]
        assert fos[0] == fos[1]
        assert fos[0]["prober_ejections"] == fos[0]["prober_restores"] == 1
    finally:
        for gw in gws:
            gw.stop()


def test_prober_fails_open_when_every_lane_is_ejected(lanes):
    w1, w2 = lanes(dict(name="w1"), dict(name="w2"))
    gws = _prober_pair([w1.url, w2.url], 1)
    try:
        w1.healthy = w2.healthy = False
        for gw in gws:
            assert _wait(lambda: gw.ejected_lanes() == sorted(
                [w1.url, w2.url]))
            toks, final, _ = consume(gw.route_generate_stream(
                dict(REQ, request_id="r_open")))
            assert toks == deterministic_tokens(REQ["prompt_tokens"], 10)
        w1.healthy = True
        for gw in gws:
            assert _wait(lambda: gw.ejected_lanes() == [w2.url])
            rid = primary_rid(gw, w2.url)
            toks, final, _ = consume(gw.route_generate_stream(
                dict(REQ, request_id=rid)))
            assert final["node_id"] == "w1"
        for gw in gws:
            gw.remove_worker(w2.url)
            assert gw.ejected_lanes() == []
            assert not gw._probe_state.ejected(w2.url)
    finally:
        for gw in gws:
            gw.stop()
    assert all(gw._prober_thread is None for gw in gws)


def test_probe_health_bypasses_an_exhausted_pool():
    w, s = serve_worker(WorkerConfig(port=0, node_id="ph1", model="mlp",
                                     dtype="float32", batch_buckets=(1, 2),
                                     device="cpu"))
    try:
        client = HttpWorkerClient(f"localhost:{s.port}", timeout_s=0.3)
        client._pool = queue.LifoQueue()  # every slot held by streams
        with pytest.raises(WorkerError, match="pool"):
            client.health()
        assert client.probe_health()["healthy"] is True
    finally:
        s.stop()
        w.stop()


# -- hedged dispatch ----------------------------------------------------------

def test_hedged_score_is_answered_by_the_other_lane_like_jax(lanes):
    slow, fast = lanes(dict(name="slow", score_delay=1.0),
                       dict(name="fast"))

    def run(gw):
        rid = primary_rid(gw, slow.url, "s")
        out = gw.route_score({"request_id": rid, "prompt_tokens": [1],
                              "completion_tokens": [2]})
        # A /generate is never hedged, however slow.
        g = gw.route_generate({"request_id": primary_rid(gw, slow.url, "g"),
                               "prompt_tokens": [1]})
        res = dict(gw.get_stats()["resilience"])
        thr = res.pop("hedge_threshold_ms")
        return out["node_id"], g["node_id"], res, thr
    port, ref = both([slow, fast], run, failover_streams=False,
                     hedge_enabled=True)
    assert port[:3] == ref[:3]
    node, gnode, res, thr = port
    assert node == "fast" and gnode == "slow"
    assert res["hedges"] == res["hedge_wins"] == 1 and thr >= 50.0
    assert res["hedge_losses"] == 0


def test_hedge_threshold_follows_the_other_lanes(lanes):
    a, b = lanes(dict(name="a"), dict(name="b"))
    gw = Gateway([a.url, b.url], GatewayConfig(hedge_enabled=True,
                                               hedge_min_samples=3,
                                               hedge_min_ms=1.0))
    jgw = JaxGateway([a.url, b.url], JaxGatewayConfig(
        hedge_enabled=True, hedge_min_samples=3, hedge_min_ms=1.0))
    for g in (gw, jgw):
        for lat in (0.2, 0.3, 0.4):
            g._lane_tracker(b.url).record(lat)
        g._lane_tracker(a.url).record(9.0)
        assert g._hedge_threshold_s(a.url) == 0.4   # b's p95
        assert g._hedge_threshold_s(b.url) == 0.001  # a: too few samples
    gw.stop()


# -- gateway overload control -------------------------------------------------

def _infer(gw, rid, **extra):
    try:
        return ("ok", gw.route_request(
            {"request_id": rid, "input_data": [1.0], **extra})["node_id"])
    except Exception as exc:  # compared across the packages
        if getattr(exc, "kind", None) == "overloaded":
            return ("shed", exc.cause, round(exc.retry_after_s, 6))
        return (type(exc).__name__, str(exc))


def test_gateway_tier_admission_matches_jax(lanes):
    (w1,) = lanes(dict(name="w1"))

    def run(gw):
        out = []
        for inflight, prio in ((8, "background"), (7, "batch"),
                               (8, "interactive"), (9, "batch"),
                               (10, "interactive"), (0, "soon"),
                               (14, "background"), (19, "interactive")):
            gw._inflight = inflight
            out.append(_infer(gw, f"r{inflight}", priority=prio))
        gw._inflight = 0
        return out, gw.get_stats()["overload"]
    port, ref = both([w1], run, failover_streams=False,
                     overload_control=True, overload_max_inflight=10)
    # The lane's ValueError message is JAX's: compare the class only.
    assert [o[:1] if o[0] == "ValueError" else o for o in port[0]] == \
        [o[:1] if o[0] == "ValueError" else o for o in ref[0]]
    assert port[1] == ref[1]
    outs = port[0]
    assert outs[0][:2] == ("shed", "tier") and outs[1] == ("ok", "w1")
    assert outs[2] == ("ok", "w1") and outs[3][:2] == ("shed", "tier")
    assert outs[4][:2] == outs[6][:2] == ("shed", "depth")
    assert outs[5][0] == "ValueError"
    hints = [o[2] for o in outs if o[0] == "shed"]
    assert hints == sorted(hints) and hints[0] > 1.0
    assert port[1]["shed_tier"] >= 1 and port[1]["shed_depth"] >= 1


def test_tenant_bucket_matches_jax(lanes):
    (w1,) = lanes(dict(name="w1"))

    def run(gw):
        out = [_infer(gw, f"a{i}", tenant="A") for i in range(6)]
        out.append(_infer(gw, "b0", tenant="B"))
        ov = gw.get_stats()["overload"]
        return [o[:2] for o in out], [o[2] for o in out if o[0] == "shed"], ov
    port, ref = both([w1], run, failover_streams=False, tenant_rate=1.0,
                     tenant_burst=2.0)
    assert port[0] == ref[0] and port[2] == ref[2]
    assert port[0] == [("ok", "w1")] * 2 + [("shed", "rate_limit")] * 4 + [
        ("ok", "w1")]
    assert all(h >= 0.5 for h in port[1])
    assert port[2]["rate_limited"] == 4 and port[2]["tenants"] == 2


def test_stream_holds_the_inflight_gauge(lanes):
    (w1,) = lanes(dict(name="w1"))
    gw = Gateway([w1.url], GatewayConfig(overload_control=True,
                                         overload_max_inflight=10))
    it = gw.route_generate_stream(dict(REQ, request_id="s1"))
    next(it)
    assert gw.get_stats()["overload"]["inflight"] == 1  # held mid-stream
    list(it)
    assert gw.get_stats()["overload"]["inflight"] == 0


def test_defaults_only_stats_are_jax_bytes(lanes):
    w1, w2 = lanes(dict(name="w1"), dict(name="w2"))

    def run(gw):
        for i in range(6):
            gw.route_request({"request_id": f"d{i}", "input_data": [1.0],
                              "priority": "background", "tenant": "A"})
        consume(gw.route_generate_stream(dict(REQ, request_id="ds")))
        return json.dumps(gw.get_stats())
    port, ref = both([w1, w2], run, failover_streams=False)
    assert port == ref
    assert set(json.loads(port)) == {"total_workers", "total_requests",
                                     "failovers", "circuit_breakers"}


# -- real small port lanes ----------------------------------------------------

class RealLane:
    """A lane over HTTP in front of a shared port worker; ``die_after``
    drops the connection after that many frames of its first stream (a
    killed process), ``recover_after`` fails the scheduler's next tick
    after that many frames instead (its retryable recovery event)."""

    def __init__(self, worker, die_after=None, recover_after=None):
        self.worker, self.calls = worker, 0
        self.die_after, self.recover_after = die_after, recover_after
        self.server = JsonHttpServer(0, host="127.0.0.1")
        self.server.route("POST", "/generate/stream",
                          lambda b: (200, self.stream(b)))
        self.server.route("GET", "/health",
                          lambda _b: (200, {"healthy": True}))
        self.server.start(background=True)
        self.url = f"127.0.0.1:{self.server.port}"

    def stream(self, payload):
        self.calls += 1
        inner = self.worker.handle_generate_stream(payload)
        if self.calls > 1 or (self.die_after is None
                              and self.recover_after is None):
            return inner

        def frames():
            n = 0
            for frame in inner:
                if n == self.recover_after:
                    gen = self.worker.generator
                    real = gen._decode_chunk

                    def failing():
                        gen._decode_chunk = real
                        raise RuntimeError("injected device failure")
                    gen._decode_chunk = failing
                if n == self.die_after:
                    inner.close()
                    raise ConnectionResetError("lane killed mid-stream")
                yield frame
                n += 1
        return frames()


@pytest.fixture(scope="module")
def shared_worker():
    w = WorkerNode(WorkerConfig(
        node_id="shared", model="gpt2-small-test", dtype="float32",
        device="cpu", gen_step_chunk=2, gen_kv_block_size=16,
        gen_prefill_chunk=16))
    yield w
    w.stop()


def _leak_free(worker):
    st = worker.generator.stats()
    kp = st["kv_pool"]
    return (st["active"] == 0
            and kp["blocks_free"] + kp["radix_nodes"] >= kp["blocks_total"])


@pytest.mark.parametrize("params,fault", [
    ({}, "kill"),
    ({"temperature": 0.9, "seed": 11}, "kill"),
    ({"temperature": 0.8, "seed": 4, "repetition_penalty": 1.3,
      "stop_tokens": [7], "top_p": 0.9}, "kill"),
    ({"temperature": 0.7, "seed": 23}, "recover")])
def test_real_lane_resume_equals_the_unbroken_stream(shared_worker, params,
                                                     fault):
    kw = ({"die_after": 3} if fault == "kill" else {"recover_after": 1})
    flaky, stable = RealLane(shared_worker, **kw), RealLane(shared_worker)
    gw = Gateway([flaky.url, stable.url],
                 GatewayConfig(failover_streams=True))
    try:
        req = {"prompt_tokens": [5, 9, 3, 17, 4, 8], "max_new_tokens": 14,
               **params}
        control = shared_worker.handle_generate(
            dict(req, request_id="ctl"))["tokens"]
        rid = primary_rid(gw, flaky.url)
        toks, final, _ = consume(gw.route_generate_stream(
            dict(req, request_id=rid)))
        assert flaky.calls == 1 and stable.calls == 1
        assert toks == control and final["tokens"] == control
        assert final["resumed"] == 1
        assert gw.failover.get("resumes_succeeded") == 1
        if fault == "recover":
            assert shared_worker.generator.stats()["failures"] >= 1
        assert _wait(lambda: _leak_free(shared_worker))
    finally:
        gw.stop()
        for lane in (flaky, stable):
            lane.server.stop(drain_s=0)


def test_gateway_command_flags_reach_the_config():
    workers, cfg, _standby = cli.gateway_args(
        ["127.0.0.1:8001", "127.0.0.1:8002", "--failover-streams",
         "--health-probe-interval", "0.2", "--overload-control",
         "--overload-max-inflight", "16", "--tenant-rate", "5"])
    assert workers == ["127.0.0.1:8001", "127.0.0.1:8002"]
    assert (cfg.failover_streams, cfg.health_probe_interval_s,
            cfg.overload_control, cfg.overload_max_inflight,
            cfg.tenant_rate) == (True, 0.2, True, 16, 5.0)
    _w, d, _standby = cli.gateway_args(["h:1"])
    assert d == GatewayConfig() and not d.failover_streams
    for field in ("hedge_enabled", "hedge_quantile", "hedge_min_ms",
                  "hedge_min_samples", "failover_max_resumes",
                  "health_probe_failures", "overload_max_inflight",
                  "tenant_burst"):
        assert getattr(d, field) == getattr(JaxGatewayConfig(), field)
    # Each ported feature is accepted (no NotImplementedError).
    GatewayConfig(hedge_enabled=True, failover_streams=True,
                  health_probe_interval_s=0.2, overload_control=True,
                  tenant_rate=5.0)
