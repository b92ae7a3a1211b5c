"""The port's observability plane against the JAX package's, on the CPU:

- lane parity in every scheduler mode (mixed, two-path, dense,
  mixed-spec): a JAX worker and a port worker on the same weights over
  HTTP take the same scripted requests in the same order (two streams, a
  /generate, a /score, an /infer miss with a coalesced follower, an
  /infer hit). The multiset of span ops per request and their parent
  structure, the stage_summary keys, the /metrics names and label sets
  and the counter values are the JAX worker's; mixed_step plus
  spec_verify spans equal the scheduler's ticks; the flight ring's
  records have the JAX records' keys. The one span the port does not
  record is the JAX engine's ``xla_compile``: the eager port compiles
  nothing per bucket;
- ``trace_capacity=0`` records nothing and /metrics carries no stage
  histogram, as in JAX; ``stats()["flight"]`` only while armed; a forced
  dump lands in the dump directory; the tick-bounded profile counts down
  and refuses without a profile directory with JAX's error dict; a start
  the decode loop does not take within its bound is withdrawn;
- stitching: a row moved twice (/admin/migrate + migrate_import over
  three --trace-stitch port lanes) gives one trace id on every lane, each
  lane's fragment dangling only its cross-lane link, and the gateway's
  stitch zero orphans; without --trace-stitch the snapshot and its chain
  carry no trace keys and the chain's bytes are the JAX pool's; a stream
  the gateway resumes after its lane dies stitches across the resume;
- the gateway: ``GatewayConfig(trace_stitch=True, slo_*)`` and the
  gateway command's observability flags are accepted; /admin/slo, the
  stats' slo and trace_ledger blocks and the tpu_engine_slo_* metrics
  equal the JAX gateway's on the same scripted HTTP lanes;
- the brownout's overload markers equal its escalations plus restores;
- a serving subprocess with observability on imports no jax and no
  tpu_engine module, and loads the port's tracing, metrics and slo.
Comparisons are exact; times and random span ids are masked."""

import http.client
import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_engine.serving.app import serve_worker as jax_serve_worker
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import serve_gateway, serve_worker
from tpu_engine_torch.serving.gateway import Gateway, _parse_sse
from tpu_engine_torch.serving.http import JsonHttpServer, sse_event
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

REPO = Path(__file__).resolve().parent.parent
MODEL = "gpt2-small-test"
MIXED = dict(gen_kv_block_size=16, gen_mixed_step=True, gen_prefill_chunk=16,
             gen_mixed_token_budget=16)
MODES = {
    "mixed": MIXED,
    "two-path": dict(gen_kv_block_size=16, gen_prefill_chunk=16,
                     gen_step_chunk=4),
    "dense": dict(gen_step_chunk=4),
    "mixed-spec": dict(MIXED, gen_continuous_spec_k=3),
}
# The JAX span the port does not record (see the module docstring).
JAX_ONLY_OPS = {"xla_compile"}


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _json(port, method, path, body=None):
    status, data = _req(port, method, path, body)
    assert status == 200, data
    return json.loads(data)


def _stream(port, body):
    status, data = _req(port, "POST", "/generate/stream", body)
    assert status == 200
    frames = [json.loads(f[6:]) for f in data.decode().split("\n\n")
              if f.startswith("data: ")]
    return frames


def _wait(pred, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _lane_pair(mode, **extra):
    """A JAX and a port worker of ``mode`` on the same weights, HTTP."""
    kw = dict(MODES[mode], **extra)
    jw, jsrv = jax_serve_worker(JaxWorkerConfig(
        port=0, node_id="w1", model=MODEL, dtype="float32", **kw),
        background=True)
    tparams = convert.params_from_jax(
        jax.tree.map(np.asarray, jw.engine.params), tcreate(MODEL).config,
        device="cpu")
    tw, tsrv = serve_worker(WorkerConfig(
        port=0, node_id="w1", model=MODEL, dtype="float32", device="cpu",
        **kw), params=tparams)
    return (jw, jsrv), (tw, tsrv)


def _drive(worker, port):
    """The scripted requests, in order; the /infer pair coalesces: the
    leader's dispatch waits until the follower is parked on it."""
    for i, prompt in enumerate(([5, 9, 3], [(k * 7) % 90 + 1
                                            for k in range(20)])):
        frames = _stream(port, {"request_id": f"s{i}",
                                "prompt_tokens": prompt,
                                "max_new_tokens": 6})
        assert frames[-1]["done"] and "error" not in frames[-1]
    _json(port, "POST", "/generate", {"request_id": "g0",
                                      "prompt_tokens": [1, 2, 3, 4],
                                      "max_new_tokens": 5})
    _json(port, "POST", "/score", {"request_id": "c0",
                                   "prompt_tokens": [1, 2, 3],
                                   "completion_tokens": [4, 5, 6]})
    gate = threading.Event()
    real = worker._dispatch_infer

    def gated(item, deadline):
        gate.wait(30)
        return real(item, deadline)
    worker._dispatch_infer = gated
    body = {"input_data": [3.0, 7.0, 1.0]}
    out = {}
    lead = threading.Thread(target=lambda: out.setdefault(
        "lead", _json(port, "POST", "/infer",
                      dict(body, request_id="i-lead"))))
    lead.start()
    assert _wait(lambda: len(worker._inflight) == 1)
    follow = threading.Thread(target=lambda: out.setdefault(
        "follow", _json(port, "POST", "/infer",
                        dict(body, request_id="i-follow"))))
    follow.start()
    time.sleep(0.4)
    gate.set()
    lead.join(60)
    follow.join(60)
    worker._dispatch_infer = real
    assert out["lead"]["output_data"] == out["follow"]["output_data"]
    hit = _json(port, "POST", "/infer", dict(body, request_id="i-hit"))
    assert hit["cached"] is True


def _spans(port):
    ev = _json(port, "GET", "/trace/export")["traceEvents"]
    return [e for e in ev if e.get("ph") == "X"
            and e["name"] not in JAX_ONLY_OPS]


def _tree_shape(events):
    """Per request: Counter of (op, parent op)."""
    by_id = {e["args"].get("span_id"): e for e in events}
    out = {}
    for e in events:
        par = by_id.get(e["args"].get("parent_id"))
        out.setdefault(e["args"]["request_id"], Counter())[
            (e["name"], par["name"] if par else None)] += 1
    return out


def _metrics(port):
    """{(name, labels): value} of /metrics, JAX-only stages dropped."""
    status, body = _req(port, "GET", "/metrics")
    assert status == 200
    out, types = {}, {}
    for ln in body.decode().splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, mtype = ln.split()
            types[name] = mtype
            continue
        if ln.startswith("#") or not ln:
            continue
        key, val = ln.rsplit(" ", 1)
        if any(f'stage="{op}"' in key for op in JAX_ONLY_OPS):
            continue
        out[key] = float(val)
    return out, types


_TIMED = ("_bucket", "_sum", "tpu_engine_batch_size_avg")


@pytest.fixture(scope="module", params=list(MODES))
def driven(request):
    """Each mode's pair of lanes, driven once."""
    mode = request.param
    extra = dict(flight_recorder=32) if mode != "dense" else {}
    (jw, jsrv), (tw, tsrv) = _lane_pair(mode, **extra)
    try:
        for w, srv in ((jw, jsrv), (tw, tsrv)):
            _drive(w, srv.port)
            assert _wait(lambda: w.generator.stats()["active"] == 0)
        yield mode, (jw, jsrv.port), (tw, tsrv.port)
    finally:
        for srv, w in ((jsrv, jw), (tsrv, tw)):
            srv.stop()
            w.stop()


def test_lane_spans_match_jax(driven):
    mode, (_jw, jport), (_tw, tport) = driven
    js, ts = _spans(jport), _spans(tport)
    jc = Counter((e["args"]["request_id"], e["name"]) for e in js)
    tc = Counter((e["args"]["request_id"], e["name"]) for e in ts)
    assert tc == jc
    assert _tree_shape(ts) == _tree_shape(js)
    assert ("i-follow", "coalesced_wait") in tc
    assert tc[("s0", "generate_stream")] == 1
    jst = _json(jport, "GET", "/trace")
    tst = _json(tport, "GET", "/trace")
    assert set(tst["stages"]["w1"]) == set(jst["stages"]["w1"]) - \
        JAX_ONLY_OPS
    assert tst["summary"]["w1"]["spans"] == jst["summary"]["w1"]["spans"]


def test_lane_ticks_equal_tick_spans(driven):
    mode, (jw, jport), (tw, tport) = driven
    for w, port in ((jw, jport), (tw, tport)):
        st = w.generator.stats()
        ops = Counter(e["name"] for e in _spans(port))
        ticks = (st.get("mixed") or {}).get("ticks", 0)
        spec = (st.get("spec") or {}).get("ticks", 0)
        assert ops["mixed_step"] == ticks
        assert ops["spec_verify"] == spec
        if mode in ("mixed", "mixed-spec"):
            assert ticks > 0
        if mode == "mixed-spec":
            assert spec == ticks


def test_lane_metrics_match_jax(driven):
    mode, (_jw, jport), (_tw, tport) = driven
    jm, jtypes = _metrics(jport)
    tm, ttypes = _metrics(tport)
    assert set(tm) == set(jm)
    assert ttypes == jtypes
    counters = {k: v for k, v in jm.items()
                if jtypes.get(k.split("{")[0]) == "counter"}
    assert {k: tm[k] for k in counters} == counters
    for key in jm:
        if key.endswith("_count}") or "_count{" in key:
            assert tm[key] == jm[key], key
    assert tm['tpu_engine_ttft_seconds_count{node="w1"}'] == 3.0


def test_lane_flight_ring_matches_jax(driven):
    mode, (jw, jport), (tw, tport) = driven
    jt = _json(jport, "GET", "/admin/timeline")
    tt = _json(tport, "GET", "/admin/timeline")
    assert set(tt) == set(jt)
    if mode == "dense":
        assert not tt["enabled"] and tt["timeline"] == []
        assert "flight" not in tw.generator.stats()
        return
    keys = lambda tl: set().union(*(r.keys() for r in tl))  # noqa: E731
    assert keys(tt["timeline"]) == keys(jt["timeline"])
    assert tt["capacity"] == jt["capacity"] == 32
    jfl = jw.generator.stats()["flight"]
    tfl = tw.generator.stats()["flight"]
    assert set(tfl) == set(jfl) and tfl["capacity"] == 32


@pytest.fixture(scope="module")
def capacity_zero():
    (jw, jsrv), (tw, tsrv) = _lane_pair("mixed", trace_capacity=0)
    try:
        for w, srv in ((jw, jsrv), (tw, tsrv)):
            _json(srv.port, "POST", "/generate", {
                "request_id": "z", "prompt_tokens": [1, 2],
                "max_new_tokens": 3})
            _json(srv.port, "POST", "/infer", {"request_id": "zi",
                                               "input_data": [1.0]})
        yield (jw, jsrv.port), (tw, tsrv.port)
    finally:
        for srv, w in ((jsrv, jw), (tsrv, tw)):
            srv.stop()
            w.stop()


def test_trace_capacity_zero_matches_jax(capacity_zero):
    (jw, jport), (tw, tport) = capacity_zero
    assert _spans(tport) == [] and _spans(jport) == []
    jm, _ = _metrics(jport)
    tm, _ = _metrics(tport)
    assert set(tm) == set(jm)
    assert not [k for k in tm if "stage_latency" in k]
    assert any(k.startswith("tpu_engine_ttft_seconds") for k in tm)
    assert "flight" not in tw.generator.stats()
    assert _json(tport, "GET", "/admin/trace/z")["spans"] == []


def test_profile_and_dump_endpoints(capacity_zero, tmp_path):
    (jw, jport), (tw, tport) = capacity_zero
    for port in (jport, tport):
        assert _json(port, "POST", "/admin/profile", {"ticks": 2}) == {
            "node_id": "w1", "error": "profiling not configured "
                                      "(start the worker with "
                                      "--profile-dir)"}
    assert _json(tport, "POST", "/admin/timeline", {"dump": "x"}) == \
        _json(jport, "POST", "/admin/timeline", {"dump": "x"}) == {
            "node_id": "w1", "enabled": False, "dumped": None}
    tw.config.profile_dir = str(tmp_path)
    res = _json(tport, "POST", "/admin/profile", {"ticks": 3})
    assert res["ok"] and res["ticks"] == 3
    assert _wait(lambda: _json(tport, "GET", "/admin/profile")[
        "ticks_left"] == 0)
    last = _json(tport, "GET", "/admin/profile")["last_result"]
    assert last["ok"] and os.path.exists(last["trace_file"])
    assert last["device_events"] == 0
    # Unbounded: open until stopped; a stop with none open is JAX's error.
    assert _json(tport, "POST", "/admin/profile", {}) == {
        "node_id": "w1", "ok": True, "log_dir": str(tmp_path)}
    stopped = _json(tport, "POST", "/admin/profile", {"action": "stop"})
    assert stopped["ok"] and os.path.exists(stopped["trace_file"])
    assert _json(tport, "POST", "/admin/profile", {"action": "stop"}) == \
        _json(jport, "POST", "/admin/profile", {"action": "stop"}) == {
            "node_id": "w1", "error": "profiler not running"}
    gen = tw.generator
    gen.configure_flight_recorder(8, str(tmp_path / "dumps"))
    dump = gen.flight_dump("smoke")
    assert dump["anomaly"] == "smoke" and os.path.exists(dump["path"])
    with open(dump["path"]) as f:
        assert json.load(f)["node"] == "w1"
    assert gen.stats()["flight"]["dumps"] == 1


def test_untaken_profile_start_is_withdrawn(capacity_zero, tmp_path,
                                            monkeypatch):
    """A start the decode loop does not take within its bound answers an
    error and never opens a capture later; the next start works."""
    _, (tw, _) = capacity_zero
    gen = tw.generator
    monkeypatch.setattr(gen, "_profile_tick", lambda: None)
    res = gen.start_profile(str(tmp_path), 2, timeout_s=0.05)
    assert res == {"error": "profile start failed: the decode loop took "
                            "no request in 0.05 s"}
    monkeypatch.undo()
    time.sleep(0.2)  # idle iterations: the withdrawn request is dropped
    assert gen._profile_start_req is None and not gen._profile_open
    res = gen.start_profile(str(tmp_path), 2)
    assert res["ok"] and res["ticks"] == 2
    assert _wait(lambda: gen.profile_status()["last_result"] is not None)
    assert gen.profile_status()["last_result"]["ok"]


# -- stitching ----------------------------------------------------------------

def _stitch_lane(i, params, stitch=True):
    return serve_worker(WorkerConfig(
        port=0, node_id=f"m{i}", model=MODEL, dtype="float32",
        device="cpu", trace_stitch=stitch, **MODES["mixed"]),
        params=params)


@pytest.fixture(scope="module")
def stitch_lanes():
    params = tcreate(MODEL).init(0, device="cpu", dtype="float32")
    lanes = [_stitch_lane(i, params) for i in range(3)]
    yield lanes
    for w, srv in lanes:
        srv.stop()
        w.stop()


def _migrating_stream(port, body, out):
    out.append(_stream(port, body))


def _export(src, rid):
    """Export the live row of ``rid`` from the lane ``src`` (worker,
    port) once it has streamed two tokens: the snapshot."""
    sw, sport = src
    assert _wait(lambda: any(r is not None and r.tag == rid
                             and len(sw.generator._row_emitted[k]) >= 2
                             for k, r in enumerate(
                                 sw.generator._row_req)))
    snap = _json(sport, "POST", "/admin/migrate", {"request_id": rid})
    assert snap["ok"], snap
    return snap


def test_twice_moved_stream_stitches_with_zero_orphans(stitch_lanes):
    lanes = [(w, srv.port) for w, srv in stitch_lanes]
    rid = "mv1"
    body = {"request_id": rid, "prompt_tokens": [4, 8, 15, 16, 23, 42],
            "max_new_tokens": 40}
    first, second = [], []
    t = threading.Thread(target=_migrating_stream,
                         args=(lanes[0][1], body, first))
    t.start()
    snap = _export(lanes[0], rid)
    assert "traceparent" in snap and "trace" in snap["chain"]
    t.join(60)
    assert first[0][-1]["migrated"] is True
    t2 = threading.Thread(target=_migrating_stream, args=(
        lanes[1][1], {"request_id": rid, "prompt_tokens": [],
                      "migrate_import": snap}, second))
    t2.start()
    snap2 = _export(lanes[1], rid)
    t2.join(60)
    final = _stream(lanes[2][1], {"request_id": rid, "prompt_tokens": [],
                                  "migrate_import": snap2})
    assert final[-1]["done"] and "error" not in final[-1]
    views = [_json(port, "GET", f"/admin/trace/{rid}") for _w, port in lanes]
    tids = {v["trace_id"] for v in views}
    span_tids = {s["trace_id"] for v in views for s in v["spans"]}
    assert len(tids) == 1 and span_tids == tids
    # Each lane's own fragment dangles only its link to the lane before.
    assert [v["orphans"] for v in views] == [0, 1, 1]
    imports = [s for v in views[1:] for s in v["spans"]
               if s["op"] == "kv_import"]
    assert len(imports) == 2
    gw = Gateway([f"127.0.0.1:{port}" for _w, port in lanes],
                 GatewayConfig(trace_stitch=True))
    try:
        merged = gw.stitched_trace(rid)
    finally:
        gw.stop()
    assert merged["orphans"] == 0 and merged["trace_id"] in tids
    assert len(merged["lanes"]) == 3
    roots = [s for s in merged["spans"] if s["op"] == "generate_stream"]
    assert sorted(r.get("attrs", {}).get("segment", "done")
                  for r in roots) == ["done", "exported", "exported"]


def test_unstitched_export_carries_no_trace_and_jax_chain_bytes():
    from tpu_engine.models.registry import (
        _ensure_builtin_models_imported,
        create_model as jcreate,
    )
    from tpu_engine.runtime.kv_blocks import BlockPool as JaxPool
    from tpu_engine_torch.runtime.kv_blocks import BlockPool

    params = tcreate(MODEL).init(0, device="cpu", dtype="float32")
    w, srv = _stitch_lane(9, params, stitch=False)
    try:
        out = []
        body = {"request_id": "u1", "prompt_tokens": [1, 2, 3, 4, 5],
                "max_new_tokens": 40}
        t = threading.Thread(target=_migrating_stream,
                             args=(srv.port, body, out))
        t.start()
        snap = _export((w, srv.port), "u1")
        t.join(60)
        assert "traceparent" not in snap and "trace" not in snap["chain"]
    finally:
        srv.stop()
        w.stop()
    import jax.numpy as jnp
    import torch
    from tpu_engine.ops.attention import KVCache as JKVCache

    _ensure_builtin_models_imported()
    tpool = BlockPool(tcreate(MODEL).config, 6, 16, torch.float32, "cpu")
    jpool = JaxPool(jcreate(MODEL).config, 6, 16, jnp.float32)
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(tuple(tpool.caches.k.shape))
            .astype(np.float32) for _ in range(2)]
    jpool.caches = JKVCache(*(jnp.asarray(a) for a in arrs))
    for t, a in zip(tpool._pool_tensors(), arrs):
        t.copy_(torch.from_numpy(a))
    plain = tpool.export_chain([1, 2, 3])
    assert plain == tpool.export_chain([1, 2, 3], trace=None)
    assert json.dumps(plain, sort_keys=True) == json.dumps(
        jpool.export_chain([1, 2, 3]), sort_keys=True)
    hdr = {"trace_id": "a" * 32, "parent_id": "b" * 16}
    traced = tpool.export_chain([1, 2, 3], trace=hdr)
    assert traced == dict(plain, trace=hdr)
    assert json.dumps(traced, sort_keys=True) == json.dumps(
        jpool.export_chain([1, 2, 3], trace=hdr), sort_keys=True)
    assert tpool.chain_compatible(traced) is None


class _KillableLane:
    """An HTTP lane in front of a real port worker whose first stream
    dies after ``die_after`` frames (a killed process)."""

    def __init__(self, worker, die_after=None):
        self.worker, self.die_after, self.calls = worker, die_after, 0
        self.server = JsonHttpServer(0, host="127.0.0.1")
        self.server.route("POST", "/generate/stream",
                          lambda b: (200, self.stream(b)))
        self.server.route("GET", "/health",
                          lambda _b: (200, {"healthy": True}))
        self.server.route("GET", "/trace/export", lambda _b: (
            200, __import__("tpu_engine_torch.utils.tracing",
                            fromlist=["x"]).export_chrome(
                {worker.node_id: worker.tracer})))
        self.server.route("POST", "/admin/timeline",
                          lambda b: (200, worker.handle_timeline(b)))
        self.server.start(background=True)
        self.url = f"127.0.0.1:{self.server.port}"

    def stream(self, payload):
        self.calls += 1
        inner = self.worker.handle_generate_stream(payload)
        if self.die_after is None or self.calls > 1:
            return inner

        def frames():
            for n, frame in enumerate(inner):
                if n == self.die_after:
                    inner.close()
                    self.server.stop(drain_s=0)  # the lane is gone
                    raise ConnectionResetError("lane killed mid-stream")
                yield frame
        return frames()


def test_resumed_stream_stitches_across_the_resume():
    from tpu_engine_torch.serving.worker import WorkerNode

    params = tcreate(MODEL).init(0, device="cpu", dtype="float32")
    workers = [WorkerNode(WorkerConfig(
        node_id=f"k{i}", model=MODEL, dtype="float32", device="cpu",
        trace_stitch=True, flight_recorder=16, **MODES["mixed"]),
        params=params) for i in range(2)]
    flaky = _KillableLane(workers[0], die_after=3)
    stable = _KillableLane(workers[1])
    gw = Gateway([flaky.url, stable.url],
                 GatewayConfig(failover_streams=True, trace_stitch=True))
    try:
        rid = next(f"r{i}" for i in range(2000)
                   if gw._ring.get_node(f"r{i}") == flaky.url)
        events = [_parse_sse(f) for f in gw.route_generate_stream(
            {"request_id": rid, "prompt_tokens": [5, 9, 3, 17],
             "max_new_tokens": 12})]
        assert events[-1]["done"] and events[-1]["resumed"] == 1
        merged = gw.stitched_trace(rid)
        assert merged["orphans"] == 0
        assert merged["lanes"] == sorted(["gateway", stable.url])
        assert merged["hops"][0]["kind"] == "admit"
        assert [h["kind"] for h in merged["hops"]] == ["admit", "resume"]
        ops = Counter(s["op"] for s in merged["spans"])
        assert ops["stream"] == 1 and ops["resume"] == 1
        assert ops["route"] == 2 and ops["generate_stream"] == 1
        assert {s["trace_id"] for s in merged["spans"]} == {
            merged["trace_id"]}
        st = gw.get_stats()
        assert st["trace_ledger"] == {"streams": 1, "capacity": 512,
                                      "hops": 2}
        assert st["failover"]["resumes_attempted"] == ops["resume"]
        # The resuming lane's flight recorder dumped.
        assert workers[1].generator.stats()["flight"]["dumps"] == 1
    finally:
        gw.stop()
        stable.server.stop(drain_s=0)
        for w in workers:
            w.stop()


# -- the gateway ----------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("trace_stitch", True), ("slo_ttft_p99_ms", 500.0),
    ("slo_itl_p99_ms", 200.0), ("slo_completion_p99_ms", 900.0)])
def test_observability_gateway_fields_are_accepted(field, value):
    cfg = GatewayConfig(**{field: value})
    assert getattr(cfg, field) == value
    assert getattr(JaxGatewayConfig(**{field: value}), field) == value


@pytest.mark.parametrize("flag,value,field", [
    ("--trace-stitch", None, "trace_stitch"),
    ("--trace-ledger-capacity", "64", "trace_ledger_capacity"),
    ("--slo-ttft-p99-ms", "250", "slo_ttft_p99_ms"),
    ("--slo-itl-p99-ms", "50", "slo_itl_p99_ms"),
    ("--slo-completion-p99-ms", "900", "slo_completion_p99_ms"),
    ("--slo-target", "0.9", "slo_target"),
    ("--slo-window-s", "30", "slo_window_s")])
def test_gateway_observability_flags_reach_the_config(flag, value, field):
    argv = ["127.0.0.1:8001", flag] + ([value] if value else [])
    _workers, cfg, _standby = cli.gateway_args(argv)
    assert getattr(cfg, field) == (True if value is None
                                   else type(getattr(cfg, field))(value))


def test_worker_observability_flags_reach_the_config():
    a, node, model, _path = cli.worker_node_args(
        ["8001", "w1", MODEL, "--trace-capacity", "0", "--trace-stitch",
         "--profile-dir", "/p", "--flight-recorder", "64",
         "--flight-dump-dir", "/d"])
    assert (a.trace_capacity, a.trace_stitch, a.profile_dir,
            a.flight_recorder, a.flight_dump_dir) == (0, True, "/p", 64,
                                                      "/d")
    cfg = cli.gateway_args(["127.0.0.1:8001", "--autoscale",
                            "--autoscale-slo-feed",
                            "--slo-ttft-p99-ms", "250"])[1]
    assert cfg.autoscale_slo_feed and cfg.autoscale
    assert not cli.gateway_args(["127.0.0.1:8001"])[1].autoscale_slo_feed


class _ScriptLane:
    """A scripted HTTP lane streaming deterministic tokens."""

    def __init__(self):
        self.server = JsonHttpServer(0, host="127.0.0.1")
        self.server.route("POST", "/generate/stream",
                          lambda b: (200, self.stream(b)))
        self.server.route("GET", "/health", lambda _b: (200, {
            "healthy": True}))
        self.server.start(background=True)
        self.url = f"127.0.0.1:{self.server.port}"

    def stream(self, payload):
        toks = [(len(payload["prompt_tokens"]) * 7 + i) % 97
                for i in range(payload.get("max_new_tokens", 4))]

        def events():
            for t in toks:
                yield sse_event({"tokens": [t]})
            yield sse_event({"done": True, "tokens": toks,
                             "request_id": payload["request_id"]})
        return events()


def mod_hist(gateway):
    """The LatencyHistogram class of ``gateway``'s package."""
    if isinstance(gateway, Gateway):
        from tpu_engine_torch.utils.metrics import LatencyHistogram
    else:
        from tpu_engine.utils.metrics import LatencyHistogram
    return LatencyHistogram


def _mask_windows(slo):
    out = dict(slo)
    out["objectives"] = {k: {f: v for f, v in o.items() if f != "window_s"}
                         for k, o in slo["objectives"].items()}
    return out


def test_gateway_slo_and_ledger_match_jax():
    lanes = [_ScriptLane(), _ScriptLane()]
    kw = dict(failover_streams=True, trace_stitch=True,
              slo_ttft_p99_ms=100.0, slo_completion_p99_ms=0.001,
              slo_target=0.9, slo_window_s=60.0)
    try:
        outs = []
        for gw, srv_fn in ((Gateway, serve_gateway), (JaxGateway, None)):
            if srv_fn is not None:
                g, srv = serve_gateway([ln.url for ln in lanes],
                                       GatewayConfig(port=0, **kw))
            else:
                from tpu_engine.serving.app import serve_gateway as jsg

                g, srv = jsg([ln.url for ln in lanes],
                             JaxGatewayConfig(port=0, **kw),
                             background=True)
            for i in range(4):
                frames = list(g.route_generate_stream(
                    {"request_id": f"q{i}", "prompt_tokens": [1] * (i + 1),
                     "max_new_tokens": 3}))
                assert _parse_sse(frames[-1])["done"]
            slo = _json(srv.port, "GET", "/admin/slo")
            st = g.get_stats()
            metrics = [ln for ln in _req(srv.port, "GET", "/metrics")[1]
                       .decode().splitlines() if "tpu_engine_slo_" in ln]
            stitch = _json(srv.port, "GET", "/admin/trace/q2")
            # The lanes' TTFT histograms, as a combined front hands them.
            rng = np.random.default_rng(5)
            hist = mod_hist(g)()
            for v in rng.exponential(0.08, size=50):
                hist.observe(float(v))
            named = {"tpu_engine_ttft_seconds": {"w": hist}}
            outs.append((_mask_windows(slo), _mask_windows(st["slo"]),
                         st["trace_ledger"], metrics,
                         Counter(s["op"] for s in stitch["spans"]),
                         stitch["orphans"], len(stitch["hops"]),
                         _mask_windows(g.slo_status(named)),
                         g.slo_pressure(named)))
            srv.stop()
            g.stop()
        assert outs[0] == outs[1]
        slo, fed = outs[0][0], outs[0][7]
        # Over HTTP lanes the gateway sees no TTFT/ITL histogram, and its
        # completion objective reads generate ops the gateway does not
        # record: no samples, in JAX as in the port.
        assert slo["objectives"]["ttft"]["samples"] == 0
        assert slo["objectives"]["completion"]["samples"] == 0
        assert fed["objectives"]["ttft"]["samples"] == 50
        assert fed["objectives"]["ttft"]["violations"] > 0
        assert outs[0][2] == {"streams": 4, "capacity": 512, "hops": 4}
        assert outs[0][5] == 0 and outs[0][6] == 1
    finally:
        for ln in lanes:
            ln.server.stop(drain_s=0)


def test_gateway_without_objectives_answers_like_jax():
    lane = _ScriptLane()
    try:
        g, srv = serve_gateway([lane.url], GatewayConfig(port=0))
        try:
            assert _json(srv.port, "GET", "/admin/slo") == {
                "error": "no objectives configured (set --slo-ttft-p99-ms"
                         " / --slo-itl-p99-ms / --slo-completion-p99-ms)"}
            st = g.get_stats()
            assert "slo" not in st and "trace_ledger" not in st
            assert g.slo_status() is None and g.slo_pressure() == 0.0
        finally:
            srv.stop()
            g.stop()
    finally:
        lane.server.stop(drain_s=0)


def test_brownout_markers_equal_transitions():
    from tpu_engine_torch.serving.worker import WorkerNode

    w = WorkerNode(WorkerConfig(node_id="b1", model=MODEL, dtype="float32",
                                device="cpu", brownout=True,
                                brownout_interval_s=3600.0,
                                **MODES["mixed"]))
    try:
        bo = w._brownout
        hot = {"queue_depth": 5.0}
        for comps in [hot] * 12 + [{}] * 40:
            action = bo.evaluate(comps)
            if action is not None:
                w._apply_brownout(action, comps)
        d = bo.as_dict()
        spans = [s for s in w.tracer.snapshot() if s["op"] == "overload"]
        assert d["escalations"] > 0 and d["restores"] > 0
        assert len(spans) == d["escalations"] + d["restores"]
        assert spans[0]["attrs"]["binding_signal"] == "queue_depth"
    finally:
        w.stop()


def test_observability_subprocess_imports_no_jax():
    code = (
        "import json, sys, urllib.request\n"
        "from tpu_engine_torch.serving.app import serve_worker,"
        " serve_gateway\n"
        "from tpu_engine_torch.utils.config import WorkerConfig,"
        " GatewayConfig\n"
        "w, s = serve_worker(WorkerConfig(port=0, model='gpt2-small-test',"
        " dtype='float32', device='cpu', gen_kv_block_size=16,"
        " gen_mixed_step=True, gen_prefill_chunk=16, flight_recorder=8,"
        " trace_stitch=True))\n"
        "g, gs = serve_gateway([f'127.0.0.1:{s.port}'], GatewayConfig("
        "port=0, trace_stitch=True, slo_completion_p99_ms=500.0))\n"
        "def get(port, path, body=None):\n"
        "    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',"
        " data=None if body is None else json.dumps(body).encode())\n"
        "    return urllib.request.urlopen(req, timeout=60).read()\n"
        "get(gs.port, '/generate', {'request_id': 'a', 'prompt_tokens':"
        " [1, 2], 'max_new_tokens': 3})\n"
        "for p in ('/metrics', '/trace', '/trace/export', '/admin/timeline',"
        " '/admin/profile', '/admin/trace/a'):\n"
        "    get(s.port, p)\n"
        "for p in ('/metrics', '/trace', '/admin/slo', '/admin/trace/a'):\n"
        "    get(gs.port, p)\n"
        "gs.stop(); g.stop(); s.stop(); w.stop()\n"
        "need = ['tpu_engine_torch.utils.tracing',"
        " 'tpu_engine_torch.utils.metrics', 'tpu_engine_torch.serving.slo']\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'missing': [m for m in need"
        " if m not in sys.modules], 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "missing": [], "bad": []}
