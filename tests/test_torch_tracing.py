"""The port's tracing (tpu_engine_torch.utils.tracing) against the JAX
package's (tpu_engine.utils.tracing) on the same inputs, and the
gateway's trace tree over HTTP lanes:

- traceparent parsing (valid, case and whitespace, malformed), the round
  trip, derive_trace_id, child contexts, percentile on seeded lists;
- SpanRecorder: the same seeded span sequence recorded into both gives
  equal summary(), stage_summary() and histogram snapshots; capacity 0
  records nothing; the ring evicts the oldest; TraceSink stages;
- spans_to_chrome, export_chrome and stitch_trace equal JAX's on the same
  span lists, evicted parents synthesized;
- the torch.profiler session writes a Chrome trace and reports it
  (device events 0 without a card), on the calling thread (which alone
  may stop it) or on a thread of its own (stopped from any thread),
  refuses a second start and a stop with none running, and the module
  imports torch.profiler only inside those functions;
- the port's gateway records JAX's route / attempt / resilience tree for
  a traced and an untraced request, and forwards a traceparent only
  when the client sent one.
All comparisons are exact (random span and trace ids masked where the
two packages mint their own)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

from tpu_engine.utils import tracing as jt
from tpu_engine_torch.utils import tracing as tt

REPO = Path(__file__).resolve().parent.parent

TID = "0af7651916cd43dd8448eb211c80319c"
SID = "b7ad6b7169203331"


@pytest.mark.parametrize("tp", [
    f"00-{TID}-{SID}-01",
    f"00-{TID.upper()}-{SID.upper()}-01",
    f"  00-{TID}-{SID}-00 \n",
    f"01-{TID}-{SID}-01",            # unknown version
    f"00-{TID[:-1]}-{SID}-01",       # short trace id
    f"00-{TID}-{SID}x-01",           # bad span id
    f"00-{TID}-{SID}",               # no flags
    "not-a-traceparent", "", 17, None,
])
def test_traceparent_parse_matches_jax(tp):
    payload = {"traceparent": tp} if tp is not None else {}
    j = jt.TraceContext.from_request(payload)
    t = tt.TraceContext.from_request(payload)
    assert (t is None) == (j is None)
    if j is not None:
        assert (t.trace_id, t.span_id) == (j.trace_id, j.span_id)
        assert t.to_traceparent() == j.to_traceparent()
    assert tt.TraceContext.from_request("not a dict") is None


def test_traceparent_round_trip_and_children():
    ctx = tt.TraceContext.root("req-1")
    assert ctx.trace_id == jt.derive_trace_id("req-1")
    back = tt.TraceContext.from_request(
        {"traceparent": ctx.to_traceparent()})
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    kids = [ctx.child() for _ in range(8)]
    assert {k.trace_id for k in kids} == {ctx.trace_id}
    assert len({k.span_id for k in kids}) == 8
    assert all(len(k.span_id) == 16 for k in kids)
    assert len(tt.TraceContext.root().trace_id) == 32
    assert repr(ctx) == f"TraceContext({ctx.to_traceparent()})"


@pytest.mark.parametrize("rid", ["a", "req-17", 42, "", "ü-ñ"])
def test_derive_trace_id_matches_jax(rid):
    assert tt.derive_trace_id(rid) == jt.derive_trace_id(rid)


@pytest.mark.parametrize("seed", range(4))
def test_percentile_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1000, size=int(rng.integers(1, 60))).tolist()
    for p in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert tt.percentile(vals, p) == jt.percentile(vals, p)
    assert tt.percentile([], 50) is None and jt.percentile([], 50) is None


OPS = ["infer", "generate", "generate_stream", "score", "route",
       "queue_wait", "device_compute", "mixed_step", "attempt"]


def _record_sequence(mod, seed, capacity=2048):
    """The same seeded spans into a recorder of ``mod``."""
    rng = np.random.default_rng(seed)
    rec = mod.SpanRecorder(capacity)
    for i in range(int(rng.integers(5, 80))):
        rec.record(f"r{i % 7}", OPS[int(rng.integers(len(OPS)))], "n1",
                   float(rng.exponential(3000.0)),
                   cached=bool(rng.random() < 0.3),
                   batch_size=int(rng.integers(1, 9)),
                   attrs={"k": int(i)} if rng.random() < 0.5 else None)
    return rec


@pytest.mark.parametrize("seed", range(3))
def test_summaries_and_histograms_match_jax(seed):
    j, t = _record_sequence(jt, seed), _record_sequence(tt, seed)
    assert t.summary() == j.summary()
    assert t.stage_summary() == j.stage_summary()
    jh, th = j.histograms(), t.histograms()
    assert sorted(th) == sorted(jh)
    for op in jh:
        assert th[op].snapshot() == jh[op].snapshot()
    strip = lambda spans: [{k: v for k, v in s.items() if k != "ts"}  # noqa
                           for s in spans]
    assert strip(t.snapshot()) == strip(j.snapshot())
    assert strip(t.recent(5)) == strip(j.recent(5))


def test_capacity_zero_and_eviction_match_jax():
    for mod in (jt, tt):
        off = _record_sequence(mod, 0, capacity=0)
        assert off.snapshot() == [] and off.histograms() == {}
        assert off.summary() == {"spans": 0} and off.stage_summary() == {}
    j, t = _record_sequence(jt, 5, 16), _record_sequence(tt, 5, 16)
    assert len(t.snapshot()) == 16
    assert t.stage_summary() == j.stage_summary()
    # Eviction drops spans, never histogram samples.
    assert {k: h.snapshot()["count"] for k, h in t.histograms().items()} \
        == {k: h.snapshot()["count"] for k, h in j.histograms().items()}


def test_trace_sink_stage_matches_jax_schema():
    out = []
    for mod in (jt, tt):
        rec = mod.SpanRecorder()
        ctx = mod.TraceContext(TID, SID)
        sink = mod.TraceSink(rec, "w1", "r1", ctx)
        sink.stage("queue_wait", 123.4, start_ts=5.0)
        sink.stage("kv_alloc", 7, start_ts=6.0, blocks=3, shared_blocks=1)
        spans = rec.snapshot()
        assert {s["parent_id"] for s in spans} == {SID}
        assert {s["trace_id"] for s in spans} == {TID}
        out.append([{k: v for k, v in s.items() if k not in ("ts",
                                                            "span_id")}
                    for s in spans])
    assert out[0] == out[1]


def _tree(seed):
    """Span lists of three lanes for one stream: a root on the gateway,
    children on the lanes, one evicted parent, and strangers."""
    rng = np.random.default_rng(seed)
    tid = jt.derive_trace_id("s1")
    spans = {"gateway": [], "a": [], "b": []}
    root = {"request_id": "s1", "op": "stream", "node": "gateway",
            "duration_us": 900, "cached": False, "batch_size": 1,
            "ts": 10.0, "trace_id": tid, "span_id": "root0000",
            "start_ts": 9.0}
    spans["gateway"].append(root)
    for lane in ("a", "b"):
        seg = f"seg-{lane}"
        spans[lane].append(dict(root, op="generate_stream", node=lane,
                                span_id=seg, parent_id="root0000",
                                start_ts=9.1 + len(lane) * 0.1))
        for i in range(int(rng.integers(1, 6))):
            spans[lane].append(dict(
                root, op="decode", node=lane, span_id=f"{lane}{i}",
                parent_id=seg, start_ts=9.2 + i * 0.01,
                duration_us=int(rng.integers(1, 500)),
                attrs={"tokens": i}))
    spans["b"].append(dict(root, op="kv_import", span_id="orph",
                           parent_id="gone-parent", start_ts=9.3))
    spans["b"].append(dict(root, request_id="other", op="decode",
                           trace_id="f" * 32, span_id="x1",
                           parent_id="x0"))
    spans["a"].append({"request_id": "s1", "op": "infer", "node": "a",
                       "duration_us": 5, "cached": True, "batch_size": 2,
                       "ts": 9.9})       # no tree ids, no start_ts
    return spans


@pytest.mark.parametrize("seed", range(3))
def test_chrome_and_stitch_match_jax(seed):
    spans = _tree(seed)
    assert tt.spans_to_chrome(spans) == jt.spans_to_chrome(spans)
    st, sj = (tt.stitch_trace(spans, "s1"), jt.stitch_trace(spans, "s1"))
    assert st == sj
    assert st["orphans"] == 1 and st["lanes"] == ["a", "b", "gateway"]
    roots = [e for e in st["chrome"]["traceEvents"]
             if e["name"] == "evicted_parent"]
    assert [r["args"]["span_id"] for r in roots] == ["gone-parent"]
    assert tt.stitch_trace(spans, "s1", trace_id="f" * 32) == \
        jt.stitch_trace(spans, "s1", trace_id="f" * 32)
    assert tt.stitch_trace({}, "nobody")["spans"] == []


def test_export_chrome_matches_jax():
    j, t = _record_sequence(jt, 7), _record_sequence(tt, 7)
    ej = jt.export_chrome({"n1": j})
    et = tt.export_chrome({"n1": t})
    mask = lambda ev: {k: v for k, v in ev.items() if k != "ts"}  # noqa
    assert [mask(e) for e in et["traceEvents"]] == \
        [mask(e) for e in ej["traceEvents"]]
    assert et["displayTimeUnit"] == "ms"


def _mm_work():
    import torch

    x = torch.ones(64, 64)
    for _ in range(3):
        x = x @ x / 64


def _in_thread(fn):
    import threading

    box = []
    t = threading.Thread(target=lambda: box.append(fn()))
    t.start()
    t.join()
    return box[0]


def test_profiler_session_on_the_cpu(tmp_path):
    assert tt.profiler_stop() == {"error": "profiler not running"}
    # On the calling thread: its CPU ops are in the trace.
    res = tt.profiler_start(str(tmp_path), on_caller=True)
    assert res == {"ok": True, "log_dir": str(tmp_path)}
    assert "already running" in tt.profiler_start(str(tmp_path))["error"]
    assert "another thread" in _in_thread(tt.profiler_stop)["error"]
    _mm_work()
    out = tt.profiler_stop()
    assert out["ok"] and out["log_dir"] == str(tmp_path)
    assert out["events"] > 0 and out["device_events"] == 0
    events = json.loads(Path(out["trace_file"]).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name")) for e in events)
    assert tt.profiler_stop() == {"error": "profiler not running"}
    # On a thread of its own: started on one thread, stopped on another.
    assert _in_thread(lambda: tt.profiler_start(str(tmp_path)))["ok"]
    _mm_work()
    out = _in_thread(tt.profiler_stop)
    assert out["ok"] and Path(out["trace_file"]).exists()
    assert tt.profiler_stop() == {"error": "profiler not running"}


def test_torch_profiler_is_imported_lazily():
    tree = ast.parse((REPO / "tpu_engine_torch/utils/tracing.py")
                     .read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m and m.split(".")[0] == "torch"]


class _Lane:
    """A scripted HTTP lane recording the payloads it receives; ``fail``
    answers 500 to /infer (a lane fault)."""

    def __init__(self, fail=False):
        from tpu_engine_torch.serving.http import JsonHttpServer

        self.payloads = []
        self.fail = fail
        self.server = JsonHttpServer(0, host="127.0.0.1")
        self.server.route("POST", "/infer", self.infer)
        self.server.route("GET", "/health", lambda _b: (200, {
            "healthy": True}))
        self.server.start(background=True)
        self.url = f"127.0.0.1:{self.server.port}"

    def infer(self, body):
        self.payloads.append(dict(body))
        if self.fail:
            raise RuntimeError("lane fault")
        return 200, {"request_id": body["request_id"], "output_data": [1.0],
                     "node_id": self.url, "cached": False,
                     "inference_time_us": 5}


def _shape(spans):
    """Per request: (op, parent's op, attrs without times) of each span."""
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        par = by_id.get(s.get("parent_id"))
        attrs = {k: v for k, v in (s.get("attrs") or {}).items()}
        out.append((s["request_id"], s["op"],
                    par["op"] if par else None, json.dumps(attrs,
                                                           sort_keys=True)))
    return sorted(out)


def test_gateway_trace_tree_and_forwarding_match_jax():
    from tpu_engine.serving.gateway import Gateway as JaxGateway
    from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
    from tpu_engine_torch.serving.gateway import Gateway
    from tpu_engine_torch.utils.config import GatewayConfig

    bad, good = _Lane(fail=True), _Lane()
    try:
        results = []
        for gw in (Gateway([bad.url, good.url], GatewayConfig()),
                   JaxGateway([bad.url, good.url], JaxGatewayConfig())):
            bad.payloads.clear()
            good.payloads.clear()
            # Ids whose primary is the failing lane: attempt, retry.
            rids = [r for r in (f"q{i}" for i in range(200))
                    if gw._ring.get_node(r) == bad.url][:2]
            gw.route_request({"request_id": rids[0], "input_data": [1.0]})
            gw.route_request({"request_id": rids[1], "input_data": [1.0],
                              "traceparent": f"00-{TID}-{SID}-01"})
            spans = gw.tracer.snapshot()
            sent = [("traceparent" in p) for p in
                    bad.payloads + good.payloads]
            results.append((_shape(spans), sent,
                            sorted({s["trace_id"] for s in spans}),
                            gw.get_stats()))
            gw.stop()
        (ts, tsent, ttids, tstats), (js, jsent, jtids, jstats) = results
        assert ts == js and tsent == jsent == [False, True, False, True]
        assert ttids == jtids and TID in ttids
        assert tstats == jstats
    finally:
        bad.server.stop(drain_s=0)
        good.server.stop(drain_s=0)
