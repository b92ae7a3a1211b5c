"""The port worker's admission plane (tpu_engine_torch.serving.worker with
serving.resilience.AdmissionController) beside the JAX package's worker on
the CPU, over HTTP where the wire is compared:

- an expired deadline_ms sheds 503 deadline_exceeded on both, and then
  /health carries the same keys on both, the admission block included
  (the port had no admission block);
- an /infer miss whose budget is below the lane's service-time EWMA is a
  503 overloaded on both (stub dispatch with a fixed 200 ms service time;
  the port had no early rejection), a hit with the same budget is served;
  the estimate is the misses' inference_time_us on the unified and the
  batch lane alike;
- /admin/drain answers the same bodies over drain, drain, undrain,
  undrain, a draining lane sheds 503 overloaded, and the scheduler carries
  drain_pressure while draining;
- max_queue_depth sheds the request over it with the same body;
- a stream holds its slot while it runs and releases it when its events
  end or it is closed, started or not;
- the worker routes no GET /stats, as the JAX worker routes none.
Bodies are compared exactly, with the milliseconds of an early-rejection
message masked."""

import http.client
import json
import re
import threading
import time

import numpy as np
import pytest

from tpu_engine.serving import worker as jworker_mod
from tpu_engine.serving.app import serve_worker as jax_serve_worker
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.serving import worker as tworker_mod
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.utils.config import WorkerConfig
from tpu_engine_torch.utils.deadline import Overloaded

MLP = dict(model="mlp", dtype="float32", batch_buckets=(1, 2, 4, 8),
           max_batch_size=8)
GEN = dict(model="gpt2-small-test", dtype="float32", gen_kv_block_size=16,
           gen_mixed_step=True, gen_prefill_chunk=16,
           gen_mixed_token_budget=16)


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, None if body is None
                     else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


def _health(port):
    status, raw, _ = _call(port, "GET", "/health")
    assert status == 200
    return json.loads(raw)


@pytest.fixture
def pair(request):
    """(JAX worker, its port, port worker, its port) on the mlp lane, both
    with node_id "w"; ``request.param`` overrides both configs."""
    kw = dict(MLP, **getattr(request, "param", {}))
    jw, jsrv = jax_serve_worker(JaxWorkerConfig(port=0, node_id="w", **kw))
    tw, tsrv = serve_worker(WorkerConfig(port=0, node_id="w", device="cpu",
                                         **kw))
    try:
        yield jw, jsrv.port, tw, tsrv.port
    finally:
        tsrv.stop()
        tw.stop()
        jsrv.stop()
        jw.stop()


def _both(pair, method, path, body=None):
    _jw, jport, _tw, tport = pair
    return _call(jport, method, path, body), _call(tport, method, path, body)


def test_expired_deadline_grows_the_admission_block_like_jax(pair):
    _jw, jport, _tw, tport = pair
    assert "admission" not in _health(jport)
    assert "admission" not in _health(tport)
    j, t = _both(pair, "POST", "/infer", {"request_id": "a",
                                          "input_data": [1.0, 2.0],
                                          "deadline_ms": 0})
    assert j == t and j[0] == 503
    assert json.loads(j[1])["kind"] == "deadline_exceeded" and j[2] == "1"
    jh, th = _health(jport), _health(tport)
    assert set(th) == set(jh)
    assert th["admission"] == jh["admission"] == {
        "draining": False, "queue_depth": 0, "max_queue_depth": 0,
        "shed_overloaded": 0, "shed_deadline": 1, "shed_draining": 0,
        "deadline_dropped": 0}
    assert th["total_requests"] == jh["total_requests"] == 0


def _stub_dispatch(worker, module, service_us, gate=None):
    """Replace the worker's miss dispatch by one that reports a fixed
    service time (and waits on ``gate`` when given)."""
    def dispatch(item, deadline):
        if gate is not None:
            gate.wait(30)
        return module._BatchResult(np.zeros(4, np.float32), service_us)
    worker._dispatch_infer = dispatch


def _mask(raw):
    return re.sub(rb"\d+ ms", b"N ms", raw)


@pytest.mark.parametrize("pair", [dict(unified_stateless=True),
                                  dict(unified_stateless=False)],
                         indirect=True, ids=["unified", "batch-lane"])
def test_miss_below_the_estimate_is_overloaded_like_jax(pair):
    jw, jport, tw, tport = pair
    _stub_dispatch(jw, jworker_mod, 200_000)
    _stub_dispatch(tw, tworker_mod, 200_000)
    warm = {"request_id": "warm", "input_data": [1.0, 2.0, 3.0]}
    j, t = _both(pair, "POST", "/infer", warm)
    assert j == t and j[0] == 200
    assert json.loads(t[1])["inference_time_us"] == 200_000
    assert tw.service_estimate_us == jw._service_ewma_us == 200_000
    j, t = _both(pair, "POST", "/infer", {"request_id": "miss",
                                          "input_data": [4.0],
                                          "deadline_ms": 100})
    assert j[0] == t[0] == 503 and j[2] == t[2] == "1"
    assert _mask(j[1]) == _mask(t[1])
    assert json.loads(t[1])["kind"] == "overloaded"
    assert b"cannot meet the deadline" in t[1]
    # A hit is never shed against the miss estimate; a budget above it is
    # served.
    j, t = _both(pair, "POST", "/infer", dict(warm, deadline_ms=100))
    assert j == t and j[0] == 200 and json.loads(t[1])["cached"]
    j, t = _both(pair, "POST", "/infer", {"request_id": "roomy",
                                          "input_data": [5.0],
                                          "deadline_ms": 5000})
    assert j == t and j[0] == 200
    jh, th = _health(jport), _health(tport)
    assert th["admission"] == jh["admission"]
    assert th["admission"]["shed_deadline"] == 1
    assert th["total_requests"] == jh["total_requests"] == 4


@pytest.mark.parametrize("unified", [True, False])
def test_miss_time_feeds_the_estimate(unified):
    """The estimate is an EWMA (0.8 / 0.2) of the misses'
    inference_time_us, which on both lanes is the dispatch's time, not
    0."""
    tw, tsrv = serve_worker(WorkerConfig(port=0, node_id="w", device="cpu",
                                         unified_stateless=unified, **MLP))
    try:
        times = []
        for i in range(3):
            status, raw, _ = _call(tsrv.port, "POST", "/infer", {
                "request_id": f"m{i}", "input_data": [float(i), 1.0]})
            assert status == 200
            times.append(json.loads(raw)["inference_time_us"])
        assert all(t > 0 for t in times)
        want = times[0]
        for t in times[1:]:
            want = 0.8 * want + 0.2 * t
        assert tw.service_estimate_us == pytest.approx(want, rel=1e-12)
    finally:
        tsrv.stop()
        tw.stop()


def test_admin_drain_bodies_match_jax(pair):
    _jw, jport, _tw, tport = pair
    statuses = []
    for action in ("drain", "drain"):
        j, t = _both(pair, "POST", "/admin/drain", {"action": action})
        assert j == t and j[0] == 200
        statuses.append(json.loads(t[1])["status"])
    j, t = _both(pair, "POST", "/infer", {"request_id": "d",
                                          "input_data": [1.0]})
    assert j == t and j[0] == 503
    assert json.loads(t[1]) == {"error": "lane w is draining (lame-duck)",
                                "kind": "overloaded"}
    jh, th = _health(jport), _health(tport)
    assert th["admission"] == jh["admission"]
    assert th["admission"]["draining"] and \
        th["admission"]["shed_draining"] == 1
    for action in ("undrain", "undrain"):
        j, t = _both(pair, "POST", "/admin/drain", {"action": action})
        assert j == t and j[0] == 200
        statuses.append(json.loads(t[1])["status"])
    assert statuses == ["draining", "already-draining", "undrained",
                        "not-draining"]
    assert json.loads(t[1]) == {"ok": True, "node_id": "w",
                                "draining": False, "status": "not-draining"}
    j, t = _both(pair, "POST", "/admin/drain", {"action": "pause"})
    assert j == t and j[0] == 400
    j, t = _both(pair, "POST", "/infer", {"request_id": "u",
                                          "input_data": [1.0]})
    assert j[0] == t[0] == 200  # other weights: only the status compares


@pytest.mark.parametrize("pair", [dict(max_queue_depth=1)], indirect=True)
def test_max_queue_depth_sheds_like_jax(pair):
    jw, jport, tw, tport = pair
    gate = threading.Event()
    _stub_dispatch(jw, jworker_mod, 1000, gate)
    _stub_dispatch(tw, tworker_mod, 1000, gate)
    held = {}

    def hold(name, port):
        held[name] = _call(port, "POST", "/infer", {"request_id": "h",
                                                    "input_data": [7.0]})

    threads = [threading.Thread(target=hold, args=a)
               for a in (("j", jport), ("t", tport))]
    for th in threads:
        th.start()
    try:
        for w in (jw, tw):
            for _ in range(400):
                if w._admission.depth == 1:
                    break
                time.sleep(0.01)
            assert w._admission.depth == 1
        j, t = _both(pair, "POST", "/infer", {"request_id": "over",
                                              "input_data": [8.0]})
        assert j == t and j[0] == 503
        assert json.loads(t[1]) == {"error": "lane w at max queue depth 1",
                                    "kind": "overloaded"}
    finally:
        gate.set()
        for th in threads:
            th.join(30)
    assert held["j"] == held["t"] and held["t"][0] == 200
    jh, th_ = _health(jport), _health(tport)
    assert th_["admission"] == jh["admission"]
    assert th_["admission"]["shed_overloaded"] == 1
    assert th_["admission"]["queue_depth"] == 0


def test_stream_holds_and_releases_its_slot():
    tw, tsrv = serve_worker(WorkerConfig(port=0, node_id="s", device="cpu",
                                         max_queue_depth=1, **GEN))
    body = {"request_id": "s", "prompt_tokens": [5, 9, 3],
            "max_new_tokens": 8}
    try:
        adm = tw._admission
        it = tw.handle_generate_stream(dict(body))
        assert adm.depth == 1  # admitted before the 200 commits
        with pytest.raises(Overloaded, match="max queue depth 1"):
            tw.handle_generate(dict(body))
        status, raw, _ = _call(tsrv.port, "POST", "/generate/stream", body)
        assert status == 503 and json.loads(raw)["kind"] == "overloaded"
        assert next(iter(it)).startswith(b"data: ")
        assert adm.depth == 1  # held while the stream runs
        it.close()  # the client went away mid-stream
        assert adm.depth == 0
        tw.handle_generate_stream(dict(body)).close()  # never started
        assert adm.depth == 0
        frames = list(tw.handle_generate_stream(dict(body)))
        assert json.loads(frames[-1][len(b"data: "):])["done"]
        assert adm.depth == 0
        # Over HTTP the server closes the events when the stream ends.
        status, raw, _ = _call(tsrv.port, "POST", "/generate/stream", body)
        assert status == 200 and b'"done": true' in raw
        assert _health(tsrv.port)["admission"]["queue_depth"] == 0
        assert _health(tsrv.port)["admission"]["shed_overloaded"] == 2
    finally:
        tsrv.stop()
        tw.stop()


def test_drain_reports_drain_pressure_like_jax():
    jw, jsrv = jax_serve_worker(JaxWorkerConfig(port=0, node_id="g", **GEN))
    tw, tsrv = serve_worker(WorkerConfig(port=0, node_id="g", device="cpu",
                                         **GEN))
    try:
        for w in (jw, tw):
            assert w.drain() == "draining"
        jg, tg = (_health(p)["generator"] for p in (jsrv.port, tsrv.port))
        assert jg["drain_pressure"] == tg["drain_pressure"] == 0.0
        for w in (jw, tw):
            assert w.undrain() == "undrained"
        jg, tg = (_health(p)["generator"] for p in (jsrv.port, tsrv.port))
        assert "drain_pressure" not in jg and "drain_pressure" not in tg
        assert _health(tsrv.port).get("admission") == \
            _health(jsrv.port).get("admission") is None
    finally:
        tsrv.stop()
        tw.stop()
        jsrv.stop()
        jw.stop()


def test_worker_routes_no_stats_like_jax(pair):
    j, t = _both(pair, "GET", "/stats")
    assert j[0] == t[0] == 404
