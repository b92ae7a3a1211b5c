"""The port's Prometheus exposition (tpu_engine_torch.utils.metrics)
against the JAX package's (tpu_engine.utils.metrics), on the same inputs:

- ``LatencyHistogram`` snapshots after the same seeded observations, and
  the stage and named histogram families rendered from them;
- ``render_prometheus`` over the same health, stats and histograms, byte
  for byte: a health and a gateway stats dict that carry every block the
  renderer reads (every family it can emit), the reference's plain lane
  and gateway, and label escaping;
- a port worker's /metrics over HTTP: the text content type, and every
  line parses as a Prometheus sample.
All comparisons are exact."""

import http.client
import json
import re

import numpy as np
import pytest

from tpu_engine.utils import metrics as jm
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.utils import metrics as tm
from tpu_engine_torch.utils.config import WorkerConfig

# The keys whose values are blocks (set per block in _kitchen_sink).
_BLOCKS = {"generator", "kv_pool", "state_pool", "host", "mixed", "spec",
           "migration", "handoff", "admission", "adaptive", "brownout",
           "batch_processor", "resilience", "failover", "affinity",
           "prefix_directory", "overload", "fleet", "slo",
           "circuit_breakers", "objectives", "roles", "degraded",
           "ejected_lanes", "assigned"}
# Every other quoted identifier of the JAX renderer: the leaf keys it may
# read.
_KEYS = sorted(set(re.findall(
    r'"([a-z][a-z0-9_]*)"', open(jm.__file__).read())) - _BLOCKS)


def _fill(rng, **over):
    """A block holding every key the renderer may read, with seeded
    numbers, then ``over``."""
    out = {}
    for k in _KEYS:
        out[k] = (int(rng.integers(0, 5000)) if rng.random() < 0.7
                  else round(float(rng.random()), 4))
    out.update(over)
    return out


def _kitchen_sink(seed):
    """(healths, stats) carrying every block render_prometheus reads."""
    rng = np.random.default_rng(seed)
    f = lambda **kw: _fill(rng, **kw)  # noqa: E731
    gen = f(kv_pool=f(host=f(), quantized="int8"), state_pool=f(),
            mixed=f(), spec=f(lane="continuous"), migration=f(),
            handoff=f(), model="gpt2")
    healths = [
        f(node_id="w1", healthy=True, generator=gen,
          batch_processor=f(), admission=f(draining=True,
                                            adaptive=f()),
          brownout=f()),
        f(node_id='w"2\\', healthy=False, batch_processor={},
          generator=f(kv_pool=f(host=None, quantized=None), spec=f())),
        f(node_id="w3", healthy=True),
    ]
    stats = f(
        circuit_breakers=[f(node="a:1", state="OPEN"),
                          f(node="b:2", state="HALF_OPEN"),
                          f(node="c:3", state="CLOSED")],
        resilience=f(), failover=f(ejected_lanes=["b:2"]), migration=f(),
        handoff=f(roles={"a:1": "prefill", "b:2": "decode"}),
        affinity=f(assigned={"a:1": 7, "c:3": 2}), prefix_directory=f(lanes={"a:1": 3, "b:2": 1}),
        overload=f(tenants=4), fleet=f(degraded={"a:1": "wedged"}),
        slo=f(target=0.99, objectives={
            "ttft": f(), "itl": f(good_fraction=None),
            "completion": f()}))
    return healths, stats


def _hists(mod, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for node in ("w1", "w2"):
        for op in ("queue_wait", "device_compute", "mixed_step"):
            h = mod.LatencyHistogram()
            for v in rng.exponential(0.01, size=int(rng.integers(0, 40))):
                h.observe(float(v))
            out.setdefault(node, {})[op] = h
    return out


class _Rec:
    def __init__(self, hists):
        self._h = hists

    def histograms(self):
        return self._h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_snapshots_equal_jax(seed):
    j, t = _hists(jm, seed), _hists(tm, seed)
    for node in j:
        for op in j[node]:
            assert t[node][op].snapshot() == j[node][op].snapshot()
    bounds = (0.001, 0.01, 0.1)
    jh, th = jm.LatencyHistogram(bounds), tm.LatencyHistogram(bounds)
    for v in (0.0005, 0.001, 0.005, 0.05, 0.5):
        jh.observe(v)
        th.observe(v)
    assert th.snapshot() == jh.snapshot()
    assert th.snapshot()["cumulative"] == [2, 3, 4]


@pytest.mark.parametrize("seed", [0, 3])
def test_stage_and_named_histograms_render_like_jax(seed):
    j, t = _hists(jm, seed), _hists(tm, seed)
    jrec = {n: _Rec(h) for n, h in j.items()}
    trec = {n: _Rec(h) for n, h in t.items()}
    assert tm.render_stage_histograms(trec) == \
        jm.render_stage_histograms(jrec)
    jn = {"tpu_engine_ttft_seconds": {n: h["queue_wait"]
                                      for n, h in j.items()},
          "tpu_engine_itl_seconds": {n: h["device_compute"]
                                     for n, h in j.items()}}
    tn = {"tpu_engine_ttft_seconds": {n: h["queue_wait"]
                                      for n, h in t.items()},
          "tpu_engine_itl_seconds": {n: h["device_compute"]
                                     for n, h in t.items()}}
    assert tm.render_named_histograms(tn, tm._NAMED_HIST_HELP) == \
        jm.render_named_histograms(jn, jm._NAMED_HIST_HELP)


def _names(text: str):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_render_prometheus_is_jax_bytes(seed):
    healths, stats = _kitchen_sink(seed)
    j, t = _hists(jm, seed), _hists(tm, seed)
    jrec = {n: _Rec(h) for n, h in j.items()}
    trec = {n: _Rec(h) for n, h in t.items()}
    jn = {"tpu_engine_ttft_seconds": {"w1": j["w1"]["queue_wait"]}}
    tn = {"tpu_engine_ttft_seconds": {"w1": t["w1"]["queue_wait"]}}
    want = jm.render_prometheus(healths, stats, recorders=jrec,
                                named_hists=jn)
    got = tm.render_prometheus(healths, stats, recorders=trec,
                               named_hists=tn)
    assert got == want
    names = _names(got.decode())
    # Every family the renderer has, tpu_engine_spec_* among them.
    assert len(names) >= 111
    assert {n for n in names if n.startswith("tpu_engine_spec_")} == {
        "tpu_engine_spec_k", "tpu_engine_spec_dispatches_total",
        "tpu_engine_spec_proposed_tokens_total",
        "tpu_engine_spec_accepted_tokens_total",
        "tpu_engine_spec_emitted_tokens_total",
        "tpu_engine_spec_accept_ratio",
        "tpu_engine_spec_tokens_per_dispatch",
        "tpu_engine_spec_tokens_per_row_dispatch"}


@pytest.mark.parametrize("case", ["lane", "gateway", "escaping", "empty"])
def test_reference_shapes_render_like_jax(case):
    health = {"healthy": True, "node_id": "w1", "total_requests": 42,
              "cache_hits": 40, "cache_size": 7, "cache_hit_rate": 0.952,
              "batch_processor": {"total_batches": 5, "timeout_batches": 2,
                                  "full_batches": 3, "avg_batch_size": 6.4}}
    stats = {"total_workers": 2, "total_requests": 10, "failovers": 1,
             "circuit_breakers": [
                 {"node": "a:1", "state": "CLOSED", "failures": 0,
                  "successes": 4},
                 {"node": "b:2", "state": "OPEN", "failures": 5,
                  "successes": 0}]}
    args = {"lane": ([health],),
            "gateway": ([], stats),
            "escaping": ([dict(health, node_id='w"x\\y', healthy=False,
                               batch_processor={})],),
            "empty": ([],)}[case]
    assert tm.render_prometheus(*args) == jm.render_prometheus(*args)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        if path.startswith("POST "):
            conn.request("POST", path[5:], json.dumps(
                {"request_id": "m1", "input_data": [1.0, 2.0]}))
        else:
            conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


_SAMPLE = re.compile(r'^[a-z_:][a-z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+$|'
                     r'^[a-z_:][a-z0-9_:]*(\{[^}]*\})? (NaN|[+-]Inf)$')


def test_worker_metrics_over_http_parse():
    w, srv = serve_worker(WorkerConfig(port=0, node_id="mw", model="mlp",
                                       dtype="float32", device="cpu"))
    try:
        assert _get(srv.port, "POST /infer")[0] == 200
        status, ctype, body = _get(srv.port, "/metrics")
        assert status == 200 and ctype == "text/plain; version=0.0.4"
        text = body.decode()
        assert 'tpu_engine_requests_total{node="mw"} 1' in text
        for ln in text.splitlines():
            assert ln.startswith("# ") or _SAMPLE.match(ln), ln
        assert 'stage="device_compute"' in text
    finally:
        srv.stop()
        w.stop()
