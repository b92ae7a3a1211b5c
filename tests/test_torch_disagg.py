"""Disaggregated prefill/decode serving in the port
(tpu_engine_torch: the scheduler's handoff holds, ``export_row
(wait_prefill=, cancel=)``, the worker's role and ``handoff`` fields, the
gateway's ``disagg``) against the JAX package's, on the CPU, on the same
weights: gpt2-small-test in f32, the JAX lane's parameters carried over
with ``models.convert.params_from_jax``.

- The scheduler: a handoff row parks after prefill and its export ships
  the first token only (no decode tick spent on the source), the import
  continues the stream byte-identically with zero re-prefilled tokens;
  a park that expires decodes locally; a cancel releases the hold; the
  ``handoff`` stats block is JAX's after the same operations.
- The gateway, port and JAX in turn in front of the same port lanes over
  HTTP (one prefill, two decode): a stream and a blocking /generate hand
  off from the prefill lane to a decode lane and equal the colocated
  run; the ``handoff`` block and its ``kv_handoff`` marker spans agree
  with JAX's and with each other; dead decode lanes fall back to the
  replay resume; a role flip rides drain and undrain, and a flip whose
  migration leg fails restores the lane; concurrent streams all splice;
  an int8 fleet hands its chains off verbatim; defaults (disagg off, an
  all-"both" fleet) keep /stats and /health unchanged.
- Across the packages over HTTP: a JAX prefill lane hands a stream to a
  port decode lane, and a port prefill lane to a JAX decode lane, each
  equal to the colocated run (both share the chain format).
"""

import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import _ensure_builtin_models_imported
from tpu_engine.serving.app import serve_worker as jax_serve_worker
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.serving.resilience import HandoffCounters as JaxCounters
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.serving.app import serve_gateway, serve_worker
from tpu_engine_torch.serving.app import worker_server
from tpu_engine_torch.serving.gateway import Gateway, _parse_sse
from tpu_engine_torch.serving.resilience import HandoffCounters
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

_ensure_builtin_models_imported()

REPO = Path(__file__).resolve().parent.parent

GEN_KW = dict(model="gpt2-small-test", dtype="float32", gen_step_chunk=2,
              gen_kv_block_size=16, gen_kv_blocks=40, gen_prefill_chunk=16,
              gen_max_batch_size=4)
PROMPT = [5, 9, 3, 17, 4, 22, 8]
LONG_PROMPT = list(range(2, 36))
ROLES = ("prefill", "decode", "decode")


def _wait(pred, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _leak_free(worker) -> bool:
    st = worker.generator.stats()
    kp = st["kv_pool"]
    return (st["active"] == 0
            and kp["blocks_free"] + kp["radix_nodes"] >= kp["blocks_total"])


class Fleet:
    """One JAX worker (the weights and the scheduler-level control) and
    port workers of ``roles`` served over HTTP on its weights."""

    def __init__(self, roles=ROLES, **extra):
        kw = dict(GEN_KW, **extra)
        self.jax = JaxWorkerNode(JaxWorkerConfig(node_id="j0", **kw))
        self.tparams = convert.params_from_jax(
            jax.tree.map(np.asarray, self.jax.engine.params),
            tcreate("gpt2-small-test").config, device="cpu")
        self.workers, self.servers = [], []
        for i, role in enumerate(roles):
            w, srv = serve_worker(WorkerConfig(
                port=0, node_id=f"t{i}", device="cpu", role=role, **kw),
                params=self.tparams)
            self.workers.append(w)
            self.servers.append(srv)
        self.urls = [f"127.0.0.1:{s.port}" for s in self.servers]

    def restart(self, i):
        """Serve worker i again on its port (after a stopped server)."""
        self.servers[i] = worker_server(self.workers[i],
                                        int(self.urls[i].split(":")[1]))
        self.servers[i].start(background=True)

    def stop(self):
        for srv in self.servers:
            srv.stop(drain_s=0)
        for w in self.workers:
            w.stop()
        self.jax.stop()


def JaxWorkerNode(cfg):
    from tpu_engine.serving.worker import WorkerNode as JaxWorker
    return JaxWorker(cfg)


@pytest.fixture(scope="module")
def fleet():
    f = Fleet()
    yield f
    f.stop()


@pytest.fixture(autouse=True)
def _heal(request):
    yield
    if "fleet" in request.fixturenames:
        f = request.getfixturevalue("fleet")
        for i, w in enumerate(f.workers):
            w.undrain()
            w.config.role = ROLES[i]


def consume(gw, req):
    toks, final = [], None
    for frame in gw.route_generate_stream(dict(req)):
        evt = _parse_sse(frame)
        if evt is None:
            continue
        if evt.get("done"):
            final = evt
            break
        toks.extend(evt.get("tokens", ()))
    return toks, final


def _spans(gw, op="kv_handoff"):
    return [s for s in gw.tracer.snapshot() if s["op"] == op]


def assert_counters_match_spans(gw):
    ho = gw.get_stats()["handoff"]
    spans = _spans(gw)
    for field in HandoffCounters.SPAN_FIELDS:
        n = sum(1 for s in spans if s["attrs"]["decision"] == field)
        assert n == ho[field], (field, ho, [s["attrs"] for s in spans])


def _gateways(urls, **kw):
    return [Gateway(list(urls), GatewayConfig(**kw)),
            JaxGateway(list(urls), JaxGatewayConfig(**kw))]


def _control(fleet, prompt, **kw):
    """The colocated stream: the JAX lane and the port's prefill lane
    agree on it."""
    body = {"request_id": "ctl", "prompt_tokens": prompt, **kw}
    want = fleet.jax.handle_generate(body)["tokens"]
    assert fleet.workers[0].handle_generate(body)["tokens"] == want
    return want


# -- counters and the scheduler's holds ---------------------------------------

def test_handoff_counters_schema_matches_jax():
    assert HandoffCounters.FIELDS == JaxCounters.FIELDS
    assert HandoffCounters.SPAN_FIELDS == JaxCounters.SPAN_FIELDS
    c = HandoffCounters()
    assert not c.any_nonzero()
    c.bump("tokens_handed_off", 5)
    assert c.as_dict()["tokens_handed_off"] == 5 and c.any_nonzero()
    assert "tokens_handed_off" not in HandoffCounters.SPAN_FIELDS


@pytest.mark.parametrize("dst_pkg", ["port", "jax"])
def test_hold_exports_the_first_token_only(fleet, dst_pkg):
    src = fleet.workers[0].generator
    dst = (fleet.workers[1].generator if dst_pkg == "port"
           else fleet.jax.generator)
    control = fleet.jax.generator.generate(
        [PROMPT], max_new_tokens=16, temperature=0.8, seed=13)[0]
    q: queue.Queue = queue.Queue()
    src.submit(PROMPT, max_new_tokens=16, temperature=0.8, seed=13,
               stream=q, tag=f"hx-{dst_pkg}", handoff=True,
               handoff_park_s=20.0)
    pre = dst.stats()["kv_pool"]["prefilled_tokens"]
    snap = src.export_row(f"hx-{dst_pkg}", timeout_s=30.0,
                          wait_prefill=True)
    assert snap["ok"], snap
    assert len(snap["emitted"]) == 1  # no decode tick on the source
    got = []
    while True:
        item = q.get(timeout=10)
        if item is None:
            break
        got.extend(item)
    assert got == snap["emitted"]
    q2: queue.Queue = queue.Queue()
    fut = dst.submit_import(snap, stream=q2, tag=f"hx2-{dst_pkg}")
    cont = []
    while True:
        item = q2.get(timeout=60)
        if item is None:
            break
        cont.extend(item)
    assert got + cont == control
    fut.result(timeout=10)
    assert dst.stats()["kv_pool"]["prefilled_tokens"] == pre
    ho = src.stats()["handoff"]
    assert ho["holds"] >= 1 and ho["held_rows"] == 0
    assert _wait(lambda: _leak_free(fleet.workers[0]))


def _hold_ops(gen, control_gen):
    """A park that expires and a cancelled hold, on ``gen``; returns the
    streams (each equal to the unparked run) and the handoff block."""
    base = dict(gen.stats().get("handoff") or {})
    want = control_gen.generate([PROMPT], max_new_tokens=8, seed=3)[0]
    got = gen.submit(PROMPT, max_new_tokens=8, seed=3, tag="pk",
                     handoff=True, handoff_park_s=0.4).result(timeout=120)
    fut = gen.submit(PROMPT, max_new_tokens=8, tag="cx", handoff=True,
                     handoff_park_s=30.0)
    assert _wait(lambda: gen.stats().get("handoff", {})
                 .get("held_rows", 0) > 0, timeout=30)
    resp = gen.export_row("cx", timeout_s=5.0, cancel=True)
    got2 = fut.result(timeout=120)
    pre = gen.export_row("never-admitted", timeout_s=5.0, cancel=True)
    ho = gen.stats()["handoff"]
    return ((got == want, got2 == control_gen.generate(
        [PROMPT], max_new_tokens=8)[0]), resp, pre,
        {k: ho[k] - base.get(k, 0) for k in ho})


def test_park_expiry_and_cancel_match_jax(fleet):
    port = _hold_ops(fleet.workers[0].generator, fleet.jax.generator)
    jax_ = _hold_ops(fleet.jax.generator, fleet.jax.generator)
    assert port == jax_
    assert port[0] == (True, True)
    assert port[1] == {"ok": False, "cancelled": True,
                       "reason": "handoff hold cancelled"}
    assert port[2]["cancelled"] is False
    assert port[3] == {"holds": 2, "park_expired": 1, "hold_cancelled": 1,
                       "held_rows": 0}


def test_flight_record_counts_held_rows_like_jax(fleet):
    """The flight recorder's ``held`` is the parked rows, in both
    packages: 1 while a handoff row waits, and no row parks outside a
    handoff request."""
    seen = []
    for gen in (fleet.workers[0].generator, fleet.jax.generator):
        gen.configure_flight_recorder(64)
        try:
            gen.generate([PROMPT], max_new_tokens=4)
            plain = [r["held"] for r in gen.flight_timeline()["timeline"]]
            fut = gen.submit(PROMPT, max_new_tokens=4, tag="fl",
                             handoff=True, handoff_park_s=30.0)
            assert _wait(lambda: any(r["held"] == 1 for r in
                                     gen.flight_timeline()["timeline"]))
            assert gen.export_row("fl", timeout_s=5.0,
                                  cancel=True)["cancelled"]
            fut.result(timeout=60)
            seen.append((set(plain), max(r["held"] for r in
                                         gen.flight_timeline()["timeline"])))
        finally:
            gen.configure_flight_recorder(0)
    assert seen[0] == seen[1] == ({0}, 1)


@pytest.mark.parametrize("opt", ["wait_prefill", "cancel", "handoff"])
def test_handoff_surfaces_answer_as_jax(fleet, opt):
    """/admin/migrate with wait_prefill or cancel and a /generate/stream
    with handoff, on a port worker and on the JAX worker."""
    outs = []
    for w in (fleet.workers[0], fleet.jax):
        if opt == "handoff":
            body = {"request_id": "hs", "prompt_tokens": PROMPT,
                    "max_new_tokens": 6, "handoff": True,
                    "handoff_park_ms": 200.0}
            frames = [json.loads(f[len(b"data: "):])
                      for f in w.handle_generate_stream(body)]
            outs.append((frames[-1]["tokens"],
                         w.generator.stats()["handoff"]["park_expired"]
                         >= 1))
        else:
            out = w.handle_migrate_export({"request_id": "nobody",
                                           opt: True, "timeout_s": 0.3})
            outs.append({k: v for k, v in out.items() if k != "node_id"})
    assert outs[0] == outs[1]
    if opt == "handoff":
        assert outs[0][1] is True
    elif opt == "wait_prefill":
        assert outs[0] == {"ok": False,
                           "reason": "no live row with this tag"}


# -- the gateway --------------------------------------------------------------

def test_stream_handoff_equals_colocated_and_jax(fleet):
    req = {"request_id": "d1", "prompt_tokens": LONG_PROMPT,
           "max_new_tokens": 12, "temperature": 0.9, "seed": 21}
    control = _control(fleet, LONG_PROMPT, max_new_tokens=12,
                       temperature=0.9, seed=21)
    results = []
    for gw in _gateways(fleet.urls, disagg=True, handoff_timeout_s=20.0):
        try:
            pre = [w.generator.stats()["kv_pool"]["prefilled_tokens"]
                   for w in fleet.workers[1:]]
            toks, final = consume(gw, req)
            post = [w.generator.stats()["kv_pool"]["prefilled_tokens"]
                    for w in fleet.workers[1:]]
            st = gw.get_stats()
            assert toks == control and final["tokens"] == control
            assert final["node_id"] in ("t1", "t2")  # a decode lane
            assert pre == post  # zero re-prefilled tokens on decode lanes
            assert len(_spans(gw)) == sum(
                st["handoff"][f] for f in HandoffCounters.SPAN_FIELDS)
            from tpu_engine_torch.utils.metrics import render_prometheus
            metrics = [ln for ln in render_prometheus([], st).splitlines()
                       if b"tpu_engine_handoff_" in ln]
            results.append((st["handoff"], metrics))
        finally:
            gw.stop()
    assert results[0] == results[1]
    ho, metrics = results[0]
    assert ho["handoffs_spliced"] == 1 and ho["prefill_routed"] == 1
    assert ho["handoff_fallbacks"] == 0
    assert b"tpu_engine_handoff_handoffs_spliced_total 1" in metrics
    assert _wait(lambda: all(_leak_free(w) for w in fleet.workers))


def test_greedy_and_blocking_generate_ride_the_handoff(fleet):
    control = _control(fleet, LONG_PROMPT, max_new_tokens=10)
    gw = Gateway(fleet.urls, GatewayConfig(disagg=True))
    try:
        toks, _ = consume(gw, {"request_id": "d2",
                               "prompt_tokens": LONG_PROMPT,
                               "max_new_tokens": 10})
        assert toks == control
        resp = gw.route_generate({"request_id": "d3",
                                  "prompt_tokens": LONG_PROMPT,
                                  "max_new_tokens": 10})
        assert resp["tokens"] == control
        assert resp["node_id"] in ("t1", "t2")
        assert gw.get_stats()["handoff"]["handoffs_spliced"] == 2
        assert_counters_match_spans(gw)
        assert _wait(lambda: all(_leak_free(w) for w in fleet.workers))
    finally:
        gw.stop()


def test_dead_decode_lane_falls_back_to_replay(fleet):
    """The only decode candidate is dead at the continuation's dispatch:
    the exported stream replays on the surviving lane (the prefill lane
    skipped), equal to the colocated run, the failure counted."""
    control = _control(fleet, LONG_PROMPT, max_new_tokens=10, seed=2)
    gw = Gateway(fleet.urls, GatewayConfig(disagg=True,
                                           handoff_timeout_s=10.0))
    try:
        fleet.servers[1].stop(drain_s=0)
        gw._handoff_candidates = lambda record, source: [fleet.urls[1]]
        toks, final = consume(gw, {"request_id": "d4",
                                   "prompt_tokens": LONG_PROMPT,
                                   "max_new_tokens": 10, "seed": 2})
        assert toks == control and "error" not in final, final
        assert final["resumed"] == 1 and final["node_id"] == "t2"
        ho = gw.get_stats()["handoff"]
        assert ho["handoffs_spliced"] == 0 and ho["dispatch_failed"] == 1
        assert gw.get_stats()["failover"]["resumes_succeeded"] == 1
        assert_counters_match_spans(gw)
    finally:
        fleet.restart(1)
        gw.stop()
    assert _wait(lambda: all(_leak_free(w) for w in fleet.workers))


def test_defaults_off_keep_stats_health_and_routing(fleet):
    for gw in _gateways(fleet.urls):
        try:
            assert "handoff" not in gw.get_stats()
            toks, _ = consume(gw, {"request_id": "p1",
                                   "prompt_tokens": PROMPT,
                                   "max_new_tokens": 6})
            assert len(toks) == 6 and "handoff" not in gw.get_stats()
        finally:
            gw.stop()
    # An all-"both" fleet with the flag on routes as without it.
    both = Fleet(roles=("both", "both"))
    try:
        gw = Gateway(both.urls, GatewayConfig(disagg=True))
        try:
            assert gw._disagg_split() is None
            consume(gw, {"request_id": "p2", "prompt_tokens": PROMPT,
                         "max_new_tokens": 4})
            ho = gw.get_stats()["handoff"]
            assert sum(ho[f] for f in HandoffCounters.FIELDS) == 0
        finally:
            gw.stop()
        h = both.workers[0].get_health()
        jh = both.jax.get_health()
        assert "role" not in h and "role" not in jh
        assert "handoff" not in h["generator"]
    finally:
        both.stop()
    assert fleet.workers[0].get_health()["role"] == "prefill"
    assert fleet.workers[1].get_health()["role"] == "decode"


def test_role_flip_over_the_gateway_route(fleet):
    gw, srv = serve_gateway(fleet.urls, GatewayConfig(port=0, disagg=True))
    from tpu_engine_torch.serving.clients import HttpWorkerClient
    client = HttpWorkerClient(f"127.0.0.1:{srv.port}")
    try:
        assert gw._disagg_split() is not None
        d2 = fleet.urls[2]
        r = client._request("POST", "/admin/role",
                            {"node": d2, "role": "prefill"})
        assert r == {"ok": True, "node_id": d2, "role": "prefill",
                     "drained": True}
        assert fleet.workers[2].config.role == "prefill"
        assert not fleet.workers[2].draining
        assert gw.worker_roles()[d2] == "prefill"
        assert d2 in gw._prefill_ring.get_all_nodes()
        # The routing follows the map: the only decode lane takes it.
        toks, final = consume(gw, {"request_id": "f1",
                                   "prompt_tokens": PROMPT,
                                   "max_new_tokens": 4})
        assert len(toks) == 4 and final["node_id"] == "t1"
        r = client._request("POST", "/admin/role",
                            {"node": d2, "role": "decode"})
        assert r["ok"] and d2 not in gw._prefill_ring.get_all_nodes()
        ho = gw.get_stats()["handoff"]
        assert ho["role_flips"] == 2
        assert ho["roles"] == dict(zip(fleet.urls, ROLES))
        with pytest.raises(ValueError):
            client._request("POST", "/admin/role",
                            {"node": d2, "role": "bogus"})
        with pytest.raises(ValueError):
            gw.set_worker_role("nobody:1", "both")
        assert_counters_match_spans(gw)
    finally:
        srv.stop()
        gw.stop()


def test_worker_set_role_refuses_as_jax(fleet):
    dense = WorkerNode(WorkerConfig(model="gpt2-small-test",
                                    dtype="float32", device="cpu"),
                       params=fleet.tparams)
    jdense = JaxWorkerNode(JaxWorkerConfig(model="gpt2-small-test",
                                           dtype="float32"))
    try:
        for bad in ("bogus", "prefill"):
            msgs = []
            for w in (dense, jdense):
                with pytest.raises(ValueError) as ei:
                    w.set_role(bad)
                msgs.append(str(ei.value))
            assert msgs[0] == msgs[1]
        assert dense.set_role("both") == {"ok": True, "node_id": "worker_1",
                                          "role": "both"}
    finally:
        dense.stop()
        jdense.stop()
    with pytest.raises(RuntimeError, match="--role prefill|decode"):
        WorkerNode(WorkerConfig(model="gpt2-small-test", device="cpu",
                                role="decode"), params=fleet.tparams)
    with pytest.raises(RuntimeError, match="--role must be"):
        WorkerNode(WorkerConfig(model="gpt2-small-test", device="cpu",
                                role="other"), params=fleet.tparams)


def test_role_flip_with_a_failed_migration_leg_restores_the_lane(fleet):
    gw = Gateway(fleet.urls, GatewayConfig(disagg=True,
                                           migrate_streams=True))
    try:
        def boom(name, client):
            raise RuntimeError("journal wedged")

        gw._migrate_lane_streams = boom
        r = gw.set_worker_role(fleet.urls[2], "prefill")
        assert r["ok"] is False and "migration leg failed" in r["error"]
        assert not fleet.workers[2].draining
        assert fleet.workers[2].config.role == "decode"
        assert gw.get_stats()["handoff"]["roles"][fleet.urls[2]] == "decode"
        assert gw._disagg_split() is not None
        toks, final = consume(gw, {"request_id": "rf1",
                                   "prompt_tokens": PROMPT,
                                   "max_new_tokens": 4})
        assert len(toks) == 4 and final["node_id"]
    finally:
        gw.stop()


def test_concurrent_handoffs_all_splice(fleet):
    control = {i: fleet.jax.generator.generate(
        [LONG_PROMPT + [40 + i]], max_new_tokens=8, temperature=0.7,
        seed=i)[0] for i in range(6)}
    gw = Gateway(fleet.urls, GatewayConfig(disagg=True,
                                           handoff_timeout_s=20.0))
    results = {}
    try:
        def run(i):
            results[i] = consume(gw, {
                "request_id": f"c{i}", "prompt_tokens": LONG_PROMPT
                + [40 + i], "max_new_tokens": 8, "temperature": 0.7,
                "seed": i})[0]
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert results == control
        ho = gw.get_stats()["handoff"]
        assert ho["handoffs_attempted"] == 6
        assert (ho["handoffs_spliced"] + ho["handoff_fallbacks"]
                + ho["export_refusals"] + ho["dispatch_failed"]
                + ho["destination_unavailable"]) == 6
        assert_counters_match_spans(gw)
        assert _wait(lambda: all(_leak_free(w) for w in fleet.workers),
                     timeout=30)
    finally:
        gw.stop()


def test_int8_fleet_hands_off_verbatim():
    f = Fleet(roles=("prefill", "decode"), gen_kv_quantize="int8")
    gw = Gateway(f.urls, GatewayConfig(disagg=True, handoff_timeout_s=20.0))
    try:
        control = f.workers[0].generator.generate(
            [LONG_PROMPT], max_new_tokens=10, seed=5)[0]
        assert control == f.jax.generator.generate(
            [LONG_PROMPT], max_new_tokens=10, seed=5)[0]
        pre = f.workers[1].generator.stats()["kv_pool"]["prefilled_tokens"]
        toks, _ = consume(gw, {"request_id": "q1",
                               "prompt_tokens": LONG_PROMPT,
                               "max_new_tokens": 10, "seed": 5})
        assert toks == control
        assert gw.get_stats()["handoff"]["handoffs_spliced"] == 1
        dst = f.workers[1].generator.stats()
        assert dst["migration"]["imported_rows"] == 1
        assert dst["kv_pool"]["prefilled_tokens"] == pre
        assert _wait(lambda: all(_leak_free(w) for w in f.workers))
    finally:
        gw.stop()
        f.stop()


@pytest.mark.parametrize("prefill_pkg", ["jax", "port"])
def test_cross_package_handoff_over_http(fleet, prefill_pkg):
    """The port's gateway hands a stream from a JAX prefill lane to a port
    decode lane, and from a port prefill lane to a JAX decode lane."""
    jw, jsrv = jax_serve_worker(JaxWorkerConfig(
        port=0, node_id="jx", role="decode" if prefill_pkg == "port"
        else "prefill", **GEN_KW), background=True)
    jw.apply_weights(fleet.jax.engine.params)
    jurl = f"127.0.0.1:{jsrv.port}"
    port_url = fleet.urls[0] if prefill_pkg == "port" else fleet.urls[1]
    urls = [jurl, port_url] if prefill_pkg == "jax" else [port_url, jurl]
    gw = Gateway(urls, GatewayConfig(disagg=True, handoff_timeout_s=20.0))
    try:
        control = _control(fleet, LONG_PROMPT, max_new_tokens=10, seed=9,
                           temperature=0.6)
        toks, final = consume(gw, {"request_id": f"x-{prefill_pkg}",
                                   "prompt_tokens": LONG_PROMPT,
                                   "max_new_tokens": 10, "seed": 9,
                                   "temperature": 0.6})
        assert toks == control and "error" not in final
        assert final["node_id"] == ("jx" if prefill_pkg == "port"
                                    else "t1")
        assert gw.get_stats()["handoff"]["handoffs_spliced"] == 1
        assert_counters_match_spans(gw)
    finally:
        gw.stop()
        jsrv.stop()
        jw.stop()


def test_handoff_family_subprocess_imports_no_jax():
    """A prefill and a decode lane with prefix fetch behind a gateway with
    all four features, in a process of their own: a handed-off stream,
    and neither jax nor the JAX package in its sys.modules."""
    code = (
        "import json, sys\n"
        "from tpu_engine_torch.serving.app import serve_worker\n"
        "from tpu_engine_torch.serving.gateway import Gateway\n"
        "from tpu_engine_torch.utils.config import WorkerConfig,"
        " GatewayConfig\n"
        "ws = [serve_worker(WorkerConfig(port=0, node_id=f'w{i}',"
        " model='gpt2-small-test', dtype='float32', device='cpu',"
        " gen_kv_block_size=16, gen_prefill_chunk=16, role=r,"
        " gen_prefix_fetch=True)) for i, r in"
        " enumerate(('prefill', 'decode'))]\n"
        "ws[1][0].apply_weights(ws[0][0].generator.params)\n"
        "g = Gateway([f'127.0.0.1:{s.port}' for _, s in ws], GatewayConfig("
        "disagg=True, migrate_streams=True, prefix_affinity=True,"
        " prefix_directory=True))\n"
        "out = g.route_generate({'request_id': 'a', 'prompt_tokens':"
        " list(range(2, 36)), 'max_new_tokens': 4})\n"
        "st = g.get_stats()\n"
        "g.stop()\n"
        "for w, s in ws:\n"
        "    s.stop(); w.stop()\n"
        "need = ['tpu_engine_torch.serving.prefix_directory']\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'n': len(out['tokens']), 'node': out['node_id'],"
        " 'spliced': st['handoff']['handoffs_spliced'],"
        " 'missing': [m for m in need if m not in sys.modules],"
        " 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "n": 4, "node": "w1", "spliced": 1, "missing": [], "bad": []}
