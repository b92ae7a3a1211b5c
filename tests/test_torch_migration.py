"""Live-row migration in the port (tpu_engine_torch.runtime.scheduler
``export_row`` / ``submit_import``; the worker's ``/admin/migrate`` and
``/generate/stream`` with ``migrate_import``) against the JAX package's,
on the CPU, with the same weights:

- round trips port -> port, JAX -> port and port -> JAX, on a mixed, a
  two-path, an int8 (two-path) and an n-gram ``spec_k`` lane: a row
  exported mid-stream continues on the other lane token for token as the
  uninterrupted run, with zero re-prefilled tokens, both through the
  schedulers and through the workers (the port's over its HTTP server,
  the JAX worker's handlers in process);
- refusals: a dense lane (JAX's answer), a row mid-prefill, an unknown
  tag and a finished row, each by name;
- retryable ``ImportRefused`` for a bad checksum, another geometry and a
  pool that cannot keep the live-row reserve, with no block leaked;
- a radix re-adoption ships only the chain's unmatched tail;
- the ``migration`` stats block and the terminal SSE events carry the JAX
  keys (less ``trace_id``: tracing is not ported);
- the gateway's migrate-mode drain (``migrate_streams``), port and JAX in
  turn in front of three port lanes over HTTP: a drained lane's stream
  continues on another lane byte-identically with nothing replayed, the
  ``migration`` block agreeing with JAX's; its three replay fallbacks
  (a corrupted transfer, a dead destination, a transfer past its
  budget); a drain during a failover; the bounded drain call; and the
  defaults.
"""

import base64
import contextlib
import http.client
import json
import queue
import threading
import time

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import _ensure_builtin_models_imported
from tpu_engine.runtime.scheduler import ImportRefused as JaxImportRefused
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.scheduler import (
    ContinuousGenerator,
    ImportRefused,
    StreamMigratedAway,
)
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.serving.gateway import Gateway, _parse_sse
from tpu_engine_torch.serving.resilience import MigrationCounters
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

_ensure_builtin_models_imported()

BASE = dict(model="gpt2-small-test", dtype="float32", gen_step_chunk=2,
            gen_kv_block_size=16, gen_kv_blocks=40, gen_prefill_chunk=16,
            gen_max_batch_size=4)
MODES = {
    "mixed": dict(gen_mixed_step=True, gen_mixed_token_budget=16),
    "two-path": {},
    "int8": dict(gen_kv_quantize="int8"),
    "spec-ngram": dict(gen_mixed_step=True, gen_mixed_token_budget=16,
                       gen_continuous_spec_k=3),
}
PROMPT = [5, 9, 3, 17, 4, 22, 8, 5, 9, 3, 17, 4, 30, 31, 2, 7, 5, 9, 3, 17]
MAX_NEW = 36   # gpt2-small-test's max_seq is 64
DIRECTIONS = ("port_to_port", "jax_to_port", "port_to_jax")


@pytest.fixture(scope="module")
def fleets():
    """fleets(mode): one JAX worker and two port workers (served over
    HTTP) of one lane mode, on the JAX worker's weights; made at first
    use, stopped with the module."""
    made, stop = {}, []

    def get(mode):
        if mode not in made:
            kw = dict(BASE, **MODES[mode])
            jw = JaxWorker(JaxWorkerConfig(node_id="j0", **kw))
            stop.append(jw.stop)
            tparams = convert.params_from_jax(
                jax.tree.map(np.asarray, jw.engine.params),
                tcreate("gpt2-small-test").config, device="cpu")
            ports = []
            for i in range(2):
                w, srv = serve_worker(WorkerConfig(
                    port=0, node_id=f"t{i}", device="cpu", **kw),
                    params=tparams)
                stop.extend([w.stop, srv.stop])
                ports.append((w, srv.port))
            made[mode] = {"mode": mode, "jax": jw,
                          "port": [w for w, _ in ports],
                          "http": [p for _, p in ports], "tparams": tparams}
        return made[mode]

    yield get
    for fn in reversed(stop):
        fn()


def _wait(pred, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _leak_free(gen) -> bool:
    st = gen.stats()
    kp = st["kv_pool"]
    return (st["active"] == 0
            and kp["blocks_free"] + kp["radix_nodes"] >= kp["blocks_total"])


def _control(fleet):
    """The uninterrupted greedy run, on the JAX lane and on a port lane
    (they agree), alone."""
    body = {"request_id": "ctl", "prompt_tokens": PROMPT,
            "max_new_tokens": MAX_NEW}
    want = fleet["jax"].handle_generate(body)["tokens"]
    assert fleet["port"][0].handle_generate(body)["tokens"] == want
    return want


def _gens(fleet, direction):
    j, (a, b) = fleet["jax"].generator, (w.generator for w in fleet["port"])
    return {"port_to_port": (a, b), "jax_to_port": (j, a),
            "port_to_jax": (a, j)}[direction]


def _collect(q, got):
    while True:
        item = q.get(timeout=60)
        if item is None:
            return got
        got.extend(item)


def _export_mid_stream(src, tag, min_tokens=3):
    q: queue.Queue = queue.Queue()
    fut = src.submit(PROMPT, max_new_tokens=MAX_NEW, stream=q, tag=tag)
    got = []
    while len(got) < min_tokens:
        item = q.get(timeout=60)
        assert item is not None, got
        got.extend(item)
    snap = src.export_row(tag)
    assert snap["ok"], snap
    _collect(q, got)  # the flush before the terminal
    with pytest.raises(Exception) as ei:
        fut.result(timeout=10)
    assert ei.value.retryable and ei.value.migrated
    assert ei.value.tokens_emitted == len(got) == snap["streamed"]
    return snap, got


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_round_trip_continues_the_stream(fleets, mode, direction):
    fleet = fleets(mode)
    want = _control(fleet)
    src, dst = _gens(fleet, direction)
    pre = dst.stats()["kv_pool"]["prefilled_tokens"]
    snap, got = _export_mid_stream(src, f"s-{direction}")
    q2: queue.Queue = queue.Queue()
    fut2 = dst.submit_import(snap, stream=q2, tag=f"s-{direction}-b")
    cont = _collect(q2, [])
    assert got + cont == want
    assert fut2.result(timeout=10) == want
    assert dst.stats()["kv_pool"]["prefilled_tokens"] == pre
    assert dst.stats()["migration"]["imported_rows"] >= 1
    assert src.stats()["migration"]["exported_rows"] >= 1
    assert _wait(lambda: _leak_free(src) and _leak_free(dst))


def _http_events(port, body):
    """The event dicts of a /generate/stream on the port's server, as they
    arrive."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/generate/stream", json.dumps(body))
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        buf = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                return
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                yield json.loads(frame[len(b"data: "):])
    finally:
        conn.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _jax_events(jw, body):
    for frame in jw.handle_generate_stream(body):
        yield json.loads(frame[len(b"data: "):])


def _worker_side(fleet, name):
    """(open a stream, /admin/migrate) on the port's HTTP server (t0 or
    t1) or on the JAX worker in process."""
    if name == "jax":
        jw = fleet["jax"]
        return (lambda body: _jax_events(jw, body),
                lambda body: jw.handle_migrate_export(body))
    port = fleet["http"][int(name[-1])]
    return (lambda body: _http_events(port, body),
            lambda body: _post(port, "/admin/migrate", body)[1])


def _run_stream(events, on_tokens=None, min_tokens=3):
    toks, final, fired = [], None, False
    for ev in events:  # read to the end: the server ends the response
        if ev.get("done"):
            final = ev
            continue
        toks.extend(ev["tokens"])
        if on_tokens is not None and not fired and len(toks) >= min_tokens:
            fired = True
            on_tokens()
    return toks, final


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("mode", list(MODES))
def test_worker_admin_migrate_then_migrate_import(fleets, mode, direction):
    fleet = fleets(mode)
    want = _control(fleet)
    src_name, dst_name = {"port_to_port": ("t0", "t1"),
                          "jax_to_port": ("jax", "t0"),
                          "port_to_jax": ("t0", "jax")}[direction]
    src_open, src_migrate = _worker_side(fleet, src_name)
    dst_open, _ = _worker_side(fleet, dst_name)
    rid = f"w-{direction}"
    snap = {}

    def migrate():
        snap.update(src_migrate({"request_id": rid}))

    got, final = _run_stream(src_open({"request_id": rid,
                                       "prompt_tokens": PROMPT,
                                       "max_new_tokens": MAX_NEW}),
                             on_tokens=migrate)
    assert snap["ok"], snap
    assert final["migrated"] is True and final["retryable"] is True
    assert final["tokens_emitted"] == len(got) == snap["streamed"]
    dst_gen = (fleet["jax"].generator if dst_name == "jax"
               else fleet["port"][int(dst_name[-1])].generator)
    pre = dst_gen.stats()["kv_pool"]["prefilled_tokens"]
    cont, done = _run_stream(dst_open({"request_id": rid + "-b",
                                       "prompt_tokens": [],
                                       "migrate_import": snap}))
    assert got + cont == want
    assert done["tokens"] == want and "error" not in done
    assert dst_gen.stats()["kv_pool"]["prefilled_tokens"] == pre
    for w in fleet["port"]:
        assert _wait(lambda: _leak_free(w.generator))


# -- refusals -----------------------------------------------------------------

def test_dense_lane_refuses_as_jax(fleets):
    fleet = fleets("mixed")
    kw = dict(model="gpt2-small-test", dtype="float32")
    tw = WorkerNode(WorkerConfig(device="cpu", **kw),
                    params=fleet["tparams"])
    jw = JaxWorker(JaxWorkerConfig(**kw))
    try:
        outs = [w.handle_migrate_export({"request_id": "r"})
                for w in (tw, jw)]
        assert outs[0] == dict(outs[1], node_id=tw.node_id)
        assert outs[0] == {"ok": False, "node_id": tw.node_id,
                           "reason": "migration requires the paged KV "
                                     "cache"}
        for w in (tw, jw):
            with pytest.raises(ValueError, match="requires the paged KV"):
                w.generator.submit_import({"chain": {}})
        with pytest.raises(ValueError, match="request_id is required"):
            tw.handle_migrate_export({})
    finally:
        tw.stop()
        jw.stop()


def test_mid_prefill_unknown_and_finished_rows_refuse(fleets):
    fleet = fleets("mixed")
    spec = tcreate("gpt2-small-test", max_seq=128)
    # One prompt token a tick: a long prompt stays mid-prefill for ~100
    # ticks once admitted.
    g = ContinuousGenerator(spec, params=fleet["tparams"], device="cpu",
                            dtype="float32", n_slots=2, max_seq=128,
                            kv_block_size=16, mixed_step=True,
                            mixed_token_budget=1, prefill_chunk=1)
    try:
        fut = g.submit(list(range(1, 101)), max_new_tokens=4, tag="long")
        assert _wait(lambda: g.stats()["active"] == 1)
        out = g.export_row("long")
        assert out == {"ok": False, "reason": "row is mid-prefill"}
        assert g.stats()["migration"]["export_refused"] == 1
        fut.cancel()
        assert g.export_row("nope") == {
            "ok": False, "reason": "no live row with this tag"}
        done = g.submit([5, 9, 3], max_new_tokens=2, tag="done")
        done.result(timeout=60)
        assert g.export_row("done")["reason"] == "no live row with this tag"
        assert _wait(lambda: _leak_free(g))
    finally:
        g.stop()
    jg = fleet["jax"].generator
    assert jg.export_row("nope", timeout_s=5.0) == {
        "ok": False, "reason": "no live row with this tag"}


# -- retryable import refusals ------------------------------------------------

def _snapshot(fleet, tag):
    snap, _ = _export_mid_stream(fleet["port"][0].generator, tag)
    return snap


def _refused(gen, snap, match, tag):
    fut = gen.submit_import(snap, tag=tag)
    with pytest.raises(ImportRefused, match=match) as ei:
        fut.result(timeout=60)
    assert ei.value.retryable and ei.value.import_refused
    assert gen.stats()["migration"]["import_rejected"] >= 1


@pytest.mark.parametrize("mode", ["two-path", "int8"])
def test_bad_checksum_is_retryable_and_clean(fleets, mode):
    fleet = fleets(mode)
    snap = _snapshot(fleet, "cksum")
    raw = bytearray(base64.b64decode(snap["chain"]["blocks"][0]["k"]))
    raw[0] ^= 0xFF
    snap["chain"]["blocks"][0]["k"] = base64.b64encode(bytes(raw)).decode()
    dst = fleet["port"][1].generator
    free0 = dst.stats()["kv_pool"]["blocks_free"]
    _refused(dst, snap, "checksum", "cksum-b")
    assert dst.stats()["kv_pool"]["blocks_free"] == free0
    # The same snapshot over the wire: a 200 stream whose terminal event
    # is retryable and marked import_refused, as the JAX worker's is.
    events = []
    for w in (fleet["http"][1], fleet["jax"]):
        body = {"request_id": "ck-w", "prompt_tokens": [],
                "migrate_import": snap}
        evs = (_http_events(w, body) if isinstance(w, int)
               else _jax_events(w, body))
        _, final = _run_stream(evs)
        assert final["import_refused"] is True and final["retryable"]
        events.append(final)
    assert set(events[0]) == set(events[1])
    assert _wait(lambda: _leak_free(dst))


def test_geometry_mismatch_and_reserve_refuse_without_leaks(fleets):
    fleet = fleets("two-path")
    snap = _snapshot(fleet, "geo")
    spec = tcreate("gpt2-small-test")
    other = ContinuousGenerator(spec, params=fleet["tparams"], device="cpu",
                                dtype="float32", n_slots=2, step_chunk=2,
                                prefill_chunk=16, kv_block_size=8,
                                kv_blocks=20)
    try:
        _refused(other, snap, "block_size", "geo-b")
        assert _leak_free(other)
    finally:
        other.stop()
    tiny = ContinuousGenerator(spec, params=fleet["tparams"], device="cpu",
                               dtype="float32", n_slots=2, step_chunk=2,
                               prefill_chunk=16, kv_block_size=16,
                               kv_blocks=5)  # 4 usable blocks
    try:
        ql: queue.Queue = queue.Queue()
        occupant = tiny.submit([1, 2, 3, 4] * 8, max_new_tokens=30,
                               stream=ql, tag="occupant")
        while not ql.get(timeout=60):
            pass
        _refused(tiny, snap, "refused", "full-b")
        occupant.result(timeout=60)
        assert _wait(lambda: _leak_free(tiny))
    finally:
        tiny.stop()
    # The JAX lane refuses the same chain the same way.
    jw = JaxWorker(JaxWorkerConfig(node_id="j8", **dict(
        BASE, gen_kv_block_size=8)))
    try:
        with pytest.raises(JaxImportRefused, match="block_size"):
            jw.generator.submit_import(snap, tag="geo-j").result(timeout=60)
    finally:
        jw.stop()


def test_zero_block_chain_refused_before_allocation(fleets):
    fleet = fleets("mixed")
    snap = _snapshot(fleet, "zb")
    dst = fleet["port"][1].generator
    free0 = dst.stats()["kv_pool"]["blocks_free"]
    empty = dict(snap["chain"], blocks=[], checksum=0)
    _refused(dst, dict(snap, chain=empty), "holds 0 blocks", "zb-b")
    _refused(dst, dict(snap, chain="garbage"), "no block chain", "zb-c")
    assert dst.stats()["kv_pool"]["blocks_free"] == free0


@pytest.mark.parametrize("mode", ["mixed", "two-path"])
def test_radix_readopt_ships_only_the_tail(fleets, mode):
    fleet = fleets(mode)
    shared = [(j * 13) % 90 + 1 for j in range(32)]   # two full blocks
    a, b = (w.generator for w in fleet["port"])
    b.generate([shared + [2]], max_new_tokens=2)       # warm b's radix
    want = fleet["jax"].generator.generate([shared + [5]],
                                           max_new_tokens=16)[0]
    q: queue.Queue = queue.Queue()
    a.submit(shared + [5], max_new_tokens=16, stream=q, tag="ra")
    got = []
    while len(got) < 3:
        got.extend(q.get(timeout=60) or [])
    snap = a.export_row("ra")
    assert snap["ok"], snap
    _collect(q, got)
    hits0 = b.stats()["kv_pool"]["radix_hits"]
    mig0 = b.stats().get("migration", {}).get("imported_chain_tokens", 0)
    q2: queue.Queue = queue.Queue()
    fut2 = b.submit_import(snap, stream=q2, tag="ra-b")
    assert got + _collect(q2, []) == want == fut2.result(timeout=10)
    st = b.stats()
    assert st["kv_pool"]["radix_hits"] > hits0
    shipped = st["migration"]["imported_chain_tokens"] - mig0
    assert 0 < shipped <= len(snap["chain"]["blocks"]) * 16 - 32


# -- schemas ------------------------------------------------------------------

def test_migration_block_and_health_schema(fleets):
    fleet = fleets("spec-ngram")
    port_gen = fleet["port"][0].generator
    jax_gen = fleet["jax"].generator
    for g in (port_gen, jax_gen):
        _export_mid_stream(g, "schema")
    tkeys = set(port_gen.stats()["migration"])
    assert tkeys == set(jax_gen.stats()["migration"])
    assert "migration" in fleet["port"][0].get_health()["generator"]
    fresh = fleet["port"][1].generator
    if "migration" not in fresh.stats():
        assert "migration" not in fleet["port"][1].get_health()["generator"]
    assert isinstance(StreamMigratedAway("x", 1), RuntimeError)


# -- the gateway's migrate-mode drain -----------------------------------------

DRAIN_PROMPT = [5, 9, 3, 17, 4, 22, 8]


@pytest.fixture(scope="module")
def lanes3(fleets):
    """Three port lanes (two-path) over HTTP on the JAX lane's weights;
    node ids t0..t2, named on the gateways by their URLs."""
    fleet = fleets("two-path")
    kw = dict(BASE, **MODES["two-path"])
    made = [serve_worker(WorkerConfig(port=0, node_id=f"t{i}", device="cpu",
                                      **kw), params=fleet["tparams"])
            for i in range(3)]
    yield {"workers": [w for w, _ in made],
           "urls": [f"127.0.0.1:{s.port}" for _, s in made],
           "jax": fleet["jax"]}
    for w, srv in made:
        srv.stop(drain_s=0)
        w.stop()


@pytest.fixture(autouse=True)
def _undrain(request):
    yield
    if "lanes3" in request.fixturenames:
        for w in request.getfixturevalue("lanes3")["workers"]:
            w.undrain()


@contextlib.contextmanager
def _slowed(workers, s=0.03):
    """Each decode chunk of ``workers`` sleeps ``s`` first, so a drain
    finds the stream still running on the CPU."""
    saved = []
    for w in workers:
        gen = w.generator
        orig = gen._decode_chunk

        def slow(orig=orig):
            time.sleep(s)
            orig()
        gen._decode_chunk = slow
        saved.append((gen, orig))
    try:
        yield
    finally:
        for gen, orig in saved:
            gen._decode_chunk = orig


def _gw(cls, cfg_cls, urls, **kw):
    kw.setdefault("failover_streams", True)
    kw.setdefault("migrate_streams", True)
    kw.setdefault("migrate_timeout_s", 20.0)
    return cls(list(urls), cfg_cls(**kw))


def _rid_for(gw, lane, tag):
    return next(f"{tag}{i}" for i in range(2000)
                if gw._ring.get_node(f"{tag}{i}") == lane)


def _drain_control(l3, **params):
    body = {"request_id": "gctl", "prompt_tokens": DRAIN_PROMPT,
            "max_new_tokens": 32, **params}
    want = l3["jax"].handle_generate(body)["tokens"]
    assert l3["workers"][2].handle_generate(body)["tokens"] == want
    return want


def _stream_with_drain(gw, req, drain_lane, min_tokens=3, drain_fn=None):
    """Consume a gateway stream on a thread; once ``min_tokens`` are
    relayed, drain ``drain_lane`` (the migrate-mode removal) and join."""
    toks, final = [], [None]
    armed = threading.Event()

    def consume():
        for frame in gw.route_generate_stream(dict(req)):
            evt = _parse_sse(frame)
            if evt is None:
                continue
            if evt.get("done"):
                final[0] = evt
                break
            toks.extend(evt.get("tokens", ()))
            if len(toks) >= min_tokens:
                armed.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert armed.wait(120), "stream never reached the drain point"
    (drain_fn or (lambda: gw.remove_worker(drain_lane, drain=True)))()
    t.join(timeout=120)
    assert final[0] is not None, "stream never terminated"
    return toks, final[0]


def _assert_counters_match_spans(gw):
    mig = gw.get_stats()["migration"]
    spans = [s for s in gw.tracer.snapshot() if s["op"] == "migration"]
    for field in MigrationCounters.SPAN_FIELDS:
        n = sum(1 for s in spans if s["attrs"]["decision"] == field)
        assert n == mig[field], (field, mig, [s["attrs"] for s in spans])


@pytest.mark.parametrize("params", [{}, {"temperature": 0.9, "seed": 31}],
                         ids=["greedy", "seeded"])
def test_migrate_mode_drain_splices_like_jax(lanes3, params):
    control = _drain_control(lanes3, **params)
    blocks = []
    for cls, cfg_cls in ((Gateway, GatewayConfig),
                         (JaxGateway, JaxGatewayConfig)):
        urls = lanes3["urls"]
        gw = _gw(cls, cfg_cls, urls)
        try:
            rid = _rid_for(gw, urls[0], "gd")
            req = {"request_id": rid, "prompt_tokens": DRAIN_PROMPT,
                   "max_new_tokens": 32, **params}
            pre = [w.generator.stats()["kv_pool"]["prefilled_tokens"]
                   for w in lanes3["workers"]]
            with _slowed(lanes3["workers"]):
                toks, final = _stream_with_drain(gw, req, urls[0])
            assert "error" not in final, final
            assert toks == control and final["tokens"] == control
            assert "resumed" not in final
            post = [w.generator.stats()["kv_pool"]["prefilled_tokens"]
                    for w in lanes3["workers"]]
            assert post[1:] == pre[1:]  # the import prefilled nothing
            st = gw.get_stats()
            assert st["failover"]["tokens_replayed"] == 0
            assert urls[0] not in gw.worker_names()
            if cls is Gateway:
                _assert_counters_match_spans(gw)
            blocks.append(st["migration"])
        finally:
            gw.stop()
        lanes3["workers"][0].undrain()
        assert _wait(lambda: all(_leak_free(w.generator)
                                 for w in lanes3["workers"]))
    assert blocks[0] == blocks[1]
    assert blocks[0]["streams_migrated"] == 1
    assert blocks[0]["migration_fallbacks"] == 0


def _corrupting(client):
    real = client.migrate

    def migrate(payload, timeout_s=None):
        out = real(payload, timeout_s)
        if out.get("ok"):
            blk = out["chain"]["blocks"][0]
            raw = bytearray(base64.b64decode(blk["k"]))
            raw[0] ^= 0xFF
            blk["k"] = base64.b64encode(bytes(raw)).decode()
        return out
    return migrate


def _slow_export(client):
    real = client.migrate

    def migrate(payload, timeout_s=None):
        out = real(payload, timeout_s)
        time.sleep(2.5)  # past the 0.3 s budget and its 1 s slack
        return out
    return migrate


@pytest.mark.parametrize("fault", ["corrupted", "dead-destination",
                                   "timeout"])
def test_migration_fallbacks_land_on_replay(lanes3, fault):
    urls = lanes3["urls"]
    kw = {"migrate_timeout_s": 0.3} if fault == "timeout" else {}
    gw = _gw(Gateway, GatewayConfig, urls, **kw)
    dead = None
    try:
        if fault == "corrupted":
            gw._clients[urls[0]].migrate = _corrupting(gw._clients[urls[0]])
        elif fault == "timeout":
            gw._clients[urls[0]].migrate = _slow_export(
                gw._clients[urls[0]])
        else:
            # A destination that refuses the connection.
            import socket
            sk = socket.socket()
            sk.bind(("127.0.0.1", 0))
            dead = f"127.0.0.1:{sk.getsockname()[1]}"
            sk.close()
            gw.add_worker(dead)
            gw._pick_migration_dest = lambda record, source: dead
        control = _drain_control(lanes3)
        rid = _rid_for(gw, urls[0], "fb")
        req = {"request_id": rid, "prompt_tokens": DRAIN_PROMPT,
               "max_new_tokens": 32}
        with _slowed(lanes3["workers"]):
            toks, final = _stream_with_drain(gw, req, urls[0])
        assert "error" not in final, final
        assert toks == control and final["tokens"] == control
        mig = gw.get_stats()["migration"]
        assert mig["migration_fallbacks"] >= 1
        assert {"corrupted": mig["migration_fallbacks"],
                "dead-destination": mig["import_dispatch_failed"],
                "timeout": mig["export_refusals"]}[fault] >= 1, mig
        assert gw.get_stats()["failover"]["resumes_succeeded"] == 1
        _assert_counters_match_spans(gw)
        assert _wait(lambda: all(_leak_free(w.generator)
                                 for w in lanes3["workers"]))
    finally:
        gw.stop()


def test_drain_during_active_failover(lanes3):
    """A stream's first lane dies mid-stream (the replay resume moves it),
    then its new lane is drained with migration: the twice-moved stream
    equals the unbroken one."""
    urls = lanes3["urls"]
    gw = _gw(Gateway, GatewayConfig, urls)
    try:
        client = gw._clients[urls[0]]
        orig = client.generate_stream
        calls = {"n": 0}

        def dying_stream(payload):
            calls["n"] += 1
            inner = orig(payload)
            if calls["n"] > 1:
                return inner

            def gen():
                for n, frame in enumerate(inner):
                    if n >= 3:
                        inner.close()
                        raise ConnectionResetError("lane died")
                    yield frame
            return gen()

        client.generate_stream = dying_stream
        control = _drain_control(lanes3)
        rid = _rid_for(gw, urls[0], "ip")
        req = {"request_id": rid, "prompt_tokens": DRAIN_PROMPT,
               "max_new_tokens": 32}
        toks, final = [], [None]
        resumed = threading.Event()

        def consume():
            for frame in gw.route_generate_stream(dict(req)):
                evt = _parse_sse(frame)
                if evt is None:
                    continue
                if evt.get("done"):
                    final[0] = evt
                    break
                toks.extend(evt.get("tokens", ()))
                if gw.active_streams().get(rid) not in (None, urls[0]):
                    resumed.set()

        with _slowed(lanes3["workers"]):
            t = threading.Thread(target=consume, daemon=True)
            t.start()
            assert resumed.wait(120), "stream never resumed off its lane"
            new_lane = gw.active_streams().get(rid)
            assert new_lane in urls[1:]
            gw.remove_worker(new_lane, drain=True)
            t.join(timeout=120)
        assert final[0] is not None and "error" not in final[0], final[0]
        assert toks == control and final[0]["tokens"] == control
        assert final[0]["resumed"] == 1  # one replay, one migration
        assert gw.get_stats()["migration"]["streams_migrated"] == 1
        _assert_counters_match_spans(gw)
        assert _wait(lambda: all(_leak_free(w.generator)
                                 for w in lanes3["workers"]))
    finally:
        gw.stop()


def test_bounded_drain_call_timeout_like_jax(lanes3):
    """A wedged lane's drain call is abandoned after drain_timeout_s,
    counted with its span, and the removal proceeds, as in JAX."""
    out = []
    for cls, cfg_cls in ((Gateway, GatewayConfig),
                         (JaxGateway, JaxGatewayConfig)):
        gw = cls(list(lanes3["urls"]), cfg_cls(drain_timeout_s=0.3))
        try:
            blocked = threading.Event()
            client = gw._clients[lanes3["urls"][1]]

            def wedged():
                blocked.set()
                time.sleep(5)
            client.drain = wedged
            t0 = time.monotonic()
            gw.remove_worker(lanes3["urls"][1], drain=True)
            assert time.monotonic() - t0 < 3.0 and blocked.is_set()
            spans = [s["attrs"]["decision"] for s in gw.tracer.snapshot()
                     if s["op"] == "migration"]
            out.append((gw.get_stats()["migration"], spans,
                        lanes3["urls"][1] in gw.worker_names()))
        finally:
            gw.stop()
    assert out[0] == out[1]
    assert out[0][0]["drain_failures"] == 1
    assert out[0][1] == ["drain_failures"] and out[0][2] is False


def test_migrate_defaults_off_like_jax(lanes3):
    """Without migrate_streams: no migration block, no stream registry,
    and a drained removal is the plain shed and replay."""
    out = []
    for cls, cfg_cls in ((Gateway, GatewayConfig),
                         (JaxGateway, JaxGatewayConfig)):
        gw = cls(list(lanes3["urls"]), cfg_cls())
        try:
            it = gw.route_generate_stream(
                {"request_id": "off2", "prompt_tokens": [4, 2, 7],
                 "max_new_tokens": 4})
            for _ in it:
                pass
            assert gw.active_streams() == {}
            gw.remove_worker(lanes3["urls"][2], drain=True)
            out.append(gw.get_stats())
        finally:
            gw.stop()
        lanes3["workers"][2].undrain()
    assert out[0] == out[1]
    assert "migration" not in out[0]
    assert lanes3["urls"][2] not in [b["node"]
                                     for b in out[0]["circuit_breakers"]]
