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
  tag, a finished row, and the disaggregated handoff's ``wait_prefill``,
  ``cancel`` and ``handoff``, each by name;
- retryable ``ImportRefused`` for a bad checksum, another geometry and a
  pool that cannot keep the live-row reserve, with no block leaked;
- a radix re-adoption ships only the chain's unmatched tail;
- the ``migration`` stats block and the terminal SSE events carry the JAX
  keys (less ``trace_id``: tracing is not ported).
"""

import base64
import http.client
import json
import queue
import time

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import _ensure_builtin_models_imported
from tpu_engine.runtime.scheduler import ImportRefused as JaxImportRefused
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
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import WorkerConfig

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


def test_handoff_options_refuse_by_name(fleets):
    fleet = fleets("two-path")
    w, port = fleet["port"][0], fleet["http"][0]
    for opt in ("wait_prefill", "cancel"):
        out = w.handle_migrate_export({"request_id": "x", opt: True})
        assert out["ok"] is False and "disaggregated" in out["reason"]
        assert "not yet ported" in out["reason"]
    status, body = _post(port, "/generate/stream", {
        "request_id": "h", "prompt_tokens": PROMPT, "max_new_tokens": 4,
        "handoff": True})
    assert status == 400 and "handoff" in body["error"]
    assert w.generator.stats()["active"] == 0


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
