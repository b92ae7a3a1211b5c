"""The fleet prefix tier in the port (tpu_engine_torch: the gateway's
``PrefixDirectory`` and ``prefix_directory``, the worker's
``/admin/export_prefix``, ``prefix_fingerprints`` and hinted prefix
fetch, the scheduler's ``export_prefix`` and ``_fetch_prefix_splice``)
against the JAX package's, on the CPU, on the same weights
(gpt2-small-test in f32, carried over with
``models.convert.params_from_jax``):

- the directory: the same record, lookup, LRU and generation operations
  leave the port's and JAX's directories in the same state;
- the gateway, port and JAX in turn in front of the same scripted lanes
  over HTTP: it records the owner after a dispatch and stamps a later
  request ring-routed elsewhere with its hint, seeds from /health
  summaries, invalidates on removal, its counters equal its
  ``prefix_dir`` spans, and with the defaults nothing changes;
- a port lane's ``export_prefix`` at partial lengths (the JAX lane's
  block counts), the drain refusal by name;
- a hinted miss splices the owner's chain and streams the owner's tokens:
  greedy, seeded, mixed stepping, int8 and a host-demoted chain, and
  across the packages (a JAX lane fetching a port chain and the
  reverse); over HTTP through the gateway's directory;
- every rung of the ladder (peer unreachable, refused, timeout, in-flight
  cap, checksum, geometry, stale generation, pool full, no gain) prefills
  locally to the same tokens, counted once; a self hint is inert;
  defaults off ignore the hint and keep /health.
"""

import base64
import socket
import threading

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import _ensure_builtin_models_imported
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.serving.prefix_directory import PrefixDirectory as JaxDir
from tpu_engine.serving.resilience import PrefixDirCounters as JaxCounters
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.serving.gateway import Gateway
from tpu_engine_torch.serving.http import JsonHttpServer
from tpu_engine_torch.serving.prefix_directory import PrefixDirectory
from tpu_engine_torch.serving.resilience import PrefixDirCounters
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

_ensure_builtin_models_imported()

SHARED = list(range(100, 132))  # two full blocks at block size 16
BS = 16
GEN_KW = dict(model="gpt2-small-test", dtype="float32", gen_step_chunk=2,
              gen_kv_block_size=BS, gen_kv_blocks=40, gen_prefill_chunk=16,
              gen_max_batch_size=4, gen_prefix_fetch=True)
PROMPT48 = list(range(7, 55))  # three full blocks


# -- the directory ------------------------------------------------------------

def _dir_ops(d):
    out = [d.record("a", "w0", 2), d.record("b", "w1", 3),
           d.record("a", "w1", 1)]          # a deeper live entry is kept
    out.append(d.lookup("a"))
    out.append(d.record("c", "w2", 1))      # evicts the LRU ("b")
    out.append(d.lookup("b"))
    out.append(d.invalidate_lane("w0"))
    out.append(d.lookup("a"))
    out.append(d.record("a", "w0", 1))      # a fresh generation
    out.append((d.lookup("a"), d.lane_generation("w0"), d.stats()))
    return out


def test_directory_matches_jax():
    assert _dir_ops(PrefixDirectory(2)) == _dir_ops(JaxDir(2))
    d = PrefixDirectory(0)
    assert d.capacity == 1


def test_stale_entry_dies_in_lookup_like_jax():
    out = []
    for cls in (PrefixDirectory, JaxDir):
        d = cls(8)
        d.record("x", "w0", 2)
        d._lane_gen["w0"] = 5  # moved without the eager sweep
        out.append((d.lookup("x"), d.stats()))
    assert out[0] == out[1] and out[0][0] is None


def test_counters_schema_matches_jax():
    assert PrefixDirCounters.FIELDS == JaxCounters.FIELDS
    assert PrefixDirCounters.SPAN_FIELDS == JaxCounters.SPAN_FIELDS
    assert "evictions" not in PrefixDirCounters.SPAN_FIELDS


# -- the gateway's directory over scripted lanes ------------------------------

class StubLane:
    """A scripted generate lane over HTTP that keeps its payloads."""

    def __init__(self):
        self.payloads = []
        self.server = JsonHttpServer(0, host="127.0.0.1")
        self.server.route("POST", "/generate", lambda b: (200, self.gen(b)))
        self.server.route("GET", "/health", lambda _b: (200, {
            "healthy": True}))
        self.server.start(background=True)
        self.url = f"127.0.0.1:{self.server.port}"

    def gen(self, payload):
        self.payloads.append(dict(payload))
        return {"request_id": payload["request_id"], "tokens": [1, 2],
                "node_id": self.url, "generate_time_us": 1}


@pytest.fixture(scope="module")
def stubs():
    lanes = [StubLane() for _ in range(3)]
    yield lanes
    for ln in lanes:
        ln.server.stop(drain_s=0)


def both(stubs, fn, **kw):
    out = []
    urls = [ln.url for ln in stubs]
    for gw in (Gateway(urls, GatewayConfig(**kw)),
               JaxGateway(urls, JaxGatewayConfig(**kw))):
        for ln in stubs:
            ln.payloads.clear()
        try:
            out.append(fn(gw))
        finally:
            gw.stop()
    return out


def _rid(gw, lane, tag="q", on=True):
    return next(f"{tag}{i}" for i in range(4000)
                if (gw._ring.get_node(f"{tag}{i}") == lane) == on)


def _by_decision(gw):
    out = {}
    for s in gw.tracer.snapshot():
        if s["op"] == "prefix_dir":
            d = s["attrs"]["decision"]
            out[d] = out.get(d, 0) + 1
    return out


def test_gateway_records_owner_and_attaches_hint_like_jax(stubs):
    def run(gw):
        by = {ln.url: ln for ln in stubs}
        first = gw._ring.get_node("seed-0")
        gw.route_generate({"request_id": _rid(gw, first),
                           "prompt_tokens": list(SHARED),
                           "max_new_tokens": 1})
        a = ("prefix_hint" in by[first].payloads[-1],
             dict(gw.get_stats()["prefix_directory"]))
        gw.route_generate({"request_id": _rid(gw, first, "z"),
                           "prompt_tokens": list(SHARED),
                           "max_new_tokens": 1})
        b = "prefix_hint" in by[first].payloads[-1]
        r1 = _rid(gw, first, on=False)
        gw.route_generate({"request_id": r1, "prompt_tokens": list(SHARED),
                           "max_new_tokens": 1})
        hint = by[gw._ring.get_node(r1)].payloads[-1]["prefix_hint"]
        return a, b, hint, gw.get_stats()["prefix_directory"], \
            _by_decision(gw)
    port, jax_ = both(stubs, run, prefix_directory=True)
    assert port == jax_
    (hinted0, pd0), hinted1, hint, pd, spans = port
    assert not hinted0 and not hinted1
    assert pd0["recorded"] == 1 and pd0["lookup_misses"] == 1
    assert hint["blocks"] == 2 and hint["addr"] == hint["lane"]
    assert hint["fingerprint"] == "prefix:" + ",".join(map(str, SHARED))
    assert pd["hints_attached"] == 1
    for field in PrefixDirCounters.SPAN_FIELDS:
        assert spans.get(field, 0) == pd[field]


def test_gateway_seeds_and_invalidates_like_jax(stubs):
    def run(gw):
        w1 = stubs[1].url
        gw._seed_prefix_dir(w1, [{"tokens": list(SHARED), "blocks": 2},
                                 {"tokens": [5], "blocks": 1}, "garbage"])
        seeded = dict(gw.get_stats()["prefix_directory"])
        gw._seed_prefix_dir(w1, [{"tokens": list(SHARED), "blocks": 2}])
        again = gw.get_stats()["prefix_directory"]["seeded"]
        gw.remove_worker(w1)
        rid = _rid(gw, w1, on=False)
        gw.route_generate({"request_id": rid, "prompt_tokens": list(SHARED),
                           "max_new_tokens": 1})
        hints = [p for ln in stubs for p in ln.payloads
                 if "prefix_hint" in p]
        return seeded, again, hints, gw.get_stats()["prefix_directory"], \
            _by_decision(gw)
    port, jax_ = both(stubs, run, prefix_directory=True)
    assert port == jax_
    seeded, again, hints, pd, spans = port
    assert seeded["seeded"] == 1 and seeded["entries"] == 1 and again == 1
    assert hints == [] and pd["invalidations"] == 1
    for field in PrefixDirCounters.SPAN_FIELDS:
        assert spans.get(field, 0) == pd[field]


def test_gateway_defaults_off_wire_identical(stubs):
    def run(gw):
        for rid in ("r0", "r1"):
            gw.route_generate({"request_id": rid,
                               "prompt_tokens": list(SHARED),
                               "max_new_tokens": 1})
        return (gw.get_stats(),
                [p for ln in stubs for p in ln.payloads],
                _by_decision(gw))
    port, jax_ = both(stubs, run)
    assert port == jax_
    st, payloads, spans = port
    assert "prefix_directory" not in st and spans == {}
    assert all("prefix_hint" not in p for p in payloads)


# -- real lanes: export, splice identity, the ladder --------------------------

def _req(prompt, rid, **kw):
    return dict({"request_id": rid, "prompt_tokens": list(prompt),
                 "max_new_tokens": 8}, **kw)


@pytest.fixture(scope="module")
def jw():
    w = JaxWorker(JaxWorkerConfig(node_id="j0", **GEN_KW))
    yield w
    w.stop()


@pytest.fixture(scope="module")
def tparams(jw):
    return convert.params_from_jax(
        jax.tree.map(np.asarray, jw.engine.params),
        tcreate("gpt2-small-test").config, device="cpu")


def _port(node_id, tparams, **kw):
    return WorkerNode(WorkerConfig(node_id=node_id, device="cpu",
                                   **dict(GEN_KW, **kw)), params=tparams)


@pytest.fixture(scope="module")
def owner(tparams):
    w = _port("w0", tparams)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def registry(owner):
    return {"w0": owner}


@pytest.fixture(scope="module")
def transport(registry):
    def fn(hint, payload):
        return registry[hint["lane"]].handle_export_prefix(payload)
    return fn


@pytest.fixture(scope="module")
def control(owner, jw):
    """Greedy tokens of PROMPT48 (the JAX lane's too); seeds the owner's
    radix tree with the three blocks every fetch pulls."""
    want = owner.handle_generate(_req(PROMPT48, "ctl"))["tokens"]
    assert jw.handle_generate(_req(PROMPT48, "ctl"))["tokens"] == want
    return want


@pytest.fixture()
def fetcher(tparams, transport, request):
    """A fresh lane per test (an empty radix: every hinted admission is a
    local miss) on the owner's weights."""
    w = _port(f"f-{request.node.name[:24]}", tparams)
    w.set_prefix_fetch_transport(transport)
    yield w
    w.stop()


def _pfetch(worker):
    return worker.generator.stats().get("prefix_fetch") or {}


def _leak_free(worker) -> bool:
    st = worker.generator.stats()
    kp = st["kv_pool"]
    return (st["active"] == 0
            and kp["blocks_free"] + kp["radix_nodes"] >= kp["blocks_total"])


def test_export_prefix_partial_lengths_match_jax(owner, control, jw):
    for gen in (owner.generator, jw.generator):
        got = [gen.export_prefix(PROMPT48)["blocks"],
               gen.export_prefix(PROMPT48[:32])["blocks"],
               gen.export_prefix(PROMPT48[:32] + [999] * 16)["blocks"],
               gen.export_prefix(PROMPT48, max_blocks=1)["blocks"]]
        assert got == [3, 2, 2, 1]
        miss = gen.export_prefix([901, 902, 903] * 8)
        assert miss == {"ok": False, "reason": "no matching prefix chain"}
        assert not gen.export_prefix(PROMPT48[:5])["ok"]
    chain = owner.generator.export_prefix(PROMPT48)["chain"]
    jchain = jw.generator.export_prefix(PROMPT48)["chain"]
    assert {k: v for k, v in chain.items() if k not in ("blocks",
                                                       "checksum")} \
        == {k: v for k, v in jchain.items() if k not in ("blocks",
                                                        "checksum")}


def test_export_prefix_refusals_by_name(owner, control, jw):
    for w in (owner, jw):
        w.drain()
        try:
            out = w.handle_export_prefix({"tokens": PROMPT48})
            assert out == {"ok": False, "node_id": w.node_id,
                           "reason": f"lane {w.node_id} is draining"}
        finally:
            w.undrain()
        assert w.handle_export_prefix({"tokens": []})["reason"] == \
            "request carries no token prefix"
    assert owner.handle_export_prefix({"tokens": PROMPT48})["blocks"] == 3


def test_splice_identity_greedy(owner, control, fetcher):
    out = fetcher.handle_generate(
        _req(PROMPT48, "g1", prefix_hint={"lane": "w0", "blocks": 3}))
    assert out["tokens"] == control
    p = _pfetch(fetcher)
    # The last prompt block always recomputes: 2 of 3 blocks splice.
    assert p["attempted"] == 1 and p["spliced"] == 1
    assert p["blocks_spliced"] == 2
    assert p["prefill_tokens_skipped_remote"] == 32
    assert _leak_free(fetcher)
    # The spliced blocks joined the local radix: no second fetch.
    out2 = fetcher.handle_generate(
        _req(PROMPT48, "g2", prefix_hint={"lane": "w0", "blocks": 3}))
    assert out2["tokens"] == control and _pfetch(fetcher)["attempted"] == 1
    spans = [s for s in fetcher.tracer.snapshot()
             if s["op"] == "prefix_fetch"]
    assert len(spans) == 1 and spans[0]["attrs"]["outcome"] == "spliced"


def test_splice_identity_seeded_sampling(owner, control, fetcher):
    sampled = dict(temperature=0.9, seed=11)
    want = owner.handle_generate(_req(PROMPT48, "s0", **sampled))["tokens"]
    out = fetcher.handle_generate(
        _req(PROMPT48, "s1", prefix_hint={"lane": "w0", "blocks": 3},
             **sampled))
    assert out["tokens"] == want and _pfetch(fetcher)["spliced"] == 1


@pytest.mark.parametrize("mode", ["mixed", "int8", "host-demoted"])
def test_splice_identity_other_pools(tparams, mode):
    kw = {"mixed": dict(gen_mixed_step=True, gen_mixed_token_budget=16),
          "int8": dict(gen_kv_quantize="int8"),
          "host-demoted": dict(gen_kv_host_blocks=8)}[mode]
    own = _port("o0", tparams, **kw)
    fetch = _port("o1", tparams, **({} if mode == "host-demoted" else kw))
    fetch.set_prefix_fetch_transport(
        lambda hint, payload: own.handle_export_prefix(payload))
    try:
        want = own.handle_generate(_req(PROMPT48, "a"))["tokens"]
        if mode == "int8":
            chain = own.generator.export_prefix(PROMPT48)["chain"]
            assert chain["quantized"] and "ks" in chain["blocks"][0]
        if mode == "host-demoted":
            pool = own.generator._pool
            with pool.lock:
                pool.radix.evict(2)  # demote the LRU frontier leaves
                assert pool.stats()["host"]["blocks_used"] > 0
        out = fetch.handle_generate(
            _req(PROMPT48, "b", prefix_hint={"lane": "o0", "blocks": 3}))
        assert out["tokens"] == want
        assert _pfetch(fetch)["spliced"] == 1
        assert _leak_free(fetch)
    finally:
        own.stop()
        fetch.stop()


@pytest.mark.parametrize("owner_pkg", ["port", "jax"])
def test_cross_package_splice(owner, control, jw, tparams, owner_pkg):
    """A JAX lane splices a port lane's chain, and a port lane a JAX
    lane's (both share the chain format)."""
    src = owner if owner_pkg == "port" else jw
    if owner_pkg == "port":
        dst = JaxWorker(JaxWorkerConfig(node_id="jx1", **GEN_KW))
        dst.apply_weights(jw.engine.params)
    else:
        dst = _port("tx1", tparams)
    dst.set_prefix_fetch_transport(
        lambda hint, payload: src.handle_export_prefix(payload))
    try:
        out = dst.handle_generate(
            _req(PROMPT48, "x1", prefix_hint={"lane": src.node_id,
                                              "blocks": 3}))
        assert out["tokens"] == control
        assert dst.generator.stats()["prefix_fetch"]["spliced"] == 1
    finally:
        dst.stop()


def test_gateway_directory_drives_a_fetch_over_http(tparams, control):
    """Two port lanes over HTTP behind the port's gateway with the
    directory: a request whose ring lane is not the prefix's owner
    arrives with the hint and fetches the chain over
    /admin/export_prefix."""
    made = [serve_worker(WorkerConfig(port=0, node_id=f"h{i}", device="cpu",
                                      **GEN_KW), params=tparams)
            for i in range(2)]
    urls = [f"127.0.0.1:{s.port}" for _, s in made]
    gw = Gateway(urls, GatewayConfig(prefix_directory=True))
    try:
        own = gw._ring.get_node(_rid(gw, urls[0]))
        gw.route_generate(_req(PROMPT48, _rid(gw, urls[0])))
        r1 = _rid(gw, urls[0], "o", on=False)
        out = gw.route_generate(_req(PROMPT48, r1))
        assert out["tokens"] == control and out["node_id"] == "h1"
        p = made[1][0].generator.stats()["prefix_fetch"]
        assert p["spliced"] == 1 and p["blocks_spliced"] == 2
        pd = gw.get_stats()["prefix_directory"]
        assert pd["hints_attached"] == 1 and pd["recorded"] == 2
        # The fetching lane, as deep as the owner, owns it now.
        assert own == urls[0] and pd["lanes"] == {urls[1]: 1}
        fps = made[0][0].get_health()["prefix_fingerprints"]
        assert fps[0]["blocks"] == 3 and fps[0]["tokens"] == PROMPT48
    finally:
        gw.stop()
        for w, s in made:
            s.stop(drain_s=0)
            w.stop()


# -- the ladder: every rung prefills locally, counted once --------------------

def _assert_rung(fetcher, control, rid, rung, hint=None):
    before = dict(_pfetch(fetcher))
    out = fetcher.handle_generate(
        _req(PROMPT48, rid,
             prefix_hint=hint or {"lane": "w0", "blocks": 3}))
    assert out["tokens"] == control
    after = _pfetch(fetcher)
    assert after["attempted"] == before.get("attempted", 0) + 1
    assert after[rung] == before.get(rung, 0) + 1
    assert after["spliced"] == before.get("spliced", 0)
    assert _leak_free(fetcher)


@pytest.mark.parametrize("path", ["transport", "http"])
def test_rung_peer_unreachable(owner, control, fetcher, path):
    if path == "transport":
        def dead(hint, payload):
            raise RuntimeError("peer process is gone")
        fetcher.set_prefix_fetch_transport(dead)
        _assert_rung(fetcher, control, "ru-1", "peer_unreachable")
        return
    # A hint naming an address nobody listens on.
    fetcher.set_prefix_fetch_transport(None)
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{sk.getsockname()[1]}"
    sk.close()
    _assert_rung(fetcher, control, "ru-2", "peer_unreachable",
                 hint={"lane": "w0", "addr": addr, "blocks": 3})


def test_rung_peer_refused_drained_owner(owner, control, fetcher):
    owner.drain()
    try:
        _assert_rung(fetcher, control, "rr-1", "peer_refused")
    finally:
        owner.undrain()


def test_rung_timeout_http_path(owner, control, fetcher):
    """A peer that accepts and never answers."""
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    sk.listen(4)
    fetcher.config.gen_prefix_fetch_timeout_s = 0.3
    fetcher.set_prefix_fetch_transport(None)
    try:
        _assert_rung(fetcher, control, "rt-1", "timeout",
                     hint={"lane": "w0", "blocks": 3,
                           "addr": f"127.0.0.1:{sk.getsockname()[1]}"})
    finally:
        sk.close()


def test_rung_inflight_capped(owner, control, fetcher):
    held = 0
    while fetcher._prefix_fetch_sem.acquire(blocking=False):
        held += 1
    try:
        _assert_rung(fetcher, control, "rc-1", "inflight_capped")
    finally:
        for _ in range(held):
            fetcher._prefix_fetch_sem.release()


def test_rung_checksum_failed(owner, control, transport, fetcher):
    def corrupting(hint, payload):
        out = transport(hint, payload)
        entry = out["chain"]["blocks"][0]
        raw = bytearray(base64.b64decode(entry["k"]))
        raw[0] ^= 0xFF
        entry["k"] = base64.b64encode(bytes(raw)).decode("ascii")
        return out
    fetcher.set_prefix_fetch_transport(corrupting)
    _assert_rung(fetcher, control, "rk-1", "checksum_failed")


def test_rung_geometry_mismatch(owner, control, transport, fetcher):
    def wrong_geometry(hint, payload):
        out = transport(hint, payload)
        out["chain"]["block_size"] = 8
        return out
    fetcher.set_prefix_fetch_transport(wrong_geometry)
    _assert_rung(fetcher, control, "rg-1", "geometry_mismatch")


def test_rung_stale_generation(owner, control, transport, fetcher):
    """A pool rebuild between the radix lookup and the splice: the chain
    is not imported into the rebuilt pool, and the request fails at
    admission as any request whose pins predate a rebuild; the lane
    serves on."""
    pool = fetcher.generator._pool

    def racing_recovery(hint, payload):
        out = transport(hint, payload)
        with pool.lock:
            pool.generation += 1
        return out
    fetcher.set_prefix_fetch_transport(racing_recovery)
    with pytest.raises(RuntimeError, match="rebuilt"):
        fetcher.handle_generate(
            _req(PROMPT48, "rs-1", prefix_hint={"lane": "w0",
                                                "blocks": 3}))
    p = _pfetch(fetcher)
    assert p["attempted"] == 1 and p["stale_generation"] == 1
    assert p["spliced"] == 0
    assert _leak_free(fetcher)
    fetcher.set_prefix_fetch_transport(transport)
    assert fetcher.handle_generate(_req(PROMPT48, "rs-2"))["tokens"] == \
        control


def test_rung_pool_full(owner, control, transport, fetcher):
    pool = fetcher.generator._pool
    orig = pool.can_alloc
    armed = {"on": False}

    def arming(hint, payload):
        out = transport(hint, payload)
        armed["on"] = True  # the next can_alloc is the splice's
        return out

    def can_alloc(n):
        if armed["on"]:
            armed["on"] = False
            return False
        return orig(n)
    pool.can_alloc = can_alloc
    try:
        fetcher.set_prefix_fetch_transport(arming)
        _assert_rung(fetcher, control, "rp-1", "pool_full")
    finally:
        pool.can_alloc = orig


def test_rung_no_gain_shallow_peer(owner, control, registry, tparams,
                                   fetcher):
    shallow = _port("ng-owner", tparams)
    shallow.handle_generate(_req(PROMPT48[:17], "ng-seed"))
    registry["ng-owner"] = shallow
    try:
        assert shallow.generator.export_prefix(PROMPT48)["blocks"] == 1
        fetcher.handle_generate(_req(PROMPT48[:17], "ng-warm"))
        before = dict(_pfetch(fetcher))
        out = fetcher.handle_generate(
            _req(PROMPT48, "ng-1", prefix_hint={"lane": "ng-owner",
                                                "blocks": 2}))
        assert out["tokens"] == control
        after = _pfetch(fetcher)
        assert after["attempted"] == before.get("attempted", 0) + 1
        assert after["no_gain"] == before.get("no_gain", 0) + 1
        assert _leak_free(fetcher)
    finally:
        registry.pop("ng-owner", None)
        shallow.stop()


def test_self_hint_is_inert(owner, control):
    before = dict(_pfetch(owner))
    out = owner.handle_generate(
        _req(PROMPT48, "self-1", prefix_hint={"lane": "w0", "blocks": 3}))
    assert out["tokens"] == control
    assert _pfetch(owner).get("attempted", 0) == before.get("attempted", 0)


def test_concurrent_hinted_streams_consistent(owner, control, fetcher):
    results = [None, None]

    def run(i):
        results[i] = fetcher.handle_generate(
            _req(PROMPT48, f"cc-{i}",
                 prefix_hint={"lane": "w0", "blocks": 3}))["tokens"]
    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results == [control, control]
    assert _leak_free(fetcher)


# -- defaults off ---------------------------------------------------------------

def test_worker_defaults_off_ignore_the_hint(tparams, jw):
    off = _port("off0", tparams, gen_prefix_fetch=False)
    try:
        want = off.handle_generate(_req(PROMPT48, "off-a"))["tokens"]
        out = off.handle_generate(
            _req(PROMPT48, "off-b", prefix_hint={"lane": "w0",
                                                 "blocks": 3}))
        assert out["tokens"] == want
        assert "prefix_fetch" not in off.generator.stats()
        h = off.get_health()
        assert "prefix_fingerprints" not in h
        assert off.generator.prefix_fetch is None
        jh = jw.get_health()
        assert ("prefix_fingerprints" in jh) and ("role" not in h)
    finally:
        off.stop()


def test_fetch_on_but_unused_keeps_stats_gated(tparams):
    quiet = _port("quiet0", tparams)
    try:
        quiet.handle_generate(_req(PROMPT48, "quiet-a"))
        assert "prefix_fetch" not in quiet.generator.stats()
        fps = quiet.get_health()["prefix_fingerprints"]
        assert fps and fps[0]["blocks"] == 3
        assert fps[0]["tokens"][:16] == PROMPT48[:16]
    finally:
        quiet.stop()


def test_prefix_fetch_fences_refuse_as_jax(tparams, owner):
    with pytest.raises(RuntimeError, match="--prefix-fetch requires"):
        WorkerNode(WorkerConfig(model="gpt2-small-test", dtype="float32",
                                device="cpu", gen_prefix_fetch=True),
                   params=tparams)
    no_share = _port("ns0", tparams, gen_prefix_fetch=False,
                     gen_prefix_sharing=False)
    try:
        refused = no_share.generator.export_prefix(PROMPT48)
        assert refused == {"ok": False,
                           "reason": "prefix export requires the paged KV "
                                     "cache with prefix sharing on"}
        assert no_share.generator.prefix_fingerprints() == []
    finally:
        no_share.stop()
