"""The port's native core (``tpu_engine_torch/native``, bound by
``tpu_engine_torch/core/native.py``) against the JAX package's
(``tpu_engine.core.native``, built by the JAX package as its own tests build
it) and against the port's pure-Python core: FNV-1a, ring assignments, LRU
eviction, breaker transitions, the batch queue, the JSON encoder; where the
library lands and how a failed build fails; and the C++ front's cache keys
and ring against the worker's keys and the gateway's Python ring."""

import http.client
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_engine.core import native as jnative
from tpu_engine_torch.core import native
from tpu_engine_torch.core.circuit_breaker import CircuitBreaker, CircuitState
from tpu_engine_torch.core.consistent_hash import ConsistentHash, fnv1a_32
from tpu_engine_torch.core.lru_cache import LRUCache
from tpu_engine_torch.serving.worker import WorkerNode, _encode_output

REPO = Path(__file__).resolve().parents[1]
JAX_OK = jnative.available()


@pytest.fixture(scope="module", autouse=True)
def lib():
    return native.load()


# -- hashing and the ring -------------------------------------------------------

@pytest.mark.parametrize("key", ["", "a", "foobar", "worker_1#149",
                                 "req_12345", "host:8001#0", "é漢"])
def test_fnv1a_matches_python_and_jax(key):
    assert native.native_fnv1a_32(key) == fnv1a_32(key)
    if JAX_OK:
        assert native.native_fnv1a_32(key) == jnative.native_fnv1a_32(key)


def test_ring_assignments_through_adds_and_removes():
    keys = [f"req_{i}" for i in range(5000)]
    rings = [native.NativeConsistentHash(150), ConsistentHash(150)]
    if JAX_OK:
        rings.append(jnative.NativeConsistentHash(150))
    steps = [("add", "worker_1"), ("add", "worker_2"), ("add", "worker_3"),
             ("add", "127.0.0.1:8001"), ("remove", "worker_2"),
             ("add", "worker_4"), ("remove", "worker_1"),
             ("add", "worker_2")]
    for op, node in steps:
        for r in rings:
            getattr(r, f"{op}_node")(node)
        want = [rings[1].get_node(k) for k in keys]
        for r in rings[::2]:
            assert [r.get_node(k) for k in keys] == want, (op, node)
            assert r.get_all_nodes() == rings[1].get_all_nodes()
            assert r.size() == rings[1].size()
    assert rings[0].get_distribution(keys[:100]) == \
        rings[1].get_distribution(keys[:100])


def test_ring_empty_and_newline_names():
    r = native.NativeConsistentHash(10)
    with pytest.raises(RuntimeError, match="empty"):
        r.get_node("k")
    r.add_node("rack1\nlane0")
    r.add_node("plain")
    assert sorted(r.get_all_nodes()) == ["plain", "rack1\nlane0"]
    assert r.size() == 2


# -- the LRU ------------------------------------------------------------------

def _lru_trace(cache, raw: bool) -> list:
    """A fixed sequence of binary-key puts and gets; the observable
    results."""
    keys = [bytes([i, 0, 255 - i]) + b"\x00k\n" for i in range(6)]
    val = (lambda i: b"\x00v" + bytes([i])) if raw else (
        lambda i: {"v": i, "blob": b"\x00\x01"})
    out = []
    for i in range(3):
        cache.put(keys[i], val(i))
    out.append(cache.get(keys[0]))          # 0 becomes most recent
    cache.put(keys[3], val(3))              # evicts 1
    out += [cache.get(k) for k in keys[:4]]
    cache.put(keys[2], val(9))              # update promotes 2
    cache.put(keys[4], val(4))              # evicts 0 (3 < 2 < 4)
    out += [cache.get(k) for k in keys[:5]]
    out.append((cache.size(), cache.hits, cache.misses,
                round(cache.hit_rate(), 6)))
    cache.clear()
    out.append((cache.size(), cache.hits, cache.misses, cache.get(keys[2])))
    return out


@pytest.mark.parametrize("raw", [True, False])
def test_lru_eviction_order_with_binary_keys(raw):
    want = _lru_trace(LRUCache(3), raw)
    assert _lru_trace(native.NativeLRUCache(3, raw=raw), raw) == want
    if JAX_OK:
        assert _lru_trace(jnative.NativeLRUCache(3, raw=raw), raw) == want


def test_lru_contracts():
    with pytest.raises(ValueError):
        native.NativeLRUCache(0)
    c = native.NativeLRUCache(4, raw=True)
    assert c.raw and c.capacity == 4
    with pytest.raises(TypeError):
        c.put("str-key", b"1")
    with pytest.raises(TypeError):
        c.get(123)
    with pytest.raises(TypeError):
        c.put(b"k", "not bytes")


# -- the breaker ----------------------------------------------------------------

def _breaker_trace(b) -> list:
    """Failures to OPEN, the timeout to HALF_OPEN, a failure reopening,
    two successes closing, and a success resetting the count."""
    out = []
    for _ in range(2):
        b.record_failure()
    b.record_success()                       # consecutive count resets
    out.append((b.state.value, b.failure_count))
    for _ in range(3):
        b.record_failure()
    out.append((b.state.value, b.allow_request()))
    time.sleep(0.25)
    out.append((b.allow_request(), b.state.value))
    b.record_failure()                       # HALF_OPEN failure reopens
    out.append((b.state.value, b.allow_request()))
    time.sleep(0.25)
    out.append(b.allow_request())
    b.record_success()
    out.append((b.state.value, b.success_count))
    b.record_success()
    out.append((b.state_name(), b.failure_count, b.allow_request()))
    return out


def test_breaker_transitions():
    want = _breaker_trace(CircuitBreaker(3, 2, 0.2))
    assert want[1] == ("OPEN", False) and want[-1][0] == "CLOSED"
    assert _breaker_trace(native.NativeCircuitBreaker(3, 2, 0.2)) == want
    if JAX_OK:
        assert _breaker_trace(jnative.NativeCircuitBreaker(3, 2, 0.2)) == \
            want
    assert native.NativeCircuitBreaker().state is CircuitState.CLOSED


# -- the batch queue --------------------------------------------------------------

QUEUES = [native.NativeBatchQueue] + ([jnative.NativeBatchQueue]
                                      if JAX_OK else [])


@pytest.mark.parametrize("cls", QUEUES, ids=lambda c: c.__module__)
def test_batch_queue_round_trip_timeout_and_max_batch(cls):
    q = cls(max_batch=3, timeout_s=0.05)
    assert (q.push(b"a"), q.push(b"\x00b")) == (0, 1)
    items, timed_out = q.pop_batch()
    assert items == [(0, b"a"), (1, b"\x00b")] and not timed_out
    t0 = time.monotonic()
    items, timed_out = q.pop_batch()
    assert items == [] and timed_out
    assert 0.03 <= time.monotonic() - t0 < 1.0
    for i in range(7):
        q.push(bytes([i]))
    assert q.size() == 7
    assert [len(q.pop_batch()[0]) for _ in range(3)] == [3, 3, 1]
    with pytest.raises(ValueError):
        cls(max_batch=0, timeout_s=0.1)


@pytest.mark.parametrize("cls", QUEUES, ids=lambda c: c.__module__)
def test_batch_queue_close_unblocks_and_drains(cls):
    q = cls(max_batch=4, timeout_s=5.0)
    result = {}

    def popper():
        result["first"] = q.pop_batch()
        result["second"] = q.pop_batch()

    t = threading.Thread(target=popper)
    t.start()
    time.sleep(0.05)
    q.push(b"x")
    time.sleep(0.05)
    q.close()
    t.join(timeout=3)
    assert not t.is_alive()
    assert result["first"][0] == [(0, b"x")]
    assert result["second"][0] is None
    assert q.push(b"y") == -1


@pytest.mark.parametrize("cls", QUEUES, ids=lambda c: c.__module__)
def test_batch_queue_concurrent_producers(cls):
    q = cls(max_batch=32, timeout_s=0.02)
    n = 400

    def producer(base):
        for i in range(n // 8):
            q.push(f"{base}:{i}".encode())

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = []
    while len(got) < n:
        items, _ = q.pop_batch()
        assert items is not None and len(items) <= 32
        got.extend(items)
    assert sorted(t for t, _ in got) == list(range(n))
    assert len({p for _, p in got}) == n


# -- the JSON encoder -------------------------------------------------------------

ENCODE_CASES = {
    "normals": np.random.default_rng(1).standard_normal(257)
    * 10.0 ** np.random.default_rng(2).integers(-8, 8, 257),
    "non-finite": [np.nan, np.inf, -np.inf, 0.0, -0.0],
    "subnormals": [1e-45, -1.4e-45, 1e-40, 1.17549435e-38, 5e-39],
    "extremes": [1e38, -1e38, 3.4028235e38, 1.0, -1.0, 123456.7, 1e-7],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_json_encode_f32_bytes(case):
    a = np.asarray(ENCODE_CASES[case], np.float32)
    frag = native.json_encode_f32(a)
    assert frag == _encode_output(a)
    if JAX_OK:
        assert frag == jnative.json_encode_f32(a)
    back = np.asarray(json.loads(frag), np.float32)
    finite = np.isfinite(a)
    np.testing.assert_array_equal(np.isnan(back), np.isnan(a))
    assert np.all(back[~finite & ~np.isnan(a)] == a[~finite & ~np.isnan(a)])
    rel = np.abs(back[finite] - a[finite]) / (np.abs(a[finite]) + 1e-30)
    assert rel.size == 0 or rel.max() < 1e-5


# -- where the library lands, and a failed build ------------------------------------

def test_library_lands_under_build_and_not_at_jax_paths(lib):
    path = Path(lib._name).resolve()
    assert path == native.library_path().resolve()
    assert path.parent == (REPO / "build" / "tpu_engine_torch"
                           / "native").resolve()
    assert path.name.startswith("libtpucore_torch_")
    jax_paths = {(REPO / "tpu_engine" / "native" / "libtpucore.so").resolve(),
                 (REPO / "build" / "native" / "libtpucore.so").resolve()}
    assert path not in jax_paths
    assert not any(p.name.startswith("libtpucore_torch")
                   for p in (REPO / "tpu_engine" / "native").iterdir())


def test_library_path_follows_the_sources(tmp_path):
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src)
    assert native.library_path(src).name == native.library_path().name
    (src / "core.h").write_text((src / "core.h").read_text() + "\n// x\n")
    assert native.library_path(src).name != native.library_path().name


@pytest.mark.parametrize("breakage", ["source", "compiler"])
def test_failed_build_raises_with_the_compiler_message(tmp_path, breakage):
    import os

    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src)
    env = os.environ.copy()
    if breakage == "source":
        api = src / "core_api.cc"
        api.write_text("#error deliberately broken copy\n" + api.read_text())
        want = "deliberately broken copy"
    else:
        fake = tmp_path / "fake-cxx"
        fake.write_text("#!/bin/sh\necho 'fake-cxx: cannot compile' >&2\n"
                        "exit 1\n")
        fake.chmod(0o755)
        env["CXX"] = str(fake)
        want = "fake-cxx: cannot compile"
    out = tmp_path / "out" / "libtpucore_torch_broken.so"
    with pytest.raises(RuntimeError, match=want):
        native.build_library(src, out, env=env)
    assert not out.exists()
    assert list(out.parent.iterdir()) == []  # no temporary left behind


# -- the C++ front against the worker's keys and the gateway's ring --------------------

@pytest.fixture()
def front():
    """A bare C++ front over three lanes whose caches the test fills; the
    Python fallback answers 200 ``{"fallback": path}``."""
    lanes = {f"worker_{i}": native.NativeLRUCache(64, raw=True)
             for i in (1, 2, 3)}
    f = native.NativeHttpFront(
        0, lambda m, p, b: (200, json.dumps({"fallback": p}).encode()))
    for name, cache in lanes.items():
        f.add_lane(name, cache, native.NativeCircuitBreaker(5, 2, 30.0))
    f.start()
    yield f, lanes
    f.stop()


def _post(port: int, body: bytes) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/infer", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


KEY_CASES = ["-0.0", "-0", "0", "1e-45", "-1.4e-45", "1e-40", "5e-324",
             "1e38", "-3.4028235e38", "1e39", "1", "-7", "100", "16777217",
             "1152921573326323713", "1E5", "2.5e-3", "0.1", "-1.5E+2",
             "3.000000000000001"]


def test_cpp_cache_key_equals_the_worker_key(front):
    """Each number as a client would write it: the C++ hit path's key (the
    float cast of strtod, an integer literal's zero unsigned) is the
    worker's key (numpy float32 of json.loads), so the entry the Python
    path stored answers from C++."""
    f, lanes = front
    ring = ConsistentHash(150)
    for name in lanes:
        ring.add_node(name)
    for i, text in enumerate(KEY_CASES):
        body = ('{"request_id": "k%d", "input_data": [%s, 2.5, %s]}'
                % (i, text, text)).encode()
        key = WorkerNode._cache_key(json.loads(body)["input_data"])
        frag = b'[%d]' % i
        lanes[ring.get_node(f"k{i}")].put(key, frag)
        got = _post(f.port, body)
        assert got.get("cached") is True, (text, got)
        assert got["output_data"] == [i] and got["request_id"] == f"k{i}"


def test_cpp_ring_agrees_with_the_gateway_ring(front):
    """Every request id goes to the lane the gateway's Python ring picks:
    each lane caches one input with a fragment naming itself."""
    f, lanes = front
    ring = ConsistentHash(150)
    for name in lanes:
        ring.add_node(name)
    body = '{"request_id": "%s", "input_data": [1.0, 2.0]}'
    key = WorkerNode._cache_key([1.0, 2.0])
    for name, cache in lanes.items():
        cache.put(key, json.dumps(name).encode())
    counts = {}
    for i in range(300):
        rid = f"req_{i}"
        got = _post(f.port, (body % rid).encode())
        assert got["node_id"] == got["output_data"] == ring.get_node(rid)
        counts[got["node_id"]] = counts.get(got["node_id"], 0) + 1
    assert set(counts) == set(lanes)
    assert sum(f.lane_counters(n)[1] for n in lanes) == 300
    # A disabled lane's requests fall back to Python.
    f.set_lane_enabled("worker_1", False)
    rid = next(f"req_{i}" for i in range(300)
               if ring.get_node(f"req_{i}") == "worker_1")
    assert _post(f.port, (body % rid).encode()) == {"fallback": "/infer"}


def test_front_fallback_errors_never_cross_the_callback():
    def boom(_m, _p, _b):
        raise RuntimeError("handler failed")

    f = native.NativeHttpFront(0, boom)
    f.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", f.port, timeout=30)
        conn.request("GET", "/health")
        resp = conn.getresponse()
        assert resp.status == 500
        assert json.loads(resp.read()) == {"error": "handler failed"}
        conn.close()
    finally:
        f.stop()
    with pytest.raises(ValueError, match="raw-mode"):
        f.add_lane("w", native.NativeLRUCache(2))
