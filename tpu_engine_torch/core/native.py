"""ctypes bindings of the port's native core, ``libtpucore_torch.so`` (the
counterpart of ``tpu_engine/core/native.py``): ``NativeLRUCache``,
``NativeConsistentHash``, ``NativeCircuitBreaker``, ``NativeBatchQueue``,
``native_fnv1a_32``, ``json_encode_f32`` and ``NativeHttpFront``, with the
Python API of the port's pure-Python core (``core.lru_cache``,
``core.consistent_hash``, ``core.circuit_breaker``).

The library is built at first use from ``tpu_engine_torch/native/``
(``build.sh``: one ``g++``, about 4 s) into
``build/tpu_engine_torch/native/libtpucore_torch_<hash>.so``, the hash
taken over the sources, so an edited source builds anew. The build writes
a pid-suffixed temporary file and renames it into place, so processes
that build at once never leave a torn library. There is no fallback: a
failed build raises with the compiler's output, and so does a failed
load; the next call tries again.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pickle
import subprocess
import threading
from pathlib import Path
from typing import Any, List, Optional

from tpu_engine_torch.core.circuit_breaker import CircuitState

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("core.h", "http_front.h", "core_api.cc", "build.sh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "tpu_engine_torch" / "native"

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def library_path(native_dir: Path = NATIVE_DIR,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of the sources in ``native_dir`` lands."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (native_dir / name).read_bytes())
    return build_dir / f"libtpucore_torch_{h.hexdigest()[:16]}.so"


def build_library(native_dir: Path = NATIVE_DIR,
                  out: Optional[Path] = None, env=None) -> Path:
    """Build the sources in ``native_dir`` into ``out`` (default
    ``library_path``) unless it exists; raise RuntimeError with the
    compiler's output when the build fails."""
    out = Path(out) if out is not None else library_path(native_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    try:
        res = subprocess.run(
            ["bash", str(native_dir / "build.sh"), str(tmp)],
            capture_output=True, text=True, timeout=300,
            env=env if env is not None else os.environ.copy())
        if res.returncode != 0 or not tmp.exists():
            raise RuntimeError(
                f"building libtpucore_torch from {native_dir} failed "
                f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The port's library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    with _load_lock:
        if _lib is None:
            _lib = _configure(ctypes.CDLL(str(build_library())))
        return _lib


# void handler(reply_ctx, method, path, body, body_len); the body is read
# by its length (a pointer, not a NUL-terminated string).
HANDLER_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_void_p,
                              ctypes.c_size_t)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_size = ctypes.c_size_t
    P = ctypes.c_void_p
    PP = ctypes.POINTER(ctypes.c_void_p)
    lib.tpu_free.argtypes = [P]
    lib.tpu_json_encode_f32.restype = c_size
    lib.tpu_json_encode_f32.argtypes = [P, c_size, PP]

    lib.tpu_lru_create.restype = P
    lib.tpu_lru_create.argtypes = [c_size]
    lib.tpu_lru_destroy.argtypes = [P]
    lib.tpu_lru_get.restype = ctypes.c_int
    lib.tpu_lru_get.argtypes = [P, ctypes.c_char_p, c_size, PP,
                                ctypes.POINTER(c_size)]
    lib.tpu_lru_put.argtypes = [P, ctypes.c_char_p, c_size,
                                ctypes.c_char_p, c_size]
    lib.tpu_lru_clear.argtypes = [P]
    for fn, res in (("tpu_lru_size", c_size), ("tpu_lru_capacity", c_size),
                    ("tpu_lru_hits", ctypes.c_uint64),
                    ("tpu_lru_misses", ctypes.c_uint64)):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = [P]

    lib.tpu_ring_create.restype = P
    lib.tpu_ring_create.argtypes = [ctypes.c_int]
    lib.tpu_ring_destroy.argtypes = [P]
    lib.tpu_ring_add.argtypes = [P, ctypes.c_char_p]
    lib.tpu_ring_remove.argtypes = [P, ctypes.c_char_p]
    lib.tpu_ring_get.restype = ctypes.c_int
    lib.tpu_ring_get.argtypes = [P, ctypes.c_char_p, PP,
                                 ctypes.POINTER(c_size)]
    lib.tpu_ring_all_nodes.restype = ctypes.c_int
    lib.tpu_ring_all_nodes.argtypes = [P, PP, ctypes.POINTER(c_size)]
    lib.tpu_ring_num_nodes.restype = c_size
    lib.tpu_ring_num_nodes.argtypes = [P]
    lib.tpu_fnv1a.restype = ctypes.c_uint32
    lib.tpu_fnv1a.argtypes = [ctypes.c_char_p, c_size]

    lib.tpu_breaker_create.restype = P
    lib.tpu_breaker_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_double]
    lib.tpu_breaker_destroy.argtypes = [P]
    for fn in ("tpu_breaker_allow", "tpu_breaker_state",
               "tpu_breaker_failures", "tpu_breaker_successes"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [P]
    lib.tpu_breaker_success.argtypes = [P]
    lib.tpu_breaker_failure.argtypes = [P]

    lib.tpu_bq_create.restype = P
    lib.tpu_bq_create.argtypes = [c_size, ctypes.c_double]
    lib.tpu_bq_destroy.argtypes = [P]
    lib.tpu_bq_push.restype = ctypes.c_longlong
    lib.tpu_bq_push.argtypes = [P, ctypes.c_char_p, c_size]
    lib.tpu_bq_pop_batch.restype = ctypes.c_int
    lib.tpu_bq_pop_batch.argtypes = [
        P, PP, ctypes.POINTER(c_size), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.tpu_bq_close.argtypes = [P]
    lib.tpu_bq_size.restype = c_size
    lib.tpu_bq_size.argtypes = [P]

    lib.tpu_front_create.restype = P
    lib.tpu_front_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    lib.tpu_front_destroy.argtypes = [P]
    lib.tpu_front_add_lane.argtypes = [P, ctypes.c_char_p, P, P]
    lib.tpu_front_remove_lane.argtypes = [P, ctypes.c_char_p]
    lib.tpu_front_ring_nodes.restype = ctypes.c_int
    lib.tpu_front_ring_nodes.argtypes = [P, PP, ctypes.POINTER(c_size)]
    lib.tpu_front_set_lane_enabled.argtypes = [P, ctypes.c_char_p,
                                               ctypes.c_int]
    lib.tpu_front_set_handler.argtypes = [P, HANDLER_FN]
    lib.tpu_front_start.restype = ctypes.c_int
    lib.tpu_front_start.argtypes = [P]
    lib.tpu_front_stop.argtypes = [P]
    for fn in ("tpu_front_lane_total", "tpu_front_lane_hits"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [P, ctypes.c_char_p]
    lib.tpu_front_reply.argtypes = [P, ctypes.c_int, ctypes.c_char_p,
                                    c_size]
    lib.tpu_front_reply2.argtypes = [P, ctypes.c_int, ctypes.c_char_p,
                                     c_size, ctypes.c_char_p]
    return lib


def _take_bytes(lib, ptr, length: int) -> bytes:
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib.tpu_free(ptr)


def _take_names(lib, fn, h) -> List[str]:
    """The names ``fn(h, &buf, &len)`` returns as repeated <uint32 LE
    length><bytes> records."""
    out = ctypes.c_void_p()
    n = ctypes.c_size_t()
    fn(h, ctypes.byref(out), ctypes.byref(n))
    buf = _take_bytes(lib, out, n.value)
    names, pos = [], 0
    while pos < len(buf):
        ln = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        names.append(buf[pos:pos + ln].decode())
        pos += ln
    return names


def json_encode_f32(arr) -> bytes:
    """``[a,b,...]`` JSON fragment of a float array, each value ``%.6g``
    (NaN, Infinity and -Infinity spelled as ``json.dumps`` spells them),
    encoded in C with the GIL released."""
    import numpy as np

    lib = load()
    a = np.ascontiguousarray(arr, dtype=np.float32)
    out = ctypes.c_void_p()
    length = lib.tpu_json_encode_f32(a.ctypes.data_as(ctypes.c_void_p),
                                     a.size, ctypes.byref(out))
    if not out:
        raise MemoryError("tpu_json_encode_f32: allocation failed")
    return _take_bytes(lib, out, length)


def native_fnv1a_32(key: str) -> int:
    b = key.encode()
    return load().tpu_fnv1a(b, len(b))


class _Handle:
    """Owns one C handle, released by ``_destroy`` when collected."""

    _destroy = ""

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            getattr(lib, self._destroy)(h)
            self._h = None


class NativeLRUCache(_Handle):
    """Byte-blob LRU. Keys must be ``bytes`` (the worker keys by the
    input's float32 bytes); values are pickled, or with ``raw=True`` kept
    as verbatim bytes, the contract that lets the native HTTP front serve
    entries directly."""

    _destroy = "tpu_lru_destroy"

    def __init__(self, capacity: int, raw: bool = False):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._lib = load()
        self._raw = bool(raw)
        self._h = self._lib.tpu_lru_create(capacity)

    @property
    def raw(self) -> bool:
        return self._raw

    @property
    def handle(self):
        """The C handle (for the front's ``add_lane``)."""
        return self._h

    @staticmethod
    def _key_bytes(key) -> bytes:
        if not isinstance(key, bytes):
            raise TypeError(f"NativeLRUCache keys must be bytes, got "
                            f"{type(key).__name__}")
        return key

    def get(self, key) -> Optional[Any]:
        out = ctypes.c_void_p()
        n = ctypes.c_size_t()
        k = self._key_bytes(key)
        if not self._lib.tpu_lru_get(self._h, k, len(k), ctypes.byref(out),
                                     ctypes.byref(n)):
            return None
        blob = _take_bytes(self._lib, out, n.value)
        return blob if self._raw else pickle.loads(blob)

    def put(self, key, value: Any) -> None:
        k = self._key_bytes(key)
        v = value if self._raw else pickle.dumps(value)
        if not isinstance(v, bytes):
            raise TypeError("raw NativeLRUCache values must be bytes")
        self._lib.tpu_lru_put(self._h, k, len(k), v, len(v))

    def clear(self) -> None:
        self._lib.tpu_lru_clear(self._h)

    def size(self) -> int:
        return self._lib.tpu_lru_size(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.tpu_lru_capacity(self._h)

    @property
    def hits(self) -> int:
        return self._lib.tpu_lru_hits(self._h)

    @property
    def misses(self) -> int:
        return self._lib.tpu_lru_misses(self._h)

    def hit_rate(self) -> float:
        from tpu_engine_torch.core.lru_cache import compute_hit_rate

        return compute_hit_rate(self.hits, self.misses)


class NativeConsistentHash(_Handle):
    """The C++ ring: FNV-1a over ``"{node}#{i}"``, ``virtual_nodes`` per
    node, unweighted (the front's own ring is one of these)."""

    _destroy = "tpu_ring_destroy"

    def __init__(self, virtual_nodes: int = 150):
        self._lib = load()
        self._virtual_nodes = int(virtual_nodes)
        self._h = self._lib.tpu_ring_create(self._virtual_nodes)

    @property
    def virtual_nodes(self) -> int:
        return self._virtual_nodes

    def add_node(self, node: str) -> None:
        self._lib.tpu_ring_add(self._h, node.encode())

    def remove_node(self, node: str) -> None:
        self._lib.tpu_ring_remove(self._h, node.encode())

    def get_node(self, key: str) -> str:
        out = ctypes.c_void_p()
        n = ctypes.c_size_t()
        if not self._lib.tpu_ring_get(self._h, key.encode(),
                                      ctypes.byref(out), ctypes.byref(n)):
            raise RuntimeError("hash ring is empty")
        return _take_bytes(self._lib, out, n.value).decode()

    def get_all_nodes(self) -> List[str]:
        return _take_names(self._lib, self._lib.tpu_ring_all_nodes, self._h)

    def size(self) -> int:
        return self._lib.tpu_ring_num_nodes(self._h)

    def get_distribution(self, keys) -> dict:
        """Keys per node over ``keys``."""
        counts: dict = {}
        for k in keys:
            n = self.get_node(k)
            counts[n] = counts.get(n, 0) + 1
        return counts


class NativeCircuitBreaker(_Handle):
    """The C++ breaker (the front's hit path gates on and records into the
    same object the gateway holds)."""

    _destroy = "tpu_breaker_destroy"
    _STATES = {0: CircuitState.CLOSED, 1: CircuitState.OPEN,
               2: CircuitState.HALF_OPEN}

    def __init__(self, failure_threshold: int = 5,
                 success_threshold: int = 2, timeout_seconds: float = 30.0):
        self._lib = load()
        self._h = self._lib.tpu_breaker_create(
            failure_threshold, success_threshold, float(timeout_seconds))

    def allow_request(self) -> bool:
        return bool(self._lib.tpu_breaker_allow(self._h))

    def record_success(self) -> None:
        self._lib.tpu_breaker_success(self._h)

    def record_failure(self) -> None:
        self._lib.tpu_breaker_failure(self._h)

    @property
    def state(self) -> CircuitState:
        return self._STATES[self._lib.tpu_breaker_state(self._h)]

    @property
    def failure_count(self) -> int:
        return self._lib.tpu_breaker_failures(self._h)

    @property
    def success_count(self) -> int:
        return self._lib.tpu_breaker_successes(self._h)

    def state_name(self) -> str:
        return self.state.value


class NativeBatchQueue(_Handle):
    """MPMC batch queue; the timed ``pop_batch`` wait releases the GIL."""

    _destroy = "tpu_bq_destroy"

    def __init__(self, max_batch: int, timeout_s: float):
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        self._lib = load()
        self._max = int(max_batch)
        self._h = self._lib.tpu_bq_create(self._max, float(timeout_s))

    def push(self, payload: bytes) -> int:
        """The ticket, or -1 once the queue is closed."""
        return self._lib.tpu_bq_push(self._h, payload, len(payload))

    def pop_batch(self):
        """(items, timed_out): items a list of (ticket, payload), or None
        once the queue is closed and drained."""
        bufs = (ctypes.c_void_p * self._max)()
        lens = (ctypes.c_size_t * self._max)()
        tickets = (ctypes.c_longlong * self._max)()
        timed_out = ctypes.c_int()
        n = self._lib.tpu_bq_pop_batch(self._h, bufs, lens, tickets,
                                       self._max, ctypes.byref(timed_out))
        if n < 0:
            return None, bool(timed_out.value)
        items = [(tickets[i], _take_bytes(self._lib,
                                          ctypes.c_void_p(bufs[i]), lens[i]))
                 for i in range(n)]
        return items, bool(timed_out.value)

    def close(self) -> None:
        self._lib.tpu_bq_close(self._h)

    def size(self) -> int:
        return self._lib.tpu_bq_size(self._h)


class NativeHttpFront:
    """The C++ HTTP front (``native/http_front.h``): /infer cache hits
    answered in C++ (its own ring of the lanes, 150 virtual nodes, over
    ``request_id``; the lane's raw-mode cache keyed by the input's float32
    bytes; the lane's breaker gating and counting the hit), everything
    else through ``fallback(method, path, body) -> (status, bytes[,
    content_type])``, called on the front's connection threads. No
    exception crosses the callback: one becomes a 500."""

    def __init__(self, port: int, fallback, virtual_nodes: int = 150,
                 fake_cached_latency_us: int = 50):
        self._lib = lib = load()
        self._h = lib.tpu_front_create(port, virtual_nodes,
                                       fake_cached_latency_us)
        self.port = port
        # The C side only borrows the lanes' caches and breakers: they
        # live as long as the front (a removed lane keeps its), by name.
        self._held: dict = {}

        def handler(reply_ctx, method, path, body, body_len):
            ctype = None
            try:
                result = fallback(method.decode(), path.decode(),
                                  ctypes.string_at(body, body_len)
                                  if body_len else b"")
                status, payload = result[0], result[1]
                if len(result) == 3:
                    ctype = result[2]
            except Exception as exc:
                status, payload = 500, (b'{"error": '
                                        + json.dumps(str(exc)).encode()
                                        + b"}")
            try:
                if ctype is not None:
                    lib.tpu_front_reply2(reply_ctx, status, payload,
                                         len(payload), ctype.encode())
                else:
                    lib.tpu_front_reply(reply_ctx, status, payload,
                                        len(payload))
            except Exception:
                pass  # the slot keeps its 500 "did not reply" body

        # The C side keeps the raw function pointer: keep the object alive.
        self._handler_ref = HANDLER_FN(handler)
        lib.tpu_front_set_handler(self._h, self._handler_ref)

    def add_lane(self, name: str, cache: NativeLRUCache,
                 breaker: Optional[NativeCircuitBreaker] = None) -> None:
        if not (isinstance(cache, NativeLRUCache) and cache.raw):
            raise ValueError("front lanes need a raw-mode NativeLRUCache")
        if breaker is not None and not isinstance(breaker,
                                                  NativeCircuitBreaker):
            raise ValueError("front lanes need a NativeCircuitBreaker "
                             "(the hit path gates on it)")
        self._held.setdefault(name, []).append((cache, breaker))
        self._lib.tpu_front_add_lane(
            self._h, name.encode(), cache.handle,
            breaker._h if breaker is not None else None)

    def remove_lane(self, name: str) -> None:
        """Take lane ``name`` out of the front's ring: no hit is answered
        or counted for it afterwards. Its cache and breaker stay held, since
        a hit in flight may still read them, but the cache is emptied, so
        that a fleet that retires lanes keeps no answers of theirs."""
        self._lib.tpu_front_remove_lane(self._h, name.encode())
        for cache, _breaker in self._held.get(name, ()):
            cache.clear()

    def ring_nodes(self) -> List[str]:
        """The lanes of the front's ring, in failover order."""
        return _take_names(self._lib, self._lib.tpu_front_ring_nodes,
                           self._h)

    def set_lane_enabled(self, name: str, enabled: bool) -> None:
        self._lib.tpu_front_set_lane_enabled(self._h, name.encode(),
                                             1 if enabled else 0)

    def start(self) -> int:
        """Bind and serve; returns the bound port (``port=0``: any)."""
        port = self._lib.tpu_front_start(self._h)
        if port < 0:
            raise OSError(f"native front failed to bind port {self.port}")
        self.port = port
        return port

    def stop(self) -> None:
        """Close the listener and every connection, joining their threads
        (idempotent)."""
        if self._h:
            self._lib.tpu_front_stop(self._h)

    def lane_counters(self, name: str):
        """(requests, hits) the C++ hit path served for lane ``name``."""
        n = name.encode()
        return (int(self._lib.tpu_front_lane_total(self._h, n)),
                int(self._lib.tpu_front_lane_hits(self._h, n)))

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.tpu_front_stop(h)
            lib.tpu_front_destroy(h)
            self._h = None
