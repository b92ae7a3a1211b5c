"""The port's dense ContinuousGenerator (``kv_block_size`` 0, the worker's
default lane) against the JAX package's, on the CPU, with the same weights
(carried across with models.convert.params_from_jax), on the workloads of
tests/test_scheduler.py, tests/test_prefix_cache.py,
tests/test_chunked_prefill.py, tests/test_stopping.py and
tests/test_sliding_window.py:

- greedy and seeded streams are the JAX scheduler's token for token (and
  greedy equals the port's own full forward);
- the prefix cache's stats, ``admission_dispatches`` and (for sequential
  requests, where their number does not depend on thread timing)
  ``chunks`` equal JAX's; the stats() schema equals JAX's, nothing left
  out; the cache's byte count equals JAX's at the same shapes;
- a cancelled Future frees its row; a failed chunk fails the in-flight
  rows retryable, rebuilds the cache and keeps serving.
"""

import queue
import time

import jax
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine.runtime.scheduler import _PrefixCache as JaxPrefixCache
from tpu_engine_torch.models import convert
from tpu_engine_torch.models import transformer as tt
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.scheduler import (
    ContinuousGenerator,
    _PrefixCache,
)

_ensure_builtin_models_imported()

KW = dict(dtype="float32", n_slots=4, step_chunk=4)
LEFT_OUT = set()
PROMPTS = [[5, 9, 12, 7], [3, 3, 3]]
WINDOW_PROMPT = [5, 9, 12, 7, 3, 8, 1, 4, 2, 6, 11, 13]  # past window 8


def _models(name):
    params = jcreate(name).init(jax.random.PRNGKey(0))
    spec = tcreate(name)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      spec.config, device="cpu")
    return params, spec, tparams


@pytest.fixture(scope="module")
def models():
    return _models("gpt2-small-test")


def _pair(models, name="gpt2-small-test", **overrides):
    params, spec, tparams = models
    kw = dict(KW, **overrides)
    return (JaxGen(jcreate(name), params=params, **kw),
            ContinuousGenerator(spec, params=tparams, device="cpu", **kw))


@pytest.fixture(scope="module")
def gens(models):
    j, t = _pair(models, prefix_cache_mb=16)
    yield j, t
    j.stop()
    t.stop()


def _greedy_ref(tparams, spec, prompt, n):
    """Greedy decoding by the port's full forward, one token at a time."""
    seq = list(prompt)
    for _ in range(n):
        logits = tt.transformer_apply(
            tparams, torch.tensor([seq], dtype=torch.int32), spec.config,
            dtype=torch.float32)
        seq.append(int(logits[0, -1].argmax()))
    return seq[len(prompt):]


def _wait_idle(g, timeout=20.0):
    deadline = time.time() + timeout
    while g.stats()["active"] and time.time() < deadline:
        time.sleep(0.01)
    return g.stats()


def _staggered(g):
    f1 = g.submit([5, 9, 3], max_new_tokens=10)
    time.sleep(0.05)
    f2 = g.submit([7, 2], max_new_tokens=6)
    time.sleep(0.02)
    f3 = g.submit([1, 4, 4, 2], max_new_tokens=8)
    return [f.result(60) for f in (f1, f2, f3)]


def _seeded_with_noise(g):
    noise = g.submit([2, 8], max_new_tokens=12, temperature=1.0, seed=1)
    got = g.submit([5, 9, 3], max_new_tokens=6, temperature=0.8,
                   seed=7).result(60)
    return [got, noise.result(60)]


def _hit_sampling(g):
    prompt = [8, 1, 4]
    g.generate([prompt], max_new_tokens=4, seed=3, temperature=0.9)
    return [g.generate([prompt], max_new_tokens=4, seed=s,
                       temperature=0.9)[0] for s in (11, 22, 33, 44, 55)]


WORKLOADS = {
    "staggered": _staggered,
    "more-than-slots": lambda g: g.generate([[i + 1, i + 2]
                                             for i in range(9)],
                                            max_new_tokens=5),
    "seeded-with-noise": _seeded_with_noise,
    "repeat-hit": lambda g: [g.generate([[5, 9, 3, 7]], max_new_tokens=6,
                                        seed=1)[0] for _ in range(2)],
    "hit-sampling": _hit_sampling,
    "different-prompts": lambda g: [g.generate([p], max_new_tokens=3)[0]
                                    for p in ([9, 9, 9, 1], [9, 9, 9, 2])],
    "leading-zero": lambda g: [g.generate([p], max_new_tokens=4, seed=2)[0]
                               for p in ([5], [0, 5], [5], [0, 5])],
    "penalty": lambda g: g.generate(PROMPTS, max_new_tokens=8,
                                    repetition_penalty=1.5, seed=[1, 2]),
    "stops": lambda g: g.generate(PROMPTS, max_new_tokens=10,
                                  stop_tokens=[7]),
    "min-p": lambda g: g.generate(PROMPTS, max_new_tokens=8,
                                  temperature=1.5, min_p=0.3, seed=[4, 5]),
    "long-prompt": lambda g: g.generate([[(i * 7) % 90 + 1
                                          for i in range(40)]],
                                        max_new_tokens=8),
}


def test_greedy_matches_full_forward_and_jax(gens, models):
    jgen, tgen = gens
    _, spec, tparams = models
    got = tgen.generate([[5, 9, 3]], max_new_tokens=6)[0]
    assert got == _greedy_ref(tparams, spec, [5, 9, 3], 6)
    assert got == jgen.generate([[5, 9, 3]], max_new_tokens=6)[0]


def _counters(g) -> dict:
    st = _wait_idle(g)
    return {"admission_dispatches": st.get("admission_dispatches", 0),
            **st["prefix_cache"]}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_workloads_match_jax(gens, workload):
    """Each workload's streams, and what it adds to the prefix cache's
    counts and to admission_dispatches, equal the JAX scheduler's."""
    jgen, tgen = gens
    before = [_counters(g) for g in gens]
    got = WORKLOADS[workload](tgen)
    assert got == WORKLOADS[workload](jgen)
    (j0, t0), (j1, t1) = before, [_counters(g) for g in gens]
    assert {k: t1[k] - t0[k] for k in t1} == {k: j1[k] - j0[k] for k in j1}
    if workload == "hit-sampling":
        assert len(set(map(tuple, got))) > 1  # seeds vary the stream


def test_sequential_requests_count_like_jax(models):
    """One request at a time: every counter, chunks included, and the whole
    stats() schema equal the JAX scheduler's."""
    jgen, tgen = _pair(models, prefix_cache_mb=16)
    try:
        for g in (jgen, tgen):
            for p in ([5, 9, 3], [5, 9, 3], [7, 2], [(i * 3) % 90
                                                      for i in range(30)]):
                g.generate([p], max_new_tokens=9)
        tst, jst = _wait_idle(tgen), _wait_idle(jgen)
        assert set(tst) == set(jst) - LEFT_OUT
        for key in ("admitted", "completed", "chunks",
                    "admission_dispatches", "prefix_cache", "n_slots",
                    "active"):
            assert tst[key] == jst[key], key
        assert tst["prefix_cache"]["hits"] == 1
        assert "kv_pool" not in tst and "mixed" not in tst
    finally:
        jgen.stop()
        tgen.stop()


def test_eos_frees_slot(models):
    _, spec, tparams = models
    jgen, tgen = _pair(models, n_slots=2)
    try:
        full = _greedy_ref(tparams, spec, [7, 2], 8)
        k = next(i for i in range(1, len(full)) if full[i] not in full[:i])
        for g in (tgen, jgen):
            got = g.submit([7, 2], max_new_tokens=8,
                           eos_id=full[k]).result(60)
            assert got == full[:k]
            again = g.submit([11, 13], max_new_tokens=4).result(60)
            assert again == _greedy_ref(tparams, spec, [11, 13], 4)
            assert _wait_idle(g)["active"] == 0
    finally:
        jgen.stop()
        tgen.stop()


def test_prefix_cache_bytes_equal_jax():
    """Entry sizes count numel * element_size: equal to the JAX cache's at
    the same shapes and dtypes, with the same LRU eviction."""
    import collections

    import jax.numpy as jnp

    jkv = collections.namedtuple("Item", "k v")
    tkv = tt.KVCache
    shape = (2, 1, 32, 2, 16)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        entry = 256 * 4 + 2 * int(np.prod(shape)) * dtype.itemsize
        tcache = _PrefixCache(budget_bytes=2 * entry + 100)
        jcache = JaxPrefixCache(budget_bytes=2 * entry + 100)
        tl, jl = torch.zeros((256,)), jnp.zeros((256,), jnp.float32)
        for key in ("a", "b", "c"):
            tcache.put((key,), tl, tkv(torch.zeros(shape, dtype=dtype),
                                       torch.zeros(shape, dtype=dtype)))
            jcache.put((key,), jl, jkv(jnp.zeros(shape, jdtype),
                                       jnp.zeros(shape, jdtype)))
        assert tcache.stats() == jcache.stats()
        assert tcache.bytes == 2 * entry
        assert tcache.get(("a",)) is None and jcache.get(("a",)) is None
        assert tcache.get(("c",)) is not None
        assert jcache.get(("c",)) is not None
        assert tcache.stats() == jcache.stats()


def test_prefix_cache_eviction_and_oversized_entry():
    kv = tt.KVCache(torch.zeros((100,)), torch.zeros((100,)))
    cache = _PrefixCache(budget_bytes=3000)
    cache.put(("a",), torch.zeros((250,)), kv)   # 1000 + 800 B
    cache.put(("b",), torch.zeros((250,)), kv)
    assert cache.bytes <= 3000
    assert cache.get(("a",)) is None and cache.get(("b",)) is not None
    small = _PrefixCache(budget_bytes=100)
    small.put(("big",), torch.zeros((250,)), kv)
    assert small.bytes == 0 and small.get(("big",)) is None


def test_disabled_prefix_cache(models):
    jgen, tgen = _pair(models, n_slots=2, prefix_cache_mb=0)
    try:
        for g in (tgen, jgen):
            a = g.generate([[4, 4, 2]], max_new_tokens=4)
            assert g.generate([[4, 4, 2]], max_new_tokens=4) == a
        assert (tgen.stats()["prefix_cache"] == jgen.stats()["prefix_cache"]
                == {"entries": 0, "bytes": 0, "hits": 0, "misses": 0})
    finally:
        jgen.stop()
        tgen.stop()


def test_prefix_cache_entry_is_copied_not_aliased(gens):
    """A hit splices a copy: decoding from it leaves the cached row cache
    as it was, so the next hit gives the same stream."""
    _, tgen = gens
    prompt = [(i * 5) % 90 + 1 for i in range(20)]
    first = tgen.generate([prompt], max_new_tokens=12)[0]
    key = next(k for k in tgen._prefix_cache._items if k[1] == len(prompt))
    _, rc, _ = tgen._prefix_cache._items[key]
    before = (rc.k.clone(), rc.v.clone())
    assert tgen.generate([prompt], max_new_tokens=12)[0] == first
    assert torch.equal(rc.k, before[0]) and torch.equal(rc.v, before[1])
    assert rc.k.data_ptr() != tgen._caches.k.data_ptr()


@pytest.mark.parametrize("chunk", [16, 24], ids=["divisor", "non-divisor"])
def test_chunked_prefill_matches_monolithic_and_jax(models, chunk):
    """Windows of ``chunk`` (bucket 64 -> 16 x 4, or 24, 24, 16) give the
    monolithic prefill's streams and the JAX scheduler's counts."""
    prompts = [[7, 3], list(range(1, 17)), [5, 9] * 20]
    jgen, tgen = _pair(models, n_slots=2, prefill_chunk=chunk,
                       prefix_cache_mb=0)
    _, mono = _pair(models, n_slots=2, prefill_chunk=0, prefix_cache_mb=0)
    try:
        for p in prompts:
            want = jgen.generate([p], max_new_tokens=8, seed=5)
            assert tgen.generate([p], max_new_tokens=8, seed=5) == want
            assert mono.generate([p], max_new_tokens=8, seed=5) == want
        seeded = dict(max_new_tokens=6, temperature=0.8, seed=[1, 2, 3])
        assert tgen.generate(prompts, **seeded) == mono.generate(prompts,
                                                                 **seeded)
        tst, jst = _wait_idle(tgen), _wait_idle(jgen)
        assert tst["admission_dispatches"] >= mono.stats()[
            "admission_dispatches"]
    finally:
        jgen.stop()
        tgen.stop()
        mono.stop()


def test_sequential_chunked_counts_equal_jax(models):
    jgen, tgen = _pair(models, n_slots=2, prefill_chunk=16)
    try:
        for g in (jgen, tgen):
            for p in ([5, 9] * 20, [5, 9] * 20, [7, 3]):
                g.generate([p], max_new_tokens=6, seed=4)
        tst, jst = _wait_idle(tgen), _wait_idle(jgen)
        for key in ("chunks", "admission_dispatches", "prefix_cache"):
            assert tst[key] == jst[key], key
        assert tst["prefix_cache"]["hits"] == 1
    finally:
        jgen.stop()
        tgen.stop()


@pytest.mark.parametrize("chunk", [8, 0], ids=["windows", "monolithic"])
def test_sliding_window_streams_match_jax(chunk):
    """mistral-small-test (window 8, narrower than the prompt): chunked and
    monolithic admission give the JAX scheduler's streams."""
    models = _models("mistral-small-test")
    jgen, tgen = _pair(models, "mistral-small-test", n_slots=2,
                       prefill_chunk=chunk, prefix_cache_mb=0)
    try:
        for kw in (dict(seed=3), dict(seed=3, temperature=0.8)):
            want = jgen.generate([WINDOW_PROMPT], max_new_tokens=10, **kw)
            assert tgen.generate([WINDOW_PROMPT], max_new_tokens=10,
                                 **kw) == want
    finally:
        jgen.stop()
        tgen.stop()


def test_cancelled_future_frees_its_row(gens):
    _, tgen = gens
    want = tgen.generate([[5, 9, 3]], max_new_tokens=4)[0]
    cancelled0 = tgen.stats().get("cancelled", 0)
    streams = [queue.Queue() for _ in range(3)]
    futs = [tgen.submit([(i * 17 + j) % 90 + 1 for j in range(20)],
                        max_new_tokens=40, stream=s)
            for i, s in enumerate(streams)]
    for s in streams:  # each row has its first token
        assert s.get(timeout=30)
    assert all(f.cancel() for f in futs)
    for s in streams:  # every stream ends
        while s.get(timeout=20) is not None:
            pass
    st = _wait_idle(tgen)
    assert st["active"] == 0 and st["cancelled"] == cancelled0 + 3
    assert tgen.generate([[5, 9, 3]], max_new_tokens=4)[0] == want


def test_failed_chunk_recovers_and_keeps_serving(models, monkeypatch):
    import tpu_engine_torch.runtime.scheduler as sched

    _, spec, tparams = models
    g = ContinuousGenerator(spec, params=tparams, device="cpu", **KW)
    try:
        want = g.generate([[5, 9, 3]], max_new_tokens=6)[0]
        real = sched.transformer_decode_rows
        calls = {"n": 0}

        def flaky(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 6:
                raise RuntimeError("injected device fault")
            return real(*args, **kw)

        monkeypatch.setattr(sched, "transformer_decode_rows", flaky)
        old_cache = g._caches.k
        fut = g.submit([7, 8, 9], max_new_tokens=20)
        with pytest.raises(RuntimeError, match="injected device fault") as ei:
            fut.result(30)
        assert ei.value.retryable and ei.value.tokens_emitted >= 1
        deadline = time.time() + 10  # the rows fail before the rebuild
        while g._caches.k is old_cache and time.time() < deadline:
            time.sleep(0.01)
        st = g.stats()
        assert st["failures"] == 1 and st["active"] == 0
        assert not g._start.any() and not g._caches.k.any()
        assert g.generate([[5, 9, 3]], max_new_tokens=6)[0] == want
    finally:
        g.stop()


def test_counts_buffer_lazy(models):
    _, spec, tparams = models
    g = ContinuousGenerator(spec, params=tparams, device="cpu",
                            prefill_chunk=0, prefix_cache_mb=0, **KW)
    try:
        g.generate([[5, 9]], max_new_tokens=4)
        assert g._counts is None
        g.generate([[5, 9]], max_new_tokens=4, repetition_penalty=1.5)
        assert g._counts is not None
    finally:
        g.stop()
