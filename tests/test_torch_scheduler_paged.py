"""The port's two-path paged scheduler and its int8 KV pool
(tpu_engine_torch.runtime.scheduler, ``mixed_step=False`` and
``kv_quantize="int8"``) against the JAX package's, on the CPU, with the
same weights (carried across with models.convert.params_from_jax) and the
JAX scheduler's two-path configuration at ``step_chunk=4``:

- greedy streams equal the JAX scheduler's on tests/test_paged_kv.py's
  workloads: a short prompt, staggered admissions, oversubscription,
  shared prefixes (sequential and co-resident), controls, pool pressure
  with eviction, prefix sharing off;
- with the int8 pool, in both modes, greedy streams equal JAX's int8
  streams on tests/test_kv_quant.py's prompts, and the pools' int8 bytes
  are equal or one step apart (a K/V value at a rounding tie after
  differently ordered f32 sums; the test allows it, though none has
  shown), with scales within 1e-5 relative;
- seeded sampled streams equal JAX's token for token;
- the stats() schema equals JAX's (the idle prefix cache too), chunks
  count two-path decode chunks, and no block leaks once idle;
- cancellation, a failed chunk's recovery (payload and scales rebuilt).
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
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

_ensure_builtin_models_imported()

KW = dict(dtype="float32", n_slots=4, step_chunk=4, max_seq=128,
          kv_block_size=16, prefill_chunk=16)
LEFT_OUT = set()
SHARED = [(i * 7) % 90 + 1 for i in range(32)]
QUANT_PROMPTS = [[5, 9, 3, 7], [7, 2], list(range(1, 20)), [42] * 9]
QUANT_MODES = {"two-path": {}, "mixed": dict(mixed_step=True,
                                             mixed_token_budget=16)}


@pytest.fixture(scope="module")
def params():
    return jcreate("gpt2-small-test", max_seq=128).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def spec():
    return tcreate("gpt2-small-test", max_seq=128)


@pytest.fixture(scope="module")
def tparams(params, spec):
    return convert.params_from_jax(jax.tree.map(np.asarray, params),
                                   spec.config, device="cpu")


def _pair(params, spec, tparams, **overrides):
    kw = dict(KW, **overrides)
    return (JaxGen(jcreate("gpt2-small-test", max_seq=kw["max_seq"]),
                   params=params, **kw),
            ContinuousGenerator(spec, params=tparams, device="cpu", **kw))


@pytest.fixture(scope="module")
def gens(params, spec, tparams):
    j, t = _pair(params, spec, tparams)
    yield j, t
    j.stop()
    t.stop()


def _wait_idle(g, timeout=20.0):
    deadline = time.time() + timeout
    while True:
        st = g.stats()
        pool = st["kv_pool"]
        if (st["active"] == 0 and pool["blocks_free"] + pool["radix_nodes"]
                == pool["blocks_total"]) or time.time() > deadline:
            return st
        time.sleep(0.01)


def _run(g, name):
    """One workload of tests/test_paged_kv.py on scheduler ``g``."""
    if name == "short":
        return g.generate([[5, 9, 3]], max_new_tokens=6)
    if name == "staggered":
        f1 = g.submit([5, 9, 3], max_new_tokens=10)
        time.sleep(0.05)
        f2 = g.submit([7, 2], max_new_tokens=6)
        f3 = g.submit([1, 4, 4, 2], max_new_tokens=8)
        return [f.result(60) for f in (f1, f2, f3)]
    if name == "oversubscription":
        return g.generate([[i + 1, i + 2] for i in range(9)],
                          max_new_tokens=5)
    if name == "shared-prefix":
        return [g.generate([p], max_new_tokens=6)[0]
                for p in (SHARED + [91, 92, 93], SHARED + [81, 82],
                          SHARED + [91, 92, 93])]
    if name == "controls":
        return [g.generate([[5, 9, 3]], max_new_tokens=8,
                           repetition_penalty=1.3)[0],
                g.generate([[5, 9, 3]], max_new_tokens=8,
                           stop_tokens=[7])[0],
                g.generate([[5, 9, 3]], max_new_tokens=8, eos_id=50)[0]]
    raise KeyError(name)


@pytest.mark.parametrize("workload", ["short", "staggered",
                                      "oversubscription", "shared-prefix",
                                      "controls"])
def test_greedy_streams_match_jax(gens, workload):
    jgen, tgen = gens
    hits0 = tgen.stats()["kv_pool"]["prefix_hit_tokens"]
    assert _run(tgen, workload) == _run(jgen, workload)
    if workload == "shared-prefix":
        assert tgen.stats()["kv_pool"]["prefix_hit_tokens"] >= hits0 + 32


def test_coresident_shared_prefix_rows_match_jax(params, spec, tparams):
    """After the first admission indexes a 16-token system prefix, later
    co-resident admissions map onto its blocks; every stream matches."""
    shared = [(i * 5) % 90 + 1 for i in range(16)]
    prompts = [shared + [50 + i] for i in range(4)]
    outs = []
    for g in _pair(params, spec, tparams):
        try:
            first = g.submit(prompts[0], max_new_tokens=12)
            time.sleep(0.2)
            rest = [g.submit(p, max_new_tokens=12) for p in prompts[1:]]
            outs.append([first.result(60)] + [f.result(60) for f in rest])
            assert g.stats()["kv_pool"]["prefix_hit_tokens"] >= 16
        finally:
            g.stop()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("overrides", [
    dict(n_slots=2, max_seq=64, kv_blocks=9),       # pressure: evictions
    dict(n_slots=2, prefix_sharing=False),          # sharing off
], ids=["pool-pressure", "sharing-off"])
def test_pool_configurations_match_jax(params, spec, tparams, overrides):
    prompts = [[(i * 13 + j) % 90 + 1 for j in range(36)] for i in range(6)]
    outs, stats = [], []
    for g in _pair(params, spec, tparams, **overrides):
        try:
            outs.append(g.generate(prompts, max_new_tokens=5))
            stats.append(_wait_idle(g) if isinstance(g, ContinuousGenerator)
                         else g.stats())
        finally:
            g.stop()
    assert outs[1] == outs[0]
    pool = stats[1]["kv_pool"]
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]
    assert stats[1].get("pool_starved", 0) == 0
    if "kv_blocks" in overrides:
        assert pool["evictions"] > 0
    else:
        assert pool["radix_nodes"] == 0 and pool["prefix_hit_tokens"] == 0


def test_two_thread_stress_streams_and_no_leaks(spec, tparams):
    """Both threads touch the pool (the prefill thread's lookups, pins and
    gathers, the decode thread's allocations, scatters and chunks) under
    its lock: sixteen concurrent requests with shared prefixes, more than
    the rows and than the cores, with a short switch interval, each give
    the stream they give alone, and the idle pool holds no leaked block or
    pin."""
    import sys

    prefixes = [[(i * 7 + k) % 90 + 1 for i in range(32)] for k in range(3)]
    prompts = [prefixes[i % 3] + [50 + i] for i in range(16)]
    g = ContinuousGenerator(spec, params=tparams, device="cpu",
                            **dict(KW, kv_blocks=40))
    interval = sys.getswitchinterval()
    try:
        alone = [g.generate([p], max_new_tokens=5)[0] for p in prompts]
        sys.setswitchinterval(1e-5)
        futs = [g.submit(p, max_new_tokens=5) for p in prompts]
        assert [f.result(120) for f in futs] == alone
    finally:
        sys.setswitchinterval(interval)
        st = _wait_idle(g)
        g.stop()
    pool = st["kv_pool"]
    assert st["active"] == 0 and pool["pending_admissions"] == 0
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]
    assert st["admitted"] == st["completed"] == 32


def test_seeded_streams_match_jax(gens):
    jgen, tgen = gens
    for seed, temp, top_p, top_k in ((7, 0.8, 1.0, 0), (11, 1.0, 0.9, 0),
                                     (3, 0.7, 1.0, 5)):
        kw = dict(max_new_tokens=8, temperature=temp, seed=seed,
                  top_p=top_p, top_k=top_k)
        want = jgen.generate([[5, 9, 3, 2]], **kw)[0]
        assert tgen.generate([[5, 9, 3, 2]], **kw)[0] == want
    kw = dict(max_new_tokens=8, repetition_penalty=1.3, seed=5,
              temperature=0.9)
    assert (tgen.generate([[5, 9, 3]], **kw)[0]
            == jgen.generate([[5, 9, 3]], **kw)[0])


def test_stats_schema_chunks_and_no_leaks(gens):
    jgen, tgen = gens
    chunks0 = tgen.stats()["chunks"]
    tgen.generate([[1, 2, 3]], max_new_tokens=9)
    jgen.generate([[1, 2, 3]], max_new_tokens=9)
    st = _wait_idle(tgen)
    jst = jgen.stats()
    assert set(st) == set(jst) - LEFT_OUT
    assert "mixed" not in st
    assert set(st["kv_pool"]) == set(jst["kv_pool"])
    # Nine tokens: the first from the prefill, eight in two 4-step chunks.
    assert st["chunks"] >= chunks0 + 2
    pool = st["kv_pool"]
    assert st["active"] == 0
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]


def test_cancelled_rows_return_blocks(gens):
    _, tgen = gens
    want = tgen.generate([[5, 9, 3]], max_new_tokens=4)[0]
    cancelled0 = tgen.stats().get("cancelled", 0)
    streams = [queue.Queue() for _ in range(3)]
    futs = [tgen.submit([(i * 17 + j) % 90 + 1 for j in range(40)],
                        max_new_tokens=60, stream=s)
            for i, s in enumerate(streams)]
    for s in streams:  # each row has decoded its first token
        assert s.get(timeout=30)
    assert all(f.cancel() for f in futs)
    for s in streams:  # every stream ends
        while s.get(timeout=20) is not None:
            pass
    st = _wait_idle(tgen)
    pool = st["kv_pool"]
    assert st["active"] == 0
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]
    assert st["cancelled"] == cancelled0 + 3
    assert tgen.generate([[5, 9, 3]], max_new_tokens=4)[0] == want


def test_failed_chunk_recovers_and_keeps_serving(spec, tparams,
                                                 monkeypatch):
    import tpu_engine_torch.runtime.scheduler as sched

    g = ContinuousGenerator(spec, params=tparams, device="cpu",
                            kv_quantize="int8", **KW)
    try:
        want = g.generate([[5, 9, 3]], max_new_tokens=6)[0]
        real = sched.transformer_decode_rows_paged
        calls = {"n": 0}

        def flaky(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 6:
                raise RuntimeError("injected device fault")
            return real(*args, **kw)

        monkeypatch.setattr(sched, "transformer_decode_rows_paged", flaky)
        fut = g.submit([7, 8, 9], max_new_tokens=20)
        with pytest.raises(RuntimeError, match="injected device fault") as ei:
            fut.result(30)
        assert ei.value.retryable and ei.value.tokens_emitted >= 1
        st = g.stats()
        assert st["failures"] == 1 and st["kv_pool"]["radix_nodes"] == 0
        assert bool((g._pool.scales.k == 1.0).all())
        assert g.generate([[5, 9, 3]], max_new_tokens=6)[0] == want
    finally:
        g.stop()


@pytest.mark.parametrize("mode", sorted(QUANT_MODES))
def test_int8_streams_and_pool_bytes_match_jax(params, spec, tparams, mode):
    kw = dict(kv_blocks=30, kv_quantize="int8", **QUANT_MODES[mode])
    jgen, tgen = _pair(params, spec, tparams, **kw)
    try:
        # One request at a time: both pools then hand out the same blocks.
        for prompt in QUANT_PROMPTS:
            want = jgen.generate([prompt], max_new_tokens=16)[0]
            assert tgen.generate([prompt], max_new_tokens=16)[0] == want
        seeded = dict(max_new_tokens=12, temperature=0.8, seed=7)
        assert (tgen.generate(QUANT_PROMPTS[:1], **seeded)
                == jgen.generate(QUANT_PROMPTS[:1], **seeded))
        st = _wait_idle(tgen)
        jst = jgen.stats()
        assert set(st) == set(jst) - LEFT_OUT
        assert st["kv_pool"] == {**jst["kv_pool"],
                                 "evictions": st["kv_pool"]["evictions"]}
        jpool, tpool = jgen._pool, tgen._pool
        assert tpool.caches.k.dtype == torch.int8
        for j, t in ((jpool.caches.k, tpool.caches.k),
                     (jpool.caches.v, tpool.caches.v)):
            diff = np.abs(t.numpy()[:, 1:].astype(np.int32)
                          - np.asarray(j)[:, 1:].astype(np.int32))
            assert diff.max() <= 1
        for j, t in ((jpool.scales.k, tpool.scales.k),
                     (jpool.scales.v, tpool.scales.v)):
            np.testing.assert_allclose(t.numpy()[:, 1:],
                                       np.asarray(j)[:, 1:], rtol=1e-5)
    finally:
        jgen.stop()
        tgen.stop()


def test_int8_radix_hit_stream_equals_cold(spec, tparams):
    """A radix-hit admission (dequantized gather, windows resumed past the
    shared int8 blocks) emits the cold admission's stream."""
    prompt = [(j * 11) % 90 + 1 for j in range(32)] + [3, 1]
    g = ContinuousGenerator(spec, params=tparams, device="cpu",
                            kv_quantize="int8", **KW)
    try:
        cold = g.generate([prompt], max_new_tokens=12)[0]
        warm = g.generate([prompt], max_new_tokens=12)[0]
        st = g.stats()["kv_pool"]
        assert st["radix_hits"] >= 1 and st["prefix_hit_tokens"] > 0
        assert warm == cold
    finally:
        g.stop()


def test_kv_quantize_needs_the_paged_cache(spec, tparams):
    with pytest.raises(ValueError, match="kv_quantize requires"):
        ContinuousGenerator(spec, params=tparams, device="cpu",
                            **dict(KW, kv_block_size=0, kv_quantize="int8"))
    with pytest.raises(ValueError, match="unsupported KV quantize"):
        ContinuousGenerator(spec, params=tparams, device="cpu",
                            **dict(KW, kv_quantize="fp4"))
