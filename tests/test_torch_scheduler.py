"""The port's mixed-step ContinuousGenerator (tpu_engine_torch.runtime.
scheduler) against the JAX package's, on the CPU, with the fixture of
tests/test_mixed_step.py and the same weights (carried across with
models.convert.params_from_jax): token-identical greedy streams on its
workloads, the same stats() schema, ticks == dispatches, no leaked
blocks, cancelled rows that return their blocks, and seeded streams that
are the JAX scheduler's token for token, deterministic and independent
of batching. The two-path mode and the int8 pool are
tests/test_torch_scheduler_paged.py."""

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

KW = dict(dtype="float32", n_slots=4, max_seq=128, kv_block_size=16,
          prefill_chunk=16, mixed_step=True, mixed_token_budget=16)
# stats() keys of the JAX scheduler that belong to modes the port leaves
# out: none (the prefix cache is carried, idle, in every mode).
LEFT_OUT = set()

SHARED = [(i * 11) % 90 + 1 for i in range(32)]
WORKLOADS = {
    "short": [([5, 9, 3], 6)],
    "chunk-crossing": [([(i * 7) % 90 + 1 for i in range(40)], 5)],
    "shared-prefix": [(SHARED + [91, 92, 93], 5), (SHARED + [81, 82], 5)],
    "whole-prompt-repeat": [([(i * 5) % 90 + 1 for i in range(32)], 4)] * 2,
}


@pytest.fixture(scope="module")
def params():
    return jcreate("gpt2-small-test", max_seq=128).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_gen(params):
    g = JaxGen(jcreate("gpt2-small-test", max_seq=128), params=params,
               step_chunk=4, **KW)
    yield g
    g.stop()


@pytest.fixture(scope="module")
def spec():
    return tcreate("gpt2-small-test", max_seq=128)


@pytest.fixture(scope="module")
def tparams(params, spec):
    return convert.params_from_jax(jax.tree.map(np.asarray, params),
                                   spec.config, device="cpu")


@pytest.fixture(scope="module")
def gen(spec, tparams):
    g = ContinuousGenerator(spec, params=tparams, device="cpu", **KW)
    yield g
    g.stop()


def _wait_idle(g, timeout=20.0):
    deadline = time.time() + timeout
    while True:
        st = g.stats()
        pool = st["kv_pool"]
        if (st["active"] == 0 and pool["blocks_free"] + pool["radix_nodes"]
                == pool["blocks_total"]) or time.time() > deadline:
            return st
        time.sleep(0.01)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_greedy_streams_match_jax(jax_gen, gen, workload):
    hits0 = gen.stats()["kv_pool"]["prefix_hit_tokens"]
    cow0 = gen.stats()["kv_pool"]["cow_copies"]
    for prompt, n in WORKLOADS[workload]:
        want = jax_gen.generate([prompt], max_new_tokens=n)[0]
        assert gen.generate([prompt], max_new_tokens=n)[0] == want
    pool = gen.stats()["kv_pool"]
    if workload == "shared-prefix":
        # The second admission resumed mid-prompt on the first's blocks.
        assert pool["prefix_hit_tokens"] >= hits0 + 32
    if workload == "whole-prompt-repeat":
        assert pool["cow_copies"] > cow0


def test_concurrent_batch_and_controls_match_jax(jax_gen, gen):
    prompts = [[5, 9, 3], [(i * 7) % 90 + 1 for i in range(40)],
               SHARED + [7]]
    assert (gen.generate(prompts, max_new_tokens=6)
            == jax_gen.generate(prompts, max_new_tokens=6))
    for kw in (dict(repetition_penalty=1.3), dict(stop_tokens=[89]),
               dict(eos_id=50)):
        assert (gen.generate([[5, 9, 3]], max_new_tokens=6, **kw)
                == jax_gen.generate([[5, 9, 3]], max_new_tokens=6, **kw))


def test_stream_delivers_the_result(gen):
    q = queue.Queue()
    fut = gen.submit([5, 9, 3, 2], max_new_tokens=7, stream=q)
    got = []
    while (item := q.get(timeout=30)) is not None:
        got.extend(item)
    assert got == fut.result(30) and len(got) == 7


def test_stats_schema_ticks_and_no_leaks(jax_gen, gen):
    gen.generate([[1, 2, 3]], max_new_tokens=3)
    jax_gen.generate([[1, 2, 3]], max_new_tokens=3)
    st = _wait_idle(gen)
    jst = jax_gen.stats()
    assert set(st) == set(jst) - LEFT_OUT
    assert set(st["mixed"]) == set(jst["mixed"])
    assert set(st["kv_pool"]) == set(jst["kv_pool"])
    assert st["prefix_cache"] == jst["prefix_cache"] == {
        "entries": 0, "bytes": 0, "hits": 0, "misses": 0}
    m = st["mixed"]
    assert m["ticks"] == m["dispatches"] > 0
    pool = st["kv_pool"]
    assert st["active"] == 0
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]


def test_cancelled_mid_prefill_row_returns_blocks(gen):
    want = gen.generate([[5, 9, 3]], max_new_tokens=4)[0]
    cancelled0 = gen.stats().get("cancelled", 0)
    streams = [queue.Queue() for _ in range(3)]
    futs = [gen.submit([(i * 17 + j) % 90 + 1 for j in range(100)],
                       max_new_tokens=20, stream=s)
            for i, s in enumerate(streams)]
    deadline = time.time() + 20
    while not any(gen._prefilling) and time.time() < deadline:
        time.sleep(0.0005)
    assert all(f.cancel() for f in futs)
    for s in streams:  # every stream ends
        while s.get(timeout=20) is not None:
            pass
    st = _wait_idle(gen)
    pool = st["kv_pool"]
    assert st["active"] == 0
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]
    assert st["cancelled"] == cancelled0 + 3
    # A later request never sees a cancelled row's ghost.
    assert gen.generate([[5, 9, 3]], max_new_tokens=4)[0] == want


def test_seeded_streams_deterministic_and_batch_independent(jax_gen, gen):
    kw = dict(max_new_tokens=8, temperature=0.8, seed=7, top_p=0.95)
    prompt = [5, 9, 3, 2]
    alone = gen.generate([prompt], **kw)[0]
    assert alone == jax_gen.generate([prompt], **kw)[0]
    assert gen.generate([prompt], **kw)[0] == alone
    batched = gen.generate([[1, 2], prompt, [(i * 3) % 90 for i in
                                             range(30)]],
                           seed=[3, 7, 11], max_new_tokens=8,
                           temperature=[0.9, 0.8, 0.0], top_p=[1.0, 0.95,
                                                               1.0])
    assert batched[1] == alone
    greedy = gen.generate([prompt], max_new_tokens=8)[0]
    assert gen.generate([prompt], max_new_tokens=8, temperature=1.5,
                        top_k=1, seed=4)[0] == greedy


def test_construction_without_device_raises_here(spec, tparams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousGenerator(spec, params=tparams, **KW)


@pytest.mark.parametrize("overrides,exc,match", [
    (dict(kv_block_size=0), ValueError, "mixed_step requires"),
    (dict(kv_block_size=0, mixed_step=False, kv_quantize="int8"),
     ValueError, "kv_quantize requires"),
    # The host tier is ported; what still refuses is the tier without
    # prefix sharing, with the JAX scheduler's message. The case keeps the
    # id it had while the tier refused as unported.
    pytest.param(dict(kv_host_blocks=4, prefix_sharing=False), ValueError,
                 "kv_host_blocks requires prefix_sharing",
                 id="overrides2-NotImplementedError-host KV tier"),
    # Speculation is ported; what still refuses is speculation without the
    # paged pool, as in the JAX scheduler. The case keeps the id it had
    # while speculation refused as unported.
    pytest.param(dict(spec_k=2, kv_block_size=0, mixed_step=False),
                 ValueError, "speculative decoding .* requires the paged",
                 id="overrides3-NotImplementedError-speculative"),
    # The state_slab family is ported; what still refuses is state_rows
    # on a kv_paged model, with the JAX scheduler's message. The case keeps
    # the id it had while the family refused as unported.
    pytest.param(dict(state_rows=4), ValueError,
                 "state_rows applies to the state_slab family",
                 id="overrides4-NotImplementedError-state_slab"),
    # Tensor parallelism is ported; what still refuses is tp beside a
    # single `device` (the ranks take tp_devices), with the JAX
    # scheduler's message. The case keeps the id it had while tp refused
    # as unported.
    pytest.param(dict(tp=2), ValueError, "mutually exclusive",
                 id="overrides5-NotImplementedError-tensor-parallel"),
])
def test_unported_modes_refuse(spec, tparams, overrides, exc, match):
    with pytest.raises(exc, match=match):
        ContinuousGenerator(spec, params=tparams, device="cpu",
                            **dict(KW, **overrides))


def test_pool_pressure_parks_admissions_and_streams_match(spec, tparams,
                                                          gen):
    """A pool too small for the burst parks admissions (PoolExhausted)
    until rows free blocks; every stream still completes as on the
    roomy pool, and nothing leaks."""
    prompts = [[(i * 13 + j) % 90 + 1 for j in range(40)] for i in range(4)]
    want = [gen.generate([p], max_new_tokens=6)[0] for p in prompts]
    small = ContinuousGenerator(spec, params=tparams, device="cpu",
                                **dict(KW, kv_blocks=12))
    try:
        assert small.generate(prompts, max_new_tokens=6) == want
        st = _wait_idle(small)
        pool = st["kv_pool"]
        assert pool["blocks_free"] + pool["radix_nodes"] \
            == pool["blocks_total"] == 11
        assert pool["evictions"] > 0 and pool["pending_admissions"] == 0
    finally:
        small.stop()


def test_failed_step_recovers_and_keeps_serving(spec, tparams, monkeypatch):
    """A forward that raises fails the live rows RETRYABLE (with the
    emitted-token count), rebuilds the pool, and the scheduler serves the
    next request as before."""
    import tpu_engine_torch.runtime.scheduler as sched

    g = ContinuousGenerator(spec, params=tparams, device="cpu", **KW)
    try:
        want = g.generate([[5, 9, 3]], max_new_tokens=4)[0]
        real = sched.transformer_step_rows_ragged
        calls = {"n": 0}

        def flaky(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("injected device fault")
            return real(*args, **kw)

        monkeypatch.setattr(sched, "transformer_step_rows_ragged", flaky)
        fut = g.submit([7, 8, 9], max_new_tokens=10)
        with pytest.raises(RuntimeError, match="injected device fault") as ei:
            fut.result(30)
        assert ei.value.retryable and ei.value.tokens_emitted >= 1
        st = g.stats()
        assert st["failures"] == 1 and st["kv_pool"]["radix_nodes"] == 0
        assert g.generate([[5, 9, 3]], max_new_tokens=4)[0] == want
        m = g.stats()["mixed"]
        assert m["ticks"] == m["dispatches"]
    finally:
        g.stop()
