"""The port's host KV tier (tpu_engine_torch.runtime.kv_blocks
``host_blocks``, scheduler ``kv_host_blocks``) against the JAX package's,
on the CPU, case for case with tests/test_kv_offload.py:

- a demote/promote round trip is bit-exact (payload and, for int8, its
  scales);
- a lookup without ``promote_reserve`` never promotes; a live row's or a
  pinned lookup's block is never demoted; promotion defers behind the
  reserve (``swap_in_deferred``) and may displace LRU-colder resident
  leaves into the tier; a full tier destroys its own LRU demoted leaf;
  insert re-adopts a demoted node; reset voids the tier; churn leaks
  nothing;
- one scripted call sequence on the JAX pool and on the port's gives the
  same block ids, host slots and ``stats()`` (its ``host`` block
  included) at every step, f32 and int8;
- a mixed and a two-path lane with ``kv_host_blocks`` swap a demoted
  prefix in instead of recomputing it, and stream the JAX lane's greedy
  tokens with the same host counters, on the same weights and the same
  serial requests; a recovery voids the tier;
- misconfigurations raise the JAX messages, and a worker's ``/health``
  carries the ``host`` block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime import kv_blocks as jkv
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime import kv_blocks as tkv
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

_ensure_builtin_models_imported()

BS = 16


@pytest.fixture(scope="module")
def spec():
    return tcreate("gpt2-small-test", max_seq=128)


@pytest.fixture(scope="module")
def params():
    return jcreate("gpt2-small-test", max_seq=128).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(params, spec):
    return convert.params_from_jax(jax.tree.map(np.asarray, params),
                                   spec.config, device="cpu")


def _pool(spec, blocks=6, host=4, quantize=""):
    return tkv.BlockPool(spec.config, blocks, BS, torch.float32, "cpu",
                         host_blocks=host, quantize=quantize)


def _pattern(pool, base: float):
    shape = (pool.cfg.n_layers, pool.block_size, pool.cfg.kv_heads,
             pool.cfg.d_head)
    return torch.arange(int(np.prod(shape)),
                        dtype=torch.float32).reshape(shape) + base


def _write_block(pool, bid, pat):
    pool.caches.k[:, bid] = pat
    pool.caches.v[:, bid] = -pat


def _tree_prefix(pool, n_blocks, base=0.0, prompt0=0):
    """Allocate n blocks with recognizable patterns, index them as one
    radix chain, release the row refs (tree-only)."""
    ids = pool.alloc(n_blocks)
    pats = []
    for j, bid in enumerate(ids):
        pat = _pattern(pool, base + 1000.0 * j)
        _write_block(pool, bid, pat)
        pats.append(pat)
    prompt = list(range(prompt0, prompt0 + n_blocks * pool.block_size))
    pool.radix.insert(prompt, ids)
    pool.release_many(ids)
    return prompt, ids, pats


# -- demote / promote ---------------------------------------------------------

def test_demote_promote_roundtrip_bitexact(spec):
    pool = _pool(spec)
    prompt, ids, pats = _tree_prefix(pool, 2)
    free0 = pool.free_blocks
    assert pool.radix.evict(2) == 2
    assert pool.demotions == 2 and pool.radix.nodes == 2  # nodes survive
    assert pool.free_blocks == free0 + 2
    assert pool.stats()["host"]["blocks_used"] == 2
    got = pool.radix.lookup(prompt, promote_reserve=0)
    assert len(got) == 2
    assert pool.swap_ins == 2 and pool.swap_in_events == 1
    assert pool.swapped_in_tokens == 2 * BS
    for j, bid in enumerate(got):
        assert torch.equal(pool.caches.k[:, bid], pats[j])
        assert torch.equal(pool.caches.v[:, bid], -pats[j])
    assert pool.stats()["host"]["blocks_used"] == 0
    pool.release_many(got)


def test_int8_demote_promote_moves_payload_and_scales_bitexact(spec):
    pool = _pool(spec, quantize="int8")
    gen = torch.Generator().manual_seed(3)
    ids = pool.alloc(2)
    want = []
    for bid in ids:
        for t in pool._pool_tensors():
            src = (torch.randint(-127, 128, t[:, bid].shape, generator=gen)
                   if t.dtype == torch.int8 else
                   torch.rand(t[:, bid].shape, generator=gen))
            t[:, bid] = src.to(t.dtype)
        want.append([t[:, bid].clone() for t in pool._pool_tensors()])
    prompt = list(range(2 * BS))
    pool.radix.insert(prompt, ids)
    pool.release_many(ids)
    assert pool.radix.evict(2) == 2
    assert pool.stats()["host"]["scale_slots_used"] == 2
    assert pool.stats()["host"]["scale_slots_leaked"] == 0
    got = pool.radix.lookup(prompt, promote_reserve=0)
    for bid, w in zip(got, want):
        for t, ref in zip(pool._pool_tensors(), w):
            assert torch.equal(t[:, bid], ref)
    st = pool.stats()["host"]
    assert st["scale_slots_used"] == st["scale_slots_leaked"] == 0
    pool.release_many(got)


def test_no_promote_without_reserve_arg(spec):
    pool = _pool(spec)
    prompt, _, _ = _tree_prefix(pool, 1)
    pool.radix.evict(1)
    assert pool.radix.lookup(prompt) == []
    assert pool.swap_ins == 0 and pool.swap_in_deferred == 0


def test_demotion_never_touches_live_or_pinned(spec):
    pool = _pool(spec)
    prompt, ids, _ = _tree_prefix(pool, 2)
    pinned = pool.radix.lookup(prompt)   # a "live row" re-pins the chain
    assert pinned == ids
    assert pool.radix.evict(2) == 0
    assert pool.demotions == 0
    pool.release_many(pinned)            # tree-only now: demotable
    assert pool.radix.evict(2) == 2
    assert pool.demotions == 2


def test_promotion_defers_behind_reserve(spec):
    pool = _pool(spec, blocks=6, host=4)
    prompt, _, pats = _tree_prefix(pool, 2)
    pool.radix.evict(1)  # demote the tail leaf only; the head stays
    assert pool.demotions == 1
    free = pool.free_blocks
    got = pool.radix.lookup(prompt, promote_reserve=free)
    assert len(got) == 1
    assert pool.swap_in_deferred == 1 and pool.swap_ins == 0
    assert torch.equal(pool.caches.k[:, got[0]], pats[0])
    pool.release_many(got)
    got2 = pool.radix.lookup(prompt, promote_reserve=0)
    assert len(got2) == 2 and pool.swap_ins == 1
    pool.release_many(got2)


def test_promotion_displaces_colder_resident_leaves(spec):
    pool = _pool(spec, blocks=4, host=4)
    p1, _, pats1 = _tree_prefix(pool, 1, base=0.0, prompt0=0)
    pool.radix.evict(1)
    _tree_prefix(pool, pool.free_blocks, base=5e5, prompt0=1000)
    assert pool.free_blocks == 0
    got = pool.radix.lookup(p1, promote_reserve=0)
    assert len(got) == 1 and pool.swap_ins == 1
    assert torch.equal(pool.caches.k[:, got[0]], pats1[0])
    assert pool.evictions == 0          # nothing destroyed...
    assert pool.demotions == 2          # ...a colder leaf was demoted
    assert pool.stats()["host"]["blocks_used"] == 1
    pool.release_many(got)


def test_host_tier_full_evicts_lru_demoted_leaf(spec):
    pool = _pool(spec, blocks=8, host=1)
    p1, _, _ = _tree_prefix(pool, 1, base=0.0, prompt0=0)
    p2, _, _ = _tree_prefix(pool, 1, base=5e5, prompt0=1000)
    pool.radix.evict(1)  # p1's leaf -> the single host slot
    assert pool.demotions == 1 and pool.host_evictions == 0
    pool.radix.evict(1)  # p2's leaf: the tier is full -> p1's destroyed
    assert pool.demotions == 2 and pool.host_evictions == 1
    assert pool.radix.nodes == 1
    assert pool.radix.lookup(p1, promote_reserve=0) == []
    got = pool.radix.lookup(p2, promote_reserve=0)
    assert len(got) == 1 and pool.swap_ins == 1
    pool.release_many(got)


def test_insert_readopts_demoted_node(spec):
    pool = _pool(spec)
    prompt, _, _ = _tree_prefix(pool, 1)
    pool.radix.evict(1)
    assert pool.stats()["host"]["blocks_used"] == 1
    fresh = pool.alloc(1)
    _write_block(pool, fresh[0], _pattern(pool, 7e6))
    pool.radix.insert(prompt, fresh)
    assert pool.stats()["host"]["blocks_used"] == 0
    assert pool.refcount(fresh[0]) == 2  # row + tree
    pool.release_many(fresh)
    got = pool.radix.lookup(prompt, promote_reserve=0)
    assert got == fresh and pool.swap_ins == 0
    pool.release_many(got)


def test_reset_voids_host_tier_and_generation(spec):
    pool = _pool(spec)
    prompt, _, _ = _tree_prefix(pool, 2)
    pool.radix.evict(2)
    pins = pool.radix.lookup(prompt, promote_reserve=0)
    assert len(pins) == 2
    gen0 = pool.generation
    pool.reset()
    assert pool.generation == gen0 + 1
    st = pool.stats()
    assert st["host"]["blocks_used"] == 0
    assert st["blocks_free"] == st["blocks_total"]
    assert int(np.sum(pool._ref[1:])) == 0


def test_zero_leak_accounting_through_churn(spec):
    pool = _pool(spec, blocks=8, host=2)
    p1, _, _ = _tree_prefix(pool, 2, base=0.0, prompt0=0)
    p2, _, _ = _tree_prefix(pool, 2, base=5e5, prompt0=1000)
    pool.radix.evict(2)
    got = pool.radix.lookup(p1, promote_reserve=0) or \
        pool.radix.lookup(p2, promote_reserve=0)
    pool.release_many(got)
    st = pool.stats()
    resident = st["radix_nodes"] - st["host"]["blocks_used"]
    assert st["blocks_free"] + resident == st["blocks_total"]
    assert st["host"]["blocks_used"] <= st["host"]["blocks_total"]
    assert int(np.sum(pool._ref[1:] < 0)) == 0


# -- one call sequence on both packages' pools ------------------------------

def _host_slots(pool):
    """(tokens of the node's path, block id, host slot) of every radix
    node, in path order."""
    out, stack = [], [(pool.radix.root, ())]
    while stack:
        n, path = stack.pop()
        for key, c in n.children.items():
            out.append((path + key, c.block_id, c.host_slot))
            stack.append((c, path + key))
    return sorted(out)


def _script(pool, exhausted):
    seen = []

    def snap(tag, value=None):
        seen.append((tag, value, _host_slots(pool), pool.stats()))

    bs = pool.block_size
    with pool.lock:
        a = pool.alloc(3)
        p1 = list(range(1, 3 * bs + 1))
        pool.radix.insert(p1, a)
        pool.release_many(a)
        snap("chain1", a)
        b = pool.alloc(2)
        p2 = list(range(100, 100 + 2 * bs))
        pool.radix.insert(p2, b)
        pool.release_many(b)
        snap("chain2", b)
        snap("evict", pool.radix.evict(3))            # demotions
        snap("lookup_noreserve", pool.radix.lookup(p1))
        pins = pool.radix.lookup(p1, promote_reserve=2)
        snap("promote", pins)
        deferred = pool.radix.lookup(p2, promote_reserve=pool.num_blocks)
        snap("deferred", deferred)
        pool.release_many(deferred)
        c = pool.alloc(pool.free_blocks + 1)          # demote to make room
        snap("alloc_demote", c)
        try:
            pool.alloc(pool.num_blocks)
        except exhausted:
            snap("exhausted")
        pool.release_many(c)
        pool.release_many(pins)
        d = pool.alloc(2)
        pool.radix.insert(p2, d)                      # re-adopts p2
        pool.release_many(d)
        snap("readopt", d)
        snap("evict_all", pool.radix.evict(pool.num_blocks))
        e = pool.radix.lookup(p2 + [7], promote_reserve=0)
        snap("promote2", e)
        pool.release_many(e)
        pool.radix.clear()
        snap("clear")
        f = pool.alloc(2)
        pool.radix.insert(p1[:2 * bs], f)
        pool.release_many(f)
        pool.radix.evict(1)
        pool.reset()
        snap("reset")
    return seen


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_scripted_sequence_matches_jax(quantize):
    jp = jkv.BlockPool(jcreate("gpt2-small-test").config, 7, 4, jnp.float32,
                       host_blocks=3, quantize=quantize)
    tp = tkv.BlockPool(tcreate("gpt2-small-test").config, 7, 4,
                       torch.float32, "cpu", host_blocks=3,
                       quantize=quantize)
    got = _script(tp, tkv.PoolExhausted)
    want = _script(jp, jkv.PoolExhausted)
    assert [s[0] for s in got] == [s[0] for s in want]
    assert "exhausted" in [s[0] for s in got]
    for g, w in zip(got, want):
        assert g == w, (g[0], g, w)
    host = got[-2][3]["host"]  # before the reset: the tier was used
    assert host["demotions"] > 0 and host["swap_ins"] > 0
    assert host["swap_in_deferred"] > 0 and host["host_evictions"] > 0


# -- the scheduler with a host tier -------------------------------------------

LANE = dict(dtype="float32", n_slots=2, step_chunk=4, max_seq=128,
            kv_block_size=16, kv_blocks=12, kv_host_blocks=8)
MODES = {"two-path": {},
         "mixed": dict(mixed_step=True, prefill_chunk=16)}


def _serial(g, rng_seed: int):
    """One prompt, churn that demotes its blocks, the prompt again: the
    streams and the pool's host counters after each."""
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(1, 200, 32)] + [7, 8, 9]
    out = [g.generate([prompt], max_new_tokens=8)[0]]
    churn = np.random.default_rng(rng_seed)
    for _ in range(3):
        fp = [int(t) for t in churn.integers(1, 200, 48)]
        out.append(g.generate([fp], max_new_tokens=4)[0])
    demoted = g.stats()["kv_pool"]["host"]["demotions"]
    out.append(g.generate([prompt], max_new_tokens=8)[0])
    return out, demoted, g.stats()["kv_pool"]


@pytest.mark.parametrize("mode", list(MODES))
def test_lane_swaps_in_and_streams_match_jax(params, spec, tparams, mode):
    kw = dict(LANE, **MODES[mode])
    jg = JaxGen(jcreate("gpt2-small-test", max_seq=128), params=params,
                **kw)
    tg = ContinuousGenerator(spec, params=tparams, device="cpu", **kw)
    try:
        want, jdem, jpool = _serial(jg, 2)
        got, tdem, tpool = _serial(tg, 2)
    finally:
        jg.stop()
        tg.stop()
    assert got == want
    assert tdem > 0 and tdem == jdem       # churn demoted cold leaves
    host = tpool["host"]
    assert host["swap_ins"] > 0 and host["swap_in_events"] > 0
    assert host == jpool["host"]
    assert tpool["prefix_hit_tokens"] == jpool["prefix_hit_tokens"] > 0
    assert tpool["prefilled_tokens"] == jpool["prefilled_tokens"]
    assert tpool["blocks_free"] + tpool["radix_nodes"] - \
        host["blocks_used"] == tpool["blocks_total"]


def test_recover_voids_demoted_state(spec, tparams):
    g = ContinuousGenerator(spec, params=tparams, device="cpu", **LANE)
    try:
        rng = np.random.default_rng(3)
        for n in (40, 48, 48, 48):   # JAX's prompt, then its churn
            g.generate([[int(t) for t in rng.integers(1, 200, n)]],
                       max_new_tokens=4)
        assert g.stats()["kv_pool"]["host"]["demotions"] > 0
        gen0 = g._pool.generation
        g._recover(RuntimeError("injected device loss"))
        st = g.stats()["kv_pool"]
        assert g._pool.generation == gen0 + 1
        assert st["host"]["blocks_used"] == 0
        assert st["blocks_free"] == st["blocks_total"]
        assert g.stats().get("recover_invariant_violations", 0) == 0
        assert len(g.generate([[5, 9, 3]], max_new_tokens=4)[0]) == 4
    finally:
        g.stop()


@pytest.mark.parametrize("overrides,match", [
    (dict(kv_block_size=0), "kv_host_blocks requires the paged KV cache"),
    (dict(prefix_sharing=False), "kv_host_blocks requires prefix_sharing"),
])
def test_misconfiguration_raises_jax_messages(params, spec, tparams,
                                              overrides, match):
    kw = dict(LANE, **overrides)
    msgs = []
    for make in (lambda: JaxGen(jcreate("gpt2-small-test", max_seq=128),
                                params=params, **kw),
                 lambda: ContinuousGenerator(spec, params=tparams,
                                             device="cpu", **kw)):
        with pytest.raises(ValueError, match=match) as ei:
            make()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_worker_flag_and_health_exposure(tparams):
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig

    base = dict(model="gpt2-small-test", dtype="float32", device="cpu")
    with pytest.raises(RuntimeError, match="kv-host-blocks requires"):
        WorkerNode(WorkerConfig(node_id="bad", gen_kv_host_blocks=4,
                                **base), params=tparams)
    w = WorkerNode(WorkerConfig(node_id="tier", gen_kv_block_size=16,
                                gen_kv_blocks=12, gen_kv_host_blocks=8,
                                **base), params=tparams)
    try:
        w.handle_generate({"request_id": "h1",
                           "prompt_tokens": list(range(1, 40)),
                           "max_new_tokens": 2})
        pool = w.get_health()["generator"]["kv_pool"]
        assert pool["host"]["blocks_total"] == 8
        assert set(pool["host"]) == {
            "blocks_total", "blocks_used", "demotions", "swap_ins",
            "swap_in_events", "swap_in_deferred", "host_evictions",
            "swapped_in_tokens"}
        assert "radix_lookups" in pool and "radix_hits" in pool
    finally:
        w.stop()
