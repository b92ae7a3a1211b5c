"""The port's block pool and radix tree (tpu_engine_torch.runtime.kv_blocks)
against the JAX package's: one scripted sequence of alloc / retain /
release / ensure_writable (copy-on-write) / release_tail / radix insert /
lookup / evict / clear, run on both pools, gives the same block ids,
refcounts and stats() at every step; and the port's copy-on-write copies
the block's contents."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime import kv_blocks as jkv
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime import kv_blocks as tkv

_ensure_builtin_models_imported()

BS = 4


def _pools(n_blocks=10):
    jp = jkv.BlockPool(jcreate("gpt2-small-test").config, n_blocks, BS,
                       jnp.float32)
    tp = tkv.BlockPool(tcreate("gpt2-small-test").config, n_blocks, BS,
                       torch.float32, "cpu")
    return jp, tp


def _script(pool, exhausted):
    """The same calls on either package's pool; returns what each step
    observed (ids, refcounts, stats)."""
    seen = []

    def snap(tag, value=None):
        seen.append((tag, value, [pool.refcount(i)
                                  for i in range(pool.num_blocks)],
                     pool.stats()))

    with pool.lock:
        a = pool.alloc(3)
        snap("alloc", a)
        toks = list(range(1, 3 * BS + 2))       # 3 full blocks + 1 token
        snap("insert", pool.radix.insert(toks, a))
        pool.release_many(a)                   # the row frees: tree-only
        snap("release_row")
        m = pool.radix.lookup(toks[:2 * BS] + [99, 98, 97, 96])
        snap("lookup", m)
        wid, copied = pool.ensure_writable(m[-1])   # shared: COW
        m[-1] = wid
        snap("cow", (wid, copied))
        snap("cow_private", pool.ensure_writable(wid))
        b = pool.alloc(2)
        row = m + b
        snap("alloc_row", row)
        snap("release_tail", pool.release_tail(row, 2))
        snap("row_after_tail", list(row))
        pool.retain(row[0])
        pool.release(row[0])
        snap("retain_release")
        c = pool.alloc(pool.free_blocks + 1)   # evicts the tree's LRU leaf
        snap("alloc_evict", c)
        try:
            pool.alloc(pool.num_blocks)
        except exhausted:
            snap("exhausted")
        pool.release_many(c)
        pool.release_many(row)
        snap("released")
        snap("evict", pool.radix.evict(5))
        pool.radix.insert(toks, pool.alloc(3))
        pool.radix.clear()
        snap("clear")
    return seen


def test_scripted_sequence_matches_jax():
    jp, tp = _pools()
    got = _script(tp, tkv.PoolExhausted)
    want = _script(jp, jkv.PoolExhausted)
    assert [s[0] for s in got] == [s[0] for s in want]
    assert "exhausted" in [s[0] for s in got]
    for g, w in zip(got, want):
        assert g == w, (g[0], g, w)


def test_cow_copies_block_contents_and_null_block_is_permanent():
    _, tp = _pools()
    with tp.lock:
        (blk,) = tp.alloc(1)
        tp.caches.k[:, blk] = 3.0
        tp.caches.v[:, blk] = 5.0
        tp.retain(blk)                         # a second holder
        wid, copied = tp.ensure_writable(blk)
        assert copied and wid != blk
        assert torch.equal(tp.caches.k[:, wid], tp.caches.k[:, blk])
        assert torch.equal(tp.caches.v[:, wid], tp.caches.v[:, blk])
        tp.release(0)                          # the null block: a no-op
        assert tp.refcount(0) == 1
        with pytest.raises(RuntimeError, match="double free"):
            tp.release(wid)
            tp.release(wid)


def test_reset_rebuilds_and_unported_tiers_refuse():
    _, tp = _pools()
    with tp.lock:
        tp.radix.insert(list(range(BS)), tp.alloc(1))
        tp.reset()
        assert tp.generation == 1 and tp.free_blocks == tp.num_blocks - 1
        assert tp.radix.nodes == 0 and int(np.sum(tp._ref[1:])) == 0
    cfg = tcreate("gpt2-small-test").config
    assert tp.bytes_per_block() == jkv.dense_block_bytes(
        jcreate("gpt2-small-test").config, BS, jnp.float32)
    for kw in ({"host_blocks": 4}, {"quantize": "int8"}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tkv.BlockPool(cfg, 10, BS, torch.float32, "cpu", **kw)
