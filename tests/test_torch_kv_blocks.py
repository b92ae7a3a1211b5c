"""The port's block pool and radix tree (tpu_engine_torch.runtime.kv_blocks)
against the JAX package's: one scripted sequence of alloc / retain /
release / ensure_writable (copy-on-write) / release_tail / radix insert /
lookup / evict / clear, run on both pools (full-precision and int8), gives
the same block ids, refcounts and stats() at every step; the port's
copy-on-write copies the block's contents (int8 payload and scales
bit-exactly); and the two-path admission's gather and scatter, bf16 and
int8, write and read what the JAX functions do on the same numpy-seeded
inputs."""

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


def _pools(n_blocks=10, quantize=""):
    jp = jkv.BlockPool(jcreate("gpt2-small-test").config, n_blocks, BS,
                       jnp.float32, quantize=quantize)
    tp = tkv.BlockPool(tcreate("gpt2-small-test").config, n_blocks, BS,
                       torch.float32, "cpu", quantize=quantize)
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


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_scripted_sequence_matches_jax(quantize):
    jp, tp = _pools(quantize=quantize)
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
    # The host tier is ported: the pool builds it (plain CPU buffers on a
    # CPU pool) and reports it.
    tiered = tkv.BlockPool(cfg, 10, BS, torch.float32, "cpu", host_blocks=4)
    assert tiered.stats()["host"]["blocks_total"] == 4
    assert [tuple(h.shape) for h in tiered._host] == [
        (4, cfg.n_layers, BS, cfg.kv_heads, cfg.d_head)] * 2
    assert not tiered._host[0].is_pinned()
    with pytest.raises(ValueError, match="unsupported KV quantize"):
        tkv.BlockPool(cfg, 10, BS, torch.float32, "cpu", quantize="fp4")
    # An int8 pool's reset rebuilds the scales (ones) with the payload.
    _, qp = _pools(quantize="int8")
    with qp.lock:
        (blk,) = qp.alloc(1)
        qp.scales.k[:, blk] = 0.5
        qp.reset()
    assert qp.caches.k.dtype == torch.int8
    assert bool((qp.scales.k == 1.0).all() and (qp.scales.v == 1.0).all())


def test_int8_cow_copies_payload_and_scales_bitexact():
    _, tp = _pools(quantize="int8")
    rng = np.random.default_rng(1)
    with tp.lock:
        (blk,) = tp.alloc(1)
        shape = tuple(tp.caches.k[:, blk].shape)
        for pair in (tp.caches, tp.scales):
            for t in (pair.k, pair.v):
                vals = rng.standard_normal(shape[:t.dim() - 1]) * 50
                t[:, blk] = torch.from_numpy(vals).to(t.dtype)
        tp.retain(blk)
        wid, copied = tp.ensure_writable(blk)
        assert copied and tp.cow_copies == 1
        for pair in (tp.caches, tp.scales):
            for t in (pair.k, pair.v):
                assert torch.equal(t[:, wid], t[:, blk])


def _row_inputs(pool, nb, seed):
    rng = np.random.default_rng(seed)
    n_layers, _, bs, h, d = pool.caches.k.shape
    row = [rng.standard_normal((n_layers, 1, nb * bs, h, d)
                               ).astype(np.float32) for _ in range(2)]
    # Matched slots point at the null block (duplicates), the rest at
    # fresh blocks, as the two-path admission scatters them.
    ids = np.array([0, 0, 5, 2, 7][:nb], np.int32)
    return row, ids


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_scatter_then_gather_match_jax(quantize):
    jp, tp = _pools(quantize=quantize)
    (rk, rv), ids = _row_inputs(tp, 5, seed=3)
    if quantize:
        jc, js = jkv.scatter_blocks_quant(
            jp.caches, jp.scales, jnp.asarray(rk), jnp.asarray(rv),
            jnp.asarray(ids))
        tkv.scatter_blocks_quant(tp.caches, tp.scales, torch.from_numpy(rk),
                                 torch.from_numpy(rv), torch.from_numpy(ids))
        pairs = ((jc, tp.caches), (js, tp.scales))
    else:
        jc = jkv.scatter_blocks(jp.caches, jnp.asarray(rk), jnp.asarray(rv),
                                jnp.asarray(ids))
        tkv.scatter_blocks(tp.caches, torch.from_numpy(rk),
                           torch.from_numpy(rv), torch.from_numpy(ids))
        pairs = ((jc, tp.caches),)
    for jpair, tpair in pairs:
        for j, t in ((jpair.k, tpair.k), (jpair.v, tpair.v)):
            # Every block but the null block (the duplicates' dump).
            np.testing.assert_array_equal(t.numpy()[:, 1:],
                                          np.asarray(j)[:, 1:])
    gids = np.array([5, 2, 7, 0], np.int32)
    if quantize:
        jg = jkv.gather_blocks_quant(jc.k, jc.v, js.k, js.v,
                                     jnp.asarray(gids), dtype=jnp.bfloat16)
        tg = tkv.gather_blocks_quant(tp.caches.k, tp.caches.v, tp.scales.k,
                                     tp.scales.v, torch.from_numpy(gids),
                                     dtype=torch.bfloat16)
        assert tg.k.dtype == torch.bfloat16
    else:
        jg = jkv.gather_blocks(jc.k, jc.v, jnp.asarray(gids))
        tg = tkv.gather_blocks(tp.caches.k, tp.caches.v,
                               torch.from_numpy(gids))
    cols = 3 * BS  # the null block's columns are garbage by contract
    for j, t in ((jg.k, tg.k), (jg.v, tg.v)):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(
            t.float().numpy()[:, :, :cols],
            np.asarray(j.astype(jnp.float32))[:, :, :cols])


def test_pool_defaults_to_the_card():
    """BlockPool with no device resolves to the card, like every other
    entry point of the port: where no card exists it raises instead of
    building a CPU pool; the CPU is used only when named."""
    cfg = tcreate("gpt2-small-test").config
    if torch.cuda.is_available():
        assert tkv.BlockPool(cfg, 4, BS, torch.float32).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tkv.BlockPool(cfg, 4, BS, torch.float32)
    assert tkv.BlockPool(cfg, 4, BS, torch.float32,
                         "cpu").device == torch.device("cpu")
