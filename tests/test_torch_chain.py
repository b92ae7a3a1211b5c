"""The port's KV chain wire format (tpu_engine_torch.runtime.kv_blocks
``export_chain`` / ``chain_compatible`` / ``verify_chain`` /
``import_chain``) against the JAX package's, on the CPU:

- for the same pool contents both packages export equal dicts
  (``json.dumps(..., sort_keys=True)`` equal), from device-resident and
  from host-demoted sources, over f32, bf16 and int8 pools;
- a chain exported by either package imports into the other byte-exact;
- the refusal fuzz of tests/test_migration.py (truncated payloads with a
  self-consistent crc, a bad crc, garbage, mismatched headers, a chain
  with no blocks) gives the JAX pool's ``chain_compatible`` reasons and
  ``verify_chain`` results; ``family`` ``state_slab`` and ``tp`` 2 refuse
  by name; an additive ``trace`` key is tolerated.
"""

import base64
import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.ops.attention import KVCache as JKVCache
from tpu_engine.runtime import kv_blocks as jkv
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime import kv_blocks as tkv

_ensure_builtin_models_imported()

BS = 4
DTYPES = {"f32": (jnp.float32, torch.float32, ""),
          "bf16": (jnp.bfloat16, torch.bfloat16, ""),
          "int8": (jnp.bfloat16, torch.bfloat16, "int8")}


def _pools(kind, n_blocks=8, host=3):
    jd, td, quant = DTYPES[kind]
    jp = jkv.BlockPool(jcreate("gpt2-small-test").config, n_blocks, BS, jd,
                       host_blocks=host, quantize=quant)
    tp = tkv.BlockPool(tcreate("gpt2-small-test").config, n_blocks, BS, td,
                       "cpu", host_blocks=host, quantize=quant)
    return jp, tp


def _fill_same(jp, tp, seed=0):
    """The same random bytes in every block of both pools: unit normals
    rounded to the storage dtype, or int8 payloads with positive f32
    scales."""
    rng = np.random.default_rng(seed)
    shape = tuple(tp.caches.k.shape)
    if tp.quantized:
        arrs = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        arrs += [rng.random(shape[:-1]).astype(np.float32) + 0.01
                 for _ in range(2)]
        jp.caches = JKVCache(jnp.asarray(arrs[0]), jnp.asarray(arrs[1]))
        jp.scales = JKVCache(jnp.asarray(arrs[2]), jnp.asarray(arrs[3]))
        for t, a in zip(tp._pool_tensors(), arrs):
            t.copy_(torch.from_numpy(a))
        return
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    jp.caches = JKVCache(*(jnp.asarray(a, jp.io_dtype) for a in arrs))
    for t, a in zip(tp._pool_tensors(), arrs):
        t.copy_(torch.from_numpy(a).to(t.dtype))


def _chain_of(pool, demote: bool):
    """Three blocks indexed as one radix chain; with ``demote`` the last
    two go to the host tier. Returns the chain's export sources."""
    with pool.lock:
        ids = pool.alloc(3)
        toks = list(range(1, 3 * BS + 1))
        pool.radix.insert(toks, ids)
        if not demote:
            return ids
        pool.release_many(ids)
        assert pool.radix.evict(2) == 2
        nodes = pool.radix.chain_nodes(toks)
        assert [n.demoted for n in nodes] == [False, True, True]
        return nodes


def _dump(chain):
    return json.dumps(chain, sort_keys=True)


@pytest.mark.parametrize("demote", [False, True],
                         ids=["device", "demoted"])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_export_dicts_equal_jax(kind, demote):
    jp, tp = _pools(kind)
    _fill_same(jp, tp)
    jsrc, tsrc = _chain_of(jp, demote), _chain_of(tp, demote)
    with jp.lock, tp.lock:
        want, got = jp.export_chain(jsrc), tp.export_chain(tsrc)
    assert _dump(got) == _dump(want)
    assert got["dtype"] == {"f32": "float32", "bf16": "bfloat16",
                            "int8": "int8"}[kind]
    assert set(got["blocks"][0]) == ({"k", "v", "ks", "vs"}
                                     if kind == "int8" else {"k", "v"})
    assert tp.swap_ins == 0  # demoted blocks export from the host tier


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_import_is_byte_exact_across_packages(kind, direction):
    jp, tp = _pools(kind)
    _fill_same(jp, tp, seed=1)
    src, dst = (jp, tp) if direction == "jax_to_port" else (tp, jp)
    with src.lock:
        chain = src.export_chain([3, 1, 6])
    fresh_j, fresh_t = _pools(kind)
    dst = fresh_t if direction == "jax_to_port" else fresh_j
    with dst.lock:
        assert dst.chain_compatible(chain) is None
        assert dst.verify_chain(chain)
        ids = dst.alloc(3)
        dst.import_chain(chain, chain["blocks"], ids)
        back = dst.export_chain(ids)
    assert _dump(back) == _dump(chain)
    if direction == "jax_to_port":
        # The imported blocks hold the source pool's exact values.
        for t, ref in zip(dst._pool_tensors(), tp._pool_tensors()):
            assert torch.equal(t[:, ids], ref[:, [3, 1, 6]])


def _rechecksum(chain):
    crc = 0
    for entry in chain["blocks"]:
        for name in ("k", "v", "ks", "vs"):
            if name in entry:
                crc = zlib.crc32(base64.b64decode(entry[name]), crc)
    return {**chain, "checksum": crc}


def _both(kind="bf16"):
    jp, tp = _pools(kind, host=0)
    _fill_same(jp, tp, seed=2)
    with jp.lock:
        chain = jp.export_chain([1, 2])
    return jp, tp, chain


def _same_verdicts(jp, tp, chains):
    """Each chain's (chain_compatible, verify_chain) on both pools; they
    must agree, and nothing may be allocated by the checks."""
    free = (jp.free_blocks, tp.free_blocks)
    out = []
    for c in chains:
        j = (jp.chain_compatible(c), jkv.BlockPool.verify_chain(c))
        t = (tp.chain_compatible(c), tkv.BlockPool.verify_chain(c))
        assert t == j, (c.get("dtype"), t, j)
        out.append(t)
    assert (jp.free_blocks, tp.free_blocks) == free
    return out


def test_fuzz_truncated_payloads_and_garbage_entries():
    jp, tp, chain = _both()
    bad = []
    for cut in (0, 1, 17):
        raw = base64.b64decode(chain["blocks"][1]["k"])[:cut]
        bad.append(_rechecksum({**chain, "blocks": [
            chain["blocks"][0],
            dict(chain["blocks"][1], k=base64.b64encode(raw).decode())]}))
    bad.append(_rechecksum({**chain, "blocks": [
        {k: v for k, v in chain["blocks"][0].items() if k != "v"}]}))
    bad.append({**chain, "blocks": [dict(chain["blocks"][0],
                                         k="!!not-b64!!")]})
    bad.append({**chain, "blocks": [None]})
    bad.append({**chain, "blocks": "nope"})
    verdicts = _same_verdicts(jp, tp, bad)
    for (reason, ok), cut in zip(verdicts[:3], (0, 1, 17)):
        assert ok and reason is not None and f"holds {cut} bytes" in reason
    assert "missing 'v'" in verdicts[3][0]
    assert "not base64" in verdicts[4][0]
    assert "not an object" in verdicts[5][0] and verdicts[5][1] is False
    assert verdicts[6] == ("chain carries no block list", False)


def test_fuzz_corrupted_crc_and_structural_garbage():
    jp, tp, chain = _both()
    raw = bytearray(base64.b64decode(chain["blocks"][0]["k"]))
    raw[0] ^= 0xFF
    flipped = {**chain, "blocks": [
        dict(chain["blocks"][0], k=base64.b64encode(bytes(raw)).decode()),
        chain["blocks"][1]]}
    verdicts = _same_verdicts(jp, tp, [
        chain, flipped, {**chain, "checksum": chain["checksum"] ^ 1},
        {**chain, "checksum": "wat"}])
    assert [v[1] for v in verdicts] == [True, False, False, False]
    assert all(v[0] is None for v in verdicts)
    for garbage in ({}, {"blocks": 3}, {"blocks": [None]},
                    {"blocks": [{"k": 5}], "checksum": 0},
                    {"blocks": "nope", "checksum": 0}):
        assert tkv.BlockPool.verify_chain(garbage) is False
        assert jkv.BlockPool.verify_chain(garbage) is False


def test_fuzz_mismatched_geometry_headers():
    jp, tp, chain = _both()
    bad = [{**chain, key: bogus} for key, bogus in (
        ("dtype", "float64"), ("dtype", "torch.bfloat16"),
        ("quantized", True), ("block_size", 32), ("n_layers", 7),
        ("kv_heads", 5), ("d_head", 48))]
    bad.append({k: v for k, v in chain.items() if k != "d_head"})
    verdicts = _same_verdicts(jp, tp, bad)
    keys = ("dtype", "dtype", "quantized", "block_size", "n_layers",
            "kv_heads", "d_head", "d_head")
    for (reason, _ok), key in zip(verdicts, keys):
        assert reason is not None and reason.startswith(f"chain {key}=")
    # Another pool geometry or storage dtype refuses the same chain.
    for kind in ("f32", "int8"):
        jq, tq = _pools(kind, host=0)
        assert tq.chain_compatible(chain) == jq.chain_compatible(chain)
        assert "dtype" in tq.chain_compatible(chain)


def test_zero_block_chain_and_family_and_tp_refuse_by_name():
    jp, tp, chain = _both()
    empty = _rechecksum({**chain, "blocks": []})
    (reason, ok), = _same_verdicts(jp, tp, [empty])
    assert reason is None and ok  # a well-formed empty chain...
    # ...is refused by the importer's span check (test_torch_migration).
    slab = {**chain, "family": "state_slab"}
    tp2 = {**chain, "tp": 2}
    assert tp.chain_compatible(slab) == (
        "chain family='state_slab' does not match destination pool "
        "family 'kv_paged'")
    assert tp.chain_compatible(tp2) == (
        "chain tp=2 does not match destination pool tp=1 "
        "(tensor-parallel shard geometry)")
    assert _same_verdicts(jp, tp, [slab, tp2, {**chain, "tp": "x"},
                                   {**chain, "family": "kv_paged",
                                    "tp": 1}])[3] == (None, True)


def test_trace_key_is_tolerated():
    jp, tp, _ = _both()
    with jp.lock:
        traced = jp.export_chain([1, 2], trace={"trace_id": "t",
                                                "parent_id": "p"})
    assert "trace" in traced
    assert tp.chain_compatible(traced) is None
    assert tkv.BlockPool.verify_chain(traced)
    with tp.lock:
        ids = tp.alloc(2)
        tp.import_chain(traced, traced["blocks"], ids)
        assert tp.export_chain(ids)["blocks"] == traced["blocks"]
