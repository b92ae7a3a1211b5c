"""Tensor-parallel serving of the port (``tpu_engine_torch``: the
registry's TP rules, ``parallel.mesh``, the sharded forwards, the H_kv-
sharded ``BlockPool`` and the ``tp`` scheduler and worker) against the JAX
package's ``tests/test_tp_serving.py`` contracts, on the CPU:

- every registered model declares the JAX registry's rule, and the port's
  per-rank trees equal the ``addressable_shards`` of JAX's
  ``jax.device_put(params, tp_shardings(spec, params, tp_mesh(N)))``;
- the refusals (unshardable family, quantized tree, scheduler and worker
  fences) carry the JAX messages;
- the port's tp 2 and 4 forwards (every rank on ``cpu``) give JAX's
  tp-sharded logits within 1e-5 in f32, on gpt2-small-test (biases: a
  row-parallel bias added once per rank would show here) and a GQA llama;
- greedy and seeded streams of port tp lanes equal JAX's tp 2
  ``ContinuousGenerator`` in mixed, two-path and speculative modes, with a
  radix hit; an int8 pool is deterministic and equal to the port's tp 1;
- chains carry ``tp``, export JAX's tp pool's bytes, refuse a mismatched
  degree by JAX's reason and splice between equal degrees;
- a tp lane's modules (``parallel`` included) import no jax.
"""

import ast
import json
import os
import queue
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models import registry as jreg
from tpu_engine.models import transformer as jtr
from tpu_engine.ops import paged_attention as jpa
from tpu_engine.ops.attention import KVCache as JKVCache
from tpu_engine.parallel.mesh import tp_mesh
from tpu_engine.runtime import kv_blocks as jkv
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine_torch.models import convert
from tpu_engine_torch.models import registry as treg
from tpu_engine_torch.models import transformer as ttr
from tpu_engine_torch.parallel.mesh import (
    TPGroup,
    tp_devices,
    tp_topology_label,
)
from tpu_engine_torch.runtime import kv_blocks as tkv
from tpu_engine_torch.runtime.scheduler import (
    ContinuousGenerator,
    ImportRefused,
)

jreg._ensure_builtin_models_imported()

REPO = Path(__file__).resolve().parents[1]
PROMPTS = [[5, 9, 3, 17], [2, 4, 6, 8, 10, 12], [1] * 20,
           [5, 9, 3, 17, 9, 9]]
# The second prompt's first block (block_size 16) comes from the radix
# tree: both share 16 tokens.
SHARED = [[7] * 16 + [3, 1], [7] * 16 + [4, 2, 9]]
SEEDS = [7, 8, 9, 10]
# A GQA config that tp 4 divides: 8 query heads over 4 KV heads.
GQA = ("llama-small-test", dict(n_heads=8, n_kv_heads=4))
CONFIGS = {"gpt2-small-test": ("gpt2-small-test", {}), "gqa-llama": GQA}


def _specs(key):
    name, kw = CONFIGS[key]
    return (jreg.create_model(name, max_seq=64, **kw),
            treg.create_model(name, max_seq=64, **kw))


@pytest.fixture(scope="module")
def models():
    """key -> (JAX spec, port spec, JAX params, numpy params)."""
    out = {}
    for key in CONFIGS:
        js, ts = _specs(key)
        jp = js.init(jax.random.PRNGKey(0))
        out[key] = (js, ts, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def gpt2(models):
    js, ts, jp, npp = models["gpt2-small-test"]
    return js, ts, jp, convert.params_from_jax(npp, ts.config, "cpu",
                                               "float32")


def _port_gen(ts, params, tp=1, **kw):
    kw.setdefault("kv_block_size", 16)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("n_slots", 4)
    if tp > 1:
        kw["tp_devices"] = ["cpu"] * tp
    else:
        kw["device"] = "cpu"
    return ContinuousGenerator(ts, params=params, dtype="float32", tp=tp,
                               **kw)


def _run(gen, prompts, max_new=10, **kw):
    try:
        return gen.generate(prompts, max_new_tokens=max_new, **kw)
    finally:
        gen.stop()


def _leak_free(stats):
    kv = stats["kv_pool"]
    return kv["blocks_free"] + kv["radix_nodes"] >= kv["blocks_total"]


# -- the registry's rules ------------------------------------------------------

@pytest.mark.parametrize("name", treg.available_models())
def test_every_registered_model_declares_the_jax_rule(name):
    tspec, jspec = treg.create_model(name), jreg.create_model(name)
    assert tspec.tp_rule and tspec.tp_rule == jspec.tp_rule
    assert (treg.tp_unshardable_reason(tspec)
            == jreg.tp_unshardable_reason(jspec))
    assert "unknown TP partition rule" not in (
        treg.tp_unshardable_reason(tspec) or "")
    assert (tspec.supports("tensor_parallel")
            == (treg.tp_unshardable_reason(tspec) is None
                and tspec.state_family == "kv_paged"))


def _jax_shards(jspec, jparams, n):
    """path -> the leaf's per-device shards (numpy) in mesh order."""
    mesh = tp_mesh(n)
    placed = jax.device_put(jparams,
                            jreg.tp_shardings(jspec, jparams, mesh))
    order = list(mesh.devices.flat)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        shards = sorted(leaf.addressable_shards,
                        key=lambda s: order.index(s.device))
        out[jreg._leaf_path_name(path)] = [np.asarray(s.data)
                                           for s in shards]
    return out


def _port_leaves(tree):
    return dict(treg._named_leaves(tree))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key", ["gpt2-small-test", "gqa-llama", "mlp"])
def test_rank_trees_equal_jax_addressable_shards(models, key, n):
    if key == "mlp":
        js, ts = jreg.create_model("mlp"), treg.create_model("mlp")
        jp = js.init(jax.random.PRNGKey(0))
        port = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       None, "cpu", "float32")
    else:
        js, ts, jp, npp = models[key]
        port = convert.params_from_jax(npp, ts.config, "cpu", "float32")
    want = _jax_shards(js, jp, n)
    ranks = [_port_leaves(t) for t in
             treg.tp_rank_trees(ts, port, ["cpu"] * n)]
    checked = 0
    for path, shards in want.items():
        parts = path.split("/")
        for r in range(n):
            if parts[0] == "blocks":
                # JAX's stacked (L, ...) leaf against the port's layers.
                for li in range(shards[r].shape[0]):
                    got = ranks[r]["/".join([parts[0], str(li)]
                                            + parts[1:])]
                    np.testing.assert_array_equal(got.numpy(),
                                                  shards[r][li], path)
                    checked += 1
            else:
                np.testing.assert_array_equal(ranks[r][path].numpy(),
                                              shards[r], path)
                checked += 1
    assert checked == sum(len(v) for v in ranks)
    # The placement: column-parallel QKV, row-parallel wo, a sharded head.
    if key != "mlp":
        full = _port_leaves(port)
        r0 = ranks[0]
        for leaf, dim in (("blocks/0/attn/wq/kernel", 1),
                          ("blocks/0/attn/wo/kernel", 0),
                          ("head/kernel", 1)):
            assert r0[leaf].shape[dim] * n == full[leaf].shape[dim]
        assert r0["blocks/0/attn/wo/bias"].shape == \
            full["blocks/0/attn/wo/bias"].shape


def test_unshardable_and_quantized_trees_refuse_like_jax():
    jssd, tssd = jreg.create_model("ssd-small-test"), treg.create_model(
        "ssd-small-test")
    with pytest.raises(RuntimeError, match="cannot be tensor-parallel") as t:
        treg.tp_shard_dims(tssd, {}, 2)
    with pytest.raises(RuntimeError) as j:
        jreg.tp_shardings(jssd, jssd.init(jax.random.PRNGKey(0)),
                          tp_mesh(2))
    assert str(t.value) == str(j.value)
    assert "conv tail" in treg.tp_unshardable_reason(tssd)
    from tpu_engine.ops.quant import quantize_params as jquant
    from tpu_engine_torch.ops.quant import quantize_params as tquant

    js, ts = _specs("gpt2-small-test")
    jp = js.init(jax.random.PRNGKey(0))
    tp = tquant(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                        ts.config, "cpu", "float32"))
    with pytest.raises(RuntimeError, match="weight-quantized") as t:
        treg.tp_rank_trees(ts, tp, ["cpu"] * 2)
    with pytest.raises(RuntimeError) as j:
        jreg.tp_shardings(js, jquant(jp), tp_mesh(2))
    assert str(t.value) == str(j.value)


def test_group_devices_and_reductions():
    group = TPGroup(["cpu"] * 3)
    assert group.size == 3 and group.home == torch.device("cpu")
    assert tp_topology_label(3) == {"tp": 3, "mesh_shape": {"model": 3},
                                    "devices": 3}
    parts = [torch.full((2, 3), v, dtype=torch.bfloat16)
             for v in (1.0, 2.5, -0.5)]
    total = group.reduce_sum(parts)
    assert total.dtype == torch.float32 and torch.all(total == 3.0)
    got = group.gather_last([torch.zeros(2, 1), torch.ones(2, 2)])
    assert got.tolist() == [[0.0, 1.0, 1.0], [0.0, 1.0, 1.0]]
    assert tp_devices(2, ["cpu", "cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError) as t:
        tp_devices(2, ["cpu"])
    with pytest.raises(ValueError) as j:
        tp_mesh(2, devices=jax.devices()[:1])
    assert str(t.value) == str(j.value)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="tp=2 needs 2 devices, have 0"):
            tp_devices(2)
        with pytest.raises(RuntimeError, match="device offset 0"):
            tp_devices(2, offset=0)


# -- the sharded forwards ------------------------------------------------------

B, W, NB, BS = 3, 8, 12, 16
TABLES = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
POS0 = np.array([5, 0, 20], np.int32)
QLEN = np.array([8, 3, 1], np.int32)


def _pool_arrays(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, NB, BS, cfg.kv_heads, cfg.d_head)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _sharded(arr, n):
    """A (L, ..., H_kv, D) array as per-rank contiguous torch shards."""
    return [c.contiguous() for c in torch.from_numpy(arr.copy()).chunk(
        n, dim=-2)]


def _jax_tp(js, jp, n):
    return jax.device_put(jp, jreg.tp_shardings(js, jp, tp_mesh(n)))


def _forward_pair(models, key, n, path):
    """(port tp-n logits, JAX tp-n logits) of one forward on the same
    inputs."""
    js, ts, jp, npp = models[key]
    cfg = ts.config
    tpp = convert.tp_params_from_jax(npp, ts, ["cpu"] * n)
    jparams = _jax_tp(js, jp, n)
    rng = np.random.default_rng(n)
    if path in ("ragged", "decode"):
        kp, vp = _pool_arrays(cfg)
        pool = ttr.KVCache(_sharded(kp, n), _sharded(vp, n))
        jpool = JKVCache(jnp.asarray(kp), jnp.asarray(vp))
    if path == "ragged":
        tokens = rng.integers(0, cfg.vocab, (B, W)).astype(np.int32)
        got = ttr.transformer_step_rows_ragged(
            tpp, torch.from_numpy(tokens), pool, torch.from_numpy(TABLES),
            torch.from_numpy(POS0), torch.from_numpy(QLEN), cfg,
            dtype=torch.float32)[0]
        want = jtr.transformer_step_rows_ragged(
            jparams, jnp.asarray(tokens), jpool, jnp.asarray(TABLES),
            jnp.asarray(POS0), jnp.asarray(QLEN), js.config,
            dtype=jnp.float32,
            attn_fn=jpa.ragged_paged_attention_reference)[0]
    elif path == "decode":
        tok = rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
        pos = np.array([7, 30, 50], np.int32)
        got = ttr.transformer_decode_rows_paged(
            tpp, torch.from_numpy(tok), pool, torch.from_numpy(TABLES),
            torch.from_numpy(pos), cfg, dtype=torch.float32)[0]
        want = jtr.transformer_decode_rows_paged(
            jparams, jnp.asarray(tok), jpool, jnp.asarray(TABLES),
            jnp.asarray(pos), js.config, dtype=jnp.float32,
            attn_fn=jpa.paged_attention_reference)[0]
    elif path == "window":
        tokens = rng.integers(0, cfg.vocab, (2, W)).astype(np.int32)
        pos = np.array([0, 5], np.int32)
        start = np.array([0, 2], np.int32)
        caches = ttr.tp_init_caches(cfg, tpp.group, 2, 32, torch.float32)
        got = ttr.transformer_decode_window(
            tpp, torch.from_numpy(tokens), caches, torch.from_numpy(pos),
            cfg, dtype=torch.float32, start_vec=torch.from_numpy(start))[0]
        want = jtr.transformer_decode_window(
            jparams, jnp.asarray(tokens),
            jtr.init_caches(js.config, 2, 32, jnp.float32),
            jnp.asarray(pos), js.config, dtype=jnp.float32,
            start_vec=jnp.asarray(start))[0]
    else:  # prefill, left-padded
        tokens = rng.integers(1, cfg.vocab, (2, 16)).astype(np.int32)
        mask = np.ones((2, 16), np.int32)
        mask[1, :5] = 0
        tokens[1, :5] = 0
        pos_ids = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(
            np.int32)
        caches = ttr.tp_init_caches(cfg, tpp.group, 2, 16, torch.float32)
        got = ttr.transformer_prefill(
            tpp, torch.from_numpy(tokens), caches, cfg, dtype=torch.float32,
            attn_mask=torch.from_numpy(mask),
            pos_ids=torch.from_numpy(pos_ids))[0]
        want = jtr.transformer_prefill(
            jparams, jnp.asarray(tokens),
            jtr.init_caches(js.config, 2, 16, jnp.float32), js.config,
            dtype=jnp.float32, attn_mask=jnp.asarray(mask),
            pos_ids=jnp.asarray(pos_ids))[0]
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("path", ["ragged", "decode", "window", "prefill"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_tp_forward_logits_match_jax_tp(models, key, n, path):
    """1e-5 in f32: the sum order of the row-parallel products moves the
    last bits only; a bias added once per rank moves logits by the
    bias."""
    got, want = _forward_pair(models, key, n, path)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_tp_forward_adds_row_parallel_bias_once(models):
    """gpt2-small-test's wo/proj biases are zero at init: with nonzero
    ones the tp 2 forward still equals the tp 1 forward."""
    js, ts, _, npp = models["gpt2-small-test"]
    rng = np.random.default_rng(3)
    npp = jax.tree.map(lambda a: a, npp)
    for part in ("attn", "mlp"):
        key = "wo" if part == "attn" else "proj"
        b = npp["blocks"][part][key]["bias"]
        npp["blocks"][part][key]["bias"] = rng.standard_normal(
            b.shape).astype(np.float32)
    cfg = ts.config
    whole = convert.params_from_jax(npp, cfg, "cpu", "float32")
    tpp = convert.tp_params_from_jax(npp, ts, ["cpu"] * 2)
    kp, vp = _pool_arrays(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, W)).astype(
        np.int32))
    args = (torch.from_numpy(TABLES), torch.from_numpy(POS0),
            torch.from_numpy(QLEN), cfg)
    one = ttr.transformer_step_rows_ragged(
        whole, tokens, ttr.KVCache(torch.from_numpy(kp.copy()),
                                   torch.from_numpy(vp.copy())), *args,
        dtype=torch.float32)[0]
    two = ttr.transformer_step_rows_ragged(
        tpp, tokens, ttr.KVCache(_sharded(kp, 2), _sharded(vp, 2)), *args,
        dtype=torch.float32)[0]
    assert torch.allclose(one, two, atol=1e-5, rtol=0)


def test_moe_tp_forward_runs_the_ffn_replicated():
    """gpt2-moe-test: expert banks replicate, the router's gate is
    expert-sharded by the rule and gathered whole; tp 2 equals tp 1."""
    js = jreg.create_model("gpt2-moe-test", max_seq=64)
    ts = treg.create_model("gpt2-moe-test", max_seq=64)
    npp = jax.tree.map(np.asarray, js.init(jax.random.PRNGKey(0)))
    cfg = ts.config
    whole = convert.params_from_jax(npp, cfg, "cpu", "float32")
    tpp = convert.tp_params_from_jax(npp, ts, ["cpu"] * 2)
    assert tpp.ranks[0]["blocks"][0]["mlp"]["gate"]["kernel"].shape[-1] \
        == cfg.n_experts // 2
    assert tpp.ranks[1]["blocks"][0]["mlp"]["wi"].shape == \
        whole["blocks"][0]["mlp"]["wi"].shape
    kp, vp = _pool_arrays(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, W)).astype(np.int32))
    args = (torch.from_numpy(TABLES), torch.from_numpy(POS0),
            torch.from_numpy(QLEN), cfg)
    one = ttr.transformer_step_rows_ragged(
        whole, tokens, ttr.KVCache(torch.from_numpy(kp.copy()),
                                   torch.from_numpy(vp.copy())), *args,
        dtype=torch.float32)[0]
    two = ttr.transformer_step_rows_ragged(
        tpp, tokens, ttr.KVCache(_sharded(kp, 2), _sharded(vp, 2)), *args,
        dtype=torch.float32)[0]
    assert torch.allclose(one, two, atol=1e-5, rtol=0)


# -- streams -------------------------------------------------------------------

LANES = {"mixed": dict(mixed_step=True, mixed_token_budget=32),
         "two-path": {},
         "spec-mixed": dict(spec_k=2, mixed_step=True,
                            mixed_token_budget=32)}


@pytest.fixture(scope="module")
def jax_tp2(models):
    """JAX's tp 2 streams, once per lane kind: PROMPTS greedy, and on the
    mixed lane also seeded and the SHARED pair serialized (a radix
    hit)."""
    js, _, jp, _ = models["gpt2-small-test"]
    out = {}
    for kind, kw in LANES.items():
        gen = JaxGen(js, params=jp, dtype="float32", tp=2, kv_block_size=16,
                     prefill_chunk=16, n_slots=4, **kw)
        try:
            out[kind] = gen.generate(PROMPTS, max_new_tokens=10)
            if kind == "mixed":
                out["seeded"] = gen.generate(PROMPTS, max_new_tokens=10,
                                             temperature=0.9, seed=SEEDS)
                out["shared"] = [gen.generate([p], max_new_tokens=8)[0]
                                 for p in SHARED]
        finally:
            gen.stop()
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", list(LANES))
def test_tp_streams_equal_jax_tp2(gpt2, jax_tp2, kind, n):
    _, ts, _, params = gpt2
    gen = _port_gen(ts, params, tp=n, **LANES[kind])
    try:
        assert gen.generate(PROMPTS, max_new_tokens=10) == jax_tp2[kind]
        st = gen.stats()
        assert st["tp"] == {"tp": n, "mesh_shape": {"model": n},
                            "devices": n}
        assert st["kv_pool"]["tp"] == n
        counters = st["spec"] if "spec" in kind else st.get("mixed")
        if counters is not None:
            assert counters["ticks"] == counters["dispatches"] > 0
        if kind == "mixed":
            assert gen.generate(PROMPTS, max_new_tokens=10, temperature=0.9,
                                seed=SEEDS) == jax_tp2["seeded"]
            assert [gen.generate([p], max_new_tokens=8)[0]
                    for p in SHARED] == jax_tp2["shared"]
            assert gen.stats()["kv_pool"]["prefix_hit_tokens"] > 0
        assert _leak_free(gen.stats())
        shards = gen._pool.caches.k
        assert len(shards) == n and all(s.is_contiguous() for s in shards)
        assert shards[0].shape[3] == ts.config.kv_heads // n
    finally:
        gen.stop()


@pytest.mark.parametrize("mode", ["mixed", "two-path"])
def test_int8_pool_tp2_deterministic_and_equal_to_tp1(gpt2, mode):
    _, ts, _, params = gpt2
    kw = dict(kv_quantize="int8", **(LANES[mode]))
    base = _run(_port_gen(ts, params, **kw), PROMPTS)
    gen = _port_gen(ts, params, tp=2, **kw)
    try:
        out = gen.generate(PROMPTS, max_new_tokens=10)
        assert out == gen.generate(PROMPTS, max_new_tokens=10) == base
        assert len(gen._pool.scales.k) == 2
        assert gen.stats()["kv_pool"]["quantized"] == "int8"
        assert _leak_free(gen.stats())
    finally:
        gen.stop()


@pytest.mark.parametrize("mode", ["mixed", "two-path"])
def test_host_tier_tp2_swaps_in_per_shard(mode):
    """A tp 2 pool with a host tier (tests/test_torch_kv_offload.py's
    churn): a prompt's blocks demote (every shard) and swap back in, and
    the streams and host counters are the tp 1 lane's."""
    ts = treg.create_model("gpt2-small-test", max_seq=128)
    params = ts.init(0, device="cpu", dtype="float32")
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(1, 200, 32)] + [7, 8, 9]
    crng = np.random.default_rng(2)
    churn = [[int(t) for t in crng.integers(1, 200, 48)] for _ in range(3)]
    kw = dict(max_seq=128, n_slots=2, step_chunk=4, kv_blocks=12,
              kv_host_blocks=8, **LANES[mode])

    def serial(gen):
        try:
            out = [gen.generate([p], max_new_tokens=n)[0] for p, n in
                   [(prompt, 8)] + [(c, 4) for c in churn] + [(prompt, 8)]]
            return out, gen.stats()["kv_pool"]["host"]
        finally:
            gen.stop()

    want, want_host = serial(_port_gen(ts, params, **kw))
    got, host = serial(_port_gen(ts, params, tp=2, **kw))
    assert got == want
    assert host["demotions"] > 0 and host["swap_ins"] > 0
    assert host == want_host


def test_scheduler_tp_fences_match_jax(gpt2):
    js, ts, jp, params = gpt2
    cases = [
        (dict(tp=2), dict(tp=2)),
        (dict(tp=2, kv_block_size=16, device="cpu"),
         dict(tp=2, kv_block_size=16, device=jax.devices()[0])),
        (dict(tp=8, kv_block_size=16, tp_devices=["cpu"] * 8),
         dict(tp=8, kv_block_size=16)),
    ]
    for tkw, jkw in cases:
        with pytest.raises((ValueError, RuntimeError)) as t:
            ContinuousGenerator(ts, params=params, dtype="float32", **tkw)
        with pytest.raises((ValueError, RuntimeError)) as j:
            JaxGen(js, params=jp, dtype="float32", **jkw)
        assert (type(t.value), str(t.value)) == (type(j.value),
                                                 str(j.value))
    with pytest.raises(RuntimeError) as t:
        ContinuousGenerator(treg.create_model("ssd-small-test"),
                            dtype="float32", tp=2, device=None,
                            tp_devices=["cpu"] * 2)
    with pytest.raises(RuntimeError) as j:
        JaxGen(jreg.create_model("ssd-small-test"), dtype="float32", tp=2)
    assert str(t.value) == str(j.value)
    assert "cannot serve tensor-parallel" in str(t.value)


# -- chains and migration ------------------------------------------------------

KINDS = {"f32": (jnp.float32, torch.float32, ""),
         "bf16": (jnp.bfloat16, torch.bfloat16, ""),
         "int8": (jnp.bfloat16, torch.bfloat16, "int8")}


def _tp_pools(kind, n=2, host=3):
    jd, td, quant = KINDS[kind]
    jcfg = jreg.create_model("gpt2-small-test").config
    tcfg = treg.create_model("gpt2-small-test").config
    jp = jkv.BlockPool(jcfg, 8, 4, jd, host_blocks=host, quantize=quant,
                       mesh=tp_mesh(n))
    tp = tkv.BlockPool(tcfg, 8, 4, td, host_blocks=host, quantize=quant,
                       tp_devices=["cpu"] * n)
    return jp, tp


def _fill_same(jp, tp, seed=0):
    """The same bytes in both pools: whole arrays into the JAX pool (at
    its sharding), their head slices into the port's shards."""
    rng = np.random.default_rng(seed)
    shape = (tp.cfg.n_layers, tp.num_blocks, tp.block_size,
             tp.cfg.kv_heads, tp.cfg.d_head)
    if tp.quantized:
        arrs = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        arrs += [rng.random(shape[:-1]).astype(np.float32) + 0.01
                 for _ in range(2)]
        jp.caches = jax.device_put(
            JKVCache(jnp.asarray(arrs[0]), jnp.asarray(arrs[1])),
            jp.kv_sharding)
        jp.scales = jax.device_put(
            JKVCache(jnp.asarray(arrs[2]), jnp.asarray(arrs[3])),
            jp.scale_sharding)
    else:
        arrs = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
        jp.caches = jax.device_put(
            JKVCache(*(jnp.asarray(a, jp.io_dtype) for a in arrs)),
            jp.kv_sharding)
    whole = [torch.from_numpy(a) for a in arrs]
    for t, a in zip(tp._pool_tensors(), tp._split(whole)):
        t.copy_(a.to(t.dtype))


def _chain(pool, demote):
    with pool.lock:
        ids = pool.alloc(3)
        toks = list(range(1, 13))
        pool.radix.insert(toks, ids)
        if demote:
            pool.release_many(ids)
            assert pool.radix.evict(2) == 2
            src = pool.radix.chain_nodes(toks)
        else:
            src = ids
        return pool.export_chain(src)


@pytest.mark.parametrize("demote", [False, True], ids=["device", "demoted"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_tp_chain_equals_jax_tp_pool(kind, demote):
    jp, tp = _tp_pools(kind)
    _fill_same(jp, tp)
    jchain, tchain = _chain(jp, demote), _chain(tp, demote)
    assert tchain["tp"] == 2
    assert json.dumps(tchain, sort_keys=True) == json.dumps(
        jchain, sort_keys=True)
    # JAX's chain imports into a fresh port tp 2 pool byte-exact.
    _, dst = _tp_pools(kind)
    assert dst.chain_compatible(jchain) is None
    with dst.lock:
        ids = dst.alloc(3)
        dst.import_chain(jchain, jchain["blocks"], ids)
        assert dst.export_chain(ids)["blocks"] == jchain["blocks"]


def test_chain_tp_stamp_and_geometry_refusal_match_jax():
    jp, tp = _tp_pools("f32", host=0)
    jone = jkv.BlockPool(jreg.create_model("gpt2-small-test").config, 8, 4,
                         jnp.float32)
    tone = tkv.BlockPool(treg.create_model("gpt2-small-test").config, 8, 4,
                         torch.float32, "cpu")
    with tp.lock:
        chain = tp.export_chain(tp.alloc(2))
    assert chain["tp"] == 2 and tkv.BlockPool.verify_chain(chain)
    assert tp.chain_compatible(chain) is None
    reason = tone.chain_compatible(chain)
    assert reason == jone.chain_compatible(chain)
    assert "tp=2" in reason and "shard geometry" in reason
    with tone.lock:
        old = tone.export_chain(tone.alloc(1))
    assert "tp" not in old and tone.chain_compatible(old) is None
    assert tp.chain_compatible(old) == jp.chain_compatible(old)
    assert "tp=1" in tp.chain_compatible(old)
    _, tp4 = _tp_pools("f32", n=4, host=0)
    assert tp4.chain_compatible(chain) == jkv.BlockPool(
        jreg.create_model("gpt2-small-test").config, 8, 4, jnp.float32,
        mesh=tp_mesh(4)).chain_compatible(chain)
    st = tp.stats()
    assert st["tp"] == 2
    assert st["bytes_per_block_per_device"] * 2 == tp.bytes_per_block()
    with pytest.raises(ValueError, match="kv_heads=4 must divide"):
        tkv.BlockPool(tp.cfg, 8, 4, torch.float32, tp_devices=["cpu"] * 3)


def test_migration_between_tp2_lanes_equals_uninterrupted(gpt2):
    _, ts, _, params = gpt2
    control = _run(_port_gen(ts, params, tp=2, mixed_step=True),
                   [PROMPTS[0]], max_new=16)[0]
    assert control == _run(_port_gen(ts, params, mixed_step=True),
                           [PROMPTS[0]], max_new=16)[0]
    src = _port_gen(ts, params, tp=2, mixed_step=True)
    dst = _port_gen(ts, params, tp=2, mixed_step=True)
    one = _port_gen(ts, params, mixed_step=True)
    try:
        q: "queue.Queue" = queue.Queue()
        src.submit(PROMPTS[0], max_new_tokens=16, stream=q, tag="mig",
                   handoff=True, handoff_park_s=60.0)
        snap = src.export_row("mig", timeout_s=60, wait_prefill=True)
        assert snap.get("ok"), snap
        assert snap["chain"]["tp"] == 2
        body = {k: v for k, v in snap.items() if k != "ok"}
        assert dst.submit_import(body).result(120) == control
        assert dst.stats()["kv_pool"]["prefilled_tokens"] == 0
        with pytest.raises(ImportRefused, match="shard geometry"):
            one.submit_import(body).result(120)
        for g in (src, dst, one):
            assert _leak_free(g.stats())
    finally:
        src.stop()
        dst.stop()
        one.stop()


# -- the worker ----------------------------------------------------------------

def _worker_error(pkg, **kw):
    if pkg == "jax":
        from tpu_engine.serving.worker import WorkerNode
        from tpu_engine.utils.config import WorkerConfig
    else:
        from tpu_engine_torch.serving.worker import WorkerNode
        from tpu_engine_torch.utils.config import WorkerConfig
    with pytest.raises(RuntimeError) as err:
        WorkerNode(WorkerConfig(node_id="w", **kw))
    return str(err.value)


@pytest.mark.parametrize("case", [
    dict(model="ssd-small-test", tp=2),
    dict(model="gpt2-small-test", tp=2),
    dict(model="gpt2-small-test", tp=0),
    dict(model="gpt2-small-test", gen_kv_block_size=16, tp=2,
         tp_device_offset=7),
], ids=["unshardable", "dense", "negative", "offset"])
def test_worker_tp_fences_match_jax(case):
    got = _worker_error("torch", **case)
    want = _worker_error("jax", **case)
    if case.get("tp_device_offset"):
        # The slice runs past the local devices: JAX's mesh has 8 CPU
        # devices, this process no card.
        assert "at device offset 7 needs devices [7, 9)" in got
        assert "at device offset 7 needs devices [7, 9)" in want
    else:
        assert got == want


def test_worker_tp_lane_health_and_generate(gpt2):
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig

    _, _, _, params = gpt2

    def lane(nid, tp):
        return WorkerNode(WorkerConfig(
            node_id=nid, model="gpt2-small-test", gen_kv_block_size=16,
            gen_mixed_step=True, tp=tp, device="cpu", dtype="float32"),
            params=params)

    w2, w1 = lane("w_tp2", 2), lane("w_ref", 1)
    try:
        h = w2.get_health()
        assert h["topology"] == {"tp": 2, "mesh_shape": {"model": 2},
                                 "devices": 2}
        assert h["generator"]["tp"] == h["topology"]
        assert "topology" not in w1.get_health()
        assert w2.generator._tp_group.devices == (torch.device("cpu"),) * 2
        req = {"request_id": "t1", "prompt_tokens": PROMPTS[0],
               "max_new_tokens": 8}
        assert (w2.handle_generate(dict(req))["tokens"]
                == w1.handle_generate(dict(req))["tokens"])
        assert w2.get_health()["generator"]["kv_pool"]["tp"] == 2
    finally:
        w2.stop()
        w1.stop()


def test_tp_lane_imports_no_jax():
    """A tp 2 worker and a gateway over it in a fresh process: no jax and
    no tpu_engine module is loaded; the parallel package is."""
    code = (
        "import json, sys\n"
        "from tpu_engine_torch.serving.worker import WorkerNode\n"
        "from tpu_engine_torch.serving.gateway import Gateway\n"
        "from tpu_engine_torch.utils.config import WorkerConfig\n"
        "w = WorkerNode(WorkerConfig(node_id='w', model='gpt2-small-test',"
        " gen_kv_block_size=16, gen_mixed_step=True, tp=2, device='cpu',"
        " dtype='float32'))\n"
        "gw = Gateway([w])\n"
        "tok = w.handle_generate({'request_id': 'b', 'prompt_tokens': [1, 2],"
        " 'max_new_tokens': 3})['tokens']\n"
        "weights = gw.get_stats()['topology']['ring_weights']\n"
        "gw.stop(); w.stop()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'n': len(tok), 'weights': weights, 'bad': bad,"
        " 'mesh': 'tpu_engine_torch.parallel.mesh' in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "n": 3, "weights": {"w": 2}, "bad": [], "mesh": True}


def test_parallel_package_sources_import_no_jax():
    sources = sorted((REPO / "tpu_engine_torch" / "parallel").rglob("*.py"))
    assert REPO / "tpu_engine_torch/parallel/mesh.py" in sources
    offenders = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [n for n in names if n.split(".")[0] in
                          ("jax", "jaxlib", "tpu_engine")]
    assert offenders == []
