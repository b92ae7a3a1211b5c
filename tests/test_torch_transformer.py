"""The port's transformer (tpu_engine_torch.models) against the JAX
package's: config fields for every dense decoder name, the weight
carry-across, and with the same weights and numpy-seeded inputs the
logits and cache writes of the ragged mixed step (decode rows plus a
chunk crossing a block boundary; f32 and int8 pools), of the two-path
prefill windows over a dense row cache, and of the paged decode step
(f32 and int8 pools). Bound: 1e-4 on logits and f32 caches (f32 on both
sides; two layers of differently ordered f32 sums); int8 payloads within
one step of each other (a value at a rounding tie may round either way
after such sums), scales within 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models import transformer as jt
from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.ops.attention import KVCache as JKV
from tpu_engine.ops.quant import quantize_kv as jquantize
from tpu_engine_torch.models import convert, transformer as tt
from tpu_engine_torch.models.registry import (
    available_models,
    create_model as tcreate,
)

_ensure_builtin_models_imported()

TOL = 1e-4
DENSE_NAMES = ["gpt2", "distilgpt2", "gpt2-small-test", "gpt2-chaos-test",
               "llama", "llama-small-test", "mistral", "mistral-small-test"]


@pytest.mark.parametrize("name", DENSE_NAMES)
def test_config_fields_equal_jax(name):
    jcfg = dataclasses.asdict(jcreate(name).config)
    tcfg = dataclasses.asdict(tcreate(name).config)
    assert tcfg == jcfg


def test_registry_serves_the_dense_names_and_refuses_the_rest():
    # Every name of the JAX registry is served, the MoE pair included
    # (tests/test_torch_moe.py); an unknown name still refuses.
    assert available_models() == sorted(
        DENSE_NAMES + ["mlp", "resnet50", "resnet50-v1", "bert",
                       "bert-small-test", "yolov8n", "yolov8n-small-test",
                       "mamba2", "ssd-small-test", "gpt2-moe",
                       "gpt2-moe-test"])
    for name in ("gpt2-moe", "gpt2-moe-test"):
        assert tcreate(name).config.n_experts > 0
    with pytest.raises(KeyError):
        tcreate("no-such-model")


def _models(name):
    spec = jcreate(name)
    params = spec.init(jax.random.PRNGKey(0))
    tspec = tcreate(name)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      tspec.config, device="cpu")
    return spec.config, params, tspec.config, tparams


@pytest.mark.parametrize("name", ["gpt2-small-test", "llama-small-test"])
def test_params_from_jax_round_trip(name):
    _, params, tcfg, tparams = _models(name)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(tparams["blocks"]) == tcfg.n_layers
    for path, leaf in flat:
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        if keys[0] == "blocks":
            for li in range(tcfg.n_layers):
                node = tparams["blocks"][li]
                for k in keys[1:]:
                    node = node[k]
                np.testing.assert_array_equal(node.numpy(), leaf[li])
        else:
            node = tparams
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), leaf)


def _ragged_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    nb_pool, bs = 12, 16
    shape = (cfg.n_layers, nb_pool, bs, cfg.kv_heads, cfg.d_head)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    b, w = 4, 20
    tokens = rng.integers(0, cfg.vocab, (b, w)).astype(np.int32)
    # Two decode rows, a 20-token chunk from column 10 (crossing the
    # 16-column block boundary), and a free row (qlen 0, null table).
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9],
                       [0, 0, 0, 0]], np.int32)
    pos0 = np.array([5, 20, 10, 0], np.int32)
    qlen = np.array([1, 1, 20, 0], np.int32)
    sample_slot = np.array([0, 0, 19, 0], np.int32)
    return k0, v0, tokens, tables, pos0, qlen, sample_slot


@pytest.mark.parametrize("name", ["gpt2-small-test", "llama-small-test"])
@pytest.mark.parametrize("sample", [True, False])
def test_step_rows_ragged_matches_jax(name, sample):
    jcfg, params, tcfg, tparams = _models(name)
    k0, v0, tokens, tables, pos0, qlen, slot = _ragged_batch(jcfg)
    jl, jc = jt.transformer_step_rows_ragged(
        params, jnp.asarray(tokens), JKV(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(tables), jnp.asarray(pos0), jnp.asarray(qlen), jcfg,
        dtype=jnp.float32,
        sample_slot=jnp.asarray(slot) if sample else None)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl, tc = tt.transformer_step_rows_ragged(
        tparams, torch.from_numpy(tokens), tt.KVCache(tk, tv),
        torch.from_numpy(tables), torch.from_numpy(pos0),
        torch.from_numpy(qlen), tcfg, dtype=torch.float32,
        sample_slot=torch.from_numpy(slot) if sample else None)
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    # Padding slots and the free row read the null block, which holds
    # whichever padding write landed last: garbage by contract.
    if sample:
        live = qlen > 0
        np.testing.assert_allclose(tl.numpy()[live], jl[live], atol=TOL,
                                   rtol=TOL)
    else:
        valid = np.arange(tokens.shape[1])[None, :] < qlen[:, None]
        np.testing.assert_allclose(tl.numpy()[valid], jl[valid], atol=TOL,
                                   rtol=TOL)
    # The pool is written in place; every block but the null block (the
    # padding slots' dump) matches.
    assert tc.k is tk
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jc.k)[:, 1:],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jc.v)[:, 1:],
                               atol=TOL, rtol=TOL)


def test_step_refuses_unported_paths():
    _, _, tcfg, tparams = _models("llama-small-test")
    k0, v0, tokens, tables, pos0, qlen, _ = _ragged_batch(tcfg)
    caches = tt.KVCache(torch.from_numpy(k0), torch.from_numpy(v0))
    args = (tparams, torch.from_numpy(tokens), caches,
            torch.from_numpy(tables), torch.from_numpy(pos0),
            torch.from_numpy(qlen))
    mcfg = tcreate("mistral-small-test").config
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tt.transformer_step_rows_ragged(*args, mcfg)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tt.transformer_decode_rows_paged(
            tparams, torch.from_numpy(tokens[:, 0]), caches,
            torch.from_numpy(tables), torch.from_numpy(pos0), mcfg)


def _quant_pool(k0, v0):
    """Quantize f32 pools with the JAX write path: (int8 k, int8 v, f32
    scales k, f32 scales v) numpy arrays."""
    qk, sk = jquantize(jnp.asarray(k0))
    qv, sv = jquantize(jnp.asarray(v0))
    return [np.array(a) for a in (qk, qv, sk, sv)]


def _assert_pools_match(tpools, jpools, quant):
    """Every block but the null block (padding writes' dump)."""
    if not quant:
        for t, j in zip(tpools, jpools):
            np.testing.assert_allclose(t.numpy()[:, 1:],
                                       np.asarray(j)[:, 1:], atol=TOL,
                                       rtol=TOL)
        return
    for t, j in zip(tpools[:2], jpools[:2]):
        diff = np.abs(t.numpy()[:, 1:].astype(np.int32)
                      - np.asarray(j)[:, 1:].astype(np.int32))
        assert diff.max() <= 1
    for t, j in zip(tpools[2:], jpools[2:]):
        np.testing.assert_allclose(t.numpy()[:, 1:], np.asarray(j)[:, 1:],
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["gpt2-small-test", "llama-small-test"])
def test_step_rows_ragged_int8_matches_jax(name):
    jcfg, params, tcfg, tparams = _models(name)
    k0, v0, tokens, tables, pos0, qlen, slot = _ragged_batch(jcfg, seed=1)
    qk, qv, sk, sv = _quant_pool(k0, v0)
    jl, jc, js = jt.transformer_step_rows_ragged(
        params, jnp.asarray(tokens), JKV(jnp.asarray(qk), jnp.asarray(qv)),
        jnp.asarray(tables), jnp.asarray(pos0), jnp.asarray(qlen), jcfg,
        dtype=jnp.float32, sample_slot=jnp.asarray(slot),
        scales=JKV(jnp.asarray(sk), jnp.asarray(sv)))
    tpools = [torch.from_numpy(a.copy()) for a in (qk, qv, sk, sv)]
    tl, tc, ts = tt.transformer_step_rows_ragged(
        tparams, torch.from_numpy(tokens), tt.KVCache(*tpools[:2]),
        torch.from_numpy(tables), torch.from_numpy(pos0),
        torch.from_numpy(qlen), tcfg, dtype=torch.float32,
        sample_slot=torch.from_numpy(slot),
        scales=tt.KVCache(*tpools[2:]))
    assert tc.k is tpools[0] and ts.k is tpools[2]
    live = qlen > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=TOL, rtol=TOL)
    _assert_pools_match(tpools, [jc.k, jc.v, js.k, js.v], quant=True)


@pytest.mark.parametrize("name", ["gpt2-small-test", "llama-small-test"])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_rows_paged_matches_jax(name, quant):
    jcfg, params, tcfg, tparams = _models(name)
    k0, v0, tokens, tables, _, _, _ = _ragged_batch(jcfg, seed=2)
    tok = tokens[:, 0]
    # Rows at their write columns: inside a block, at a block's first
    # column, deep in the table, and a free row (null table, pos 0).
    pos = np.array([5, 16, 40, 0], np.int32)
    pools = _quant_pool(k0, v0) if quant else [k0, v0]
    jargs = dict(scales=JKV(jnp.asarray(pools[2]), jnp.asarray(pools[3]))
                 ) if quant else {}
    jout = jt.transformer_decode_rows_paged(
        params, jnp.asarray(tok), JKV(jnp.asarray(pools[0]),
                                      jnp.asarray(pools[1])),
        jnp.asarray(tables), jnp.asarray(pos), jcfg, dtype=jnp.float32,
        **jargs)
    tpools = [torch.from_numpy(np.array(a)) for a in pools]
    targs = dict(scales=tt.KVCache(*tpools[2:])) if quant else {}
    tout = tt.transformer_decode_rows_paged(
        tparams, torch.from_numpy(tok), tt.KVCache(*tpools[:2]),
        torch.from_numpy(tables), torch.from_numpy(pos), tcfg,
        dtype=torch.float32, **targs)
    assert len(tout) == (3 if quant else 2)
    live = np.array([True, True, True, False])  # the free row reads garbage
    np.testing.assert_allclose(tout[0].numpy()[live],
                               np.asarray(jout[0])[live], atol=TOL, rtol=TOL)
    jpools = [jout[1].k, jout[1].v] + ([jout[2].k, jout[2].v] if quant
                                       else [])
    _assert_pools_match(tpools, jpools, quant)


@pytest.mark.parametrize("name", ["gpt2-small-test", "llama-small-test",
                                  "mistral-small-test"])
@pytest.mark.parametrize("head", ["all", "last", "none"])
def test_decode_window_matches_jax(name, head):
    jcfg, params, tcfg, tparams = _models(name)
    rng = np.random.default_rng(4)
    pb, w = 32, 12
    tokens = rng.integers(0, jcfg.vocab, (2, pb)).astype(np.int32)
    jc = jt.init_caches(jcfg, 2, pb, jnp.float32)
    tc = tt.init_caches(tcfg, 2, pb, torch.float32, device="cpu")
    assert tuple(tc.k.shape) == tuple(jc.k.shape)
    start = np.array([0, 3], np.int32)
    # Three windows per row, the last one narrower (a prompt's tail).
    for w0 in (0, w, 2 * w):
        width = min(w, pb - w0)
        pos = np.full((2,), w0, np.int32)
        jl, jc = jt.transformer_decode_window(
            params, jnp.asarray(tokens[:, w0:w0 + width]), jc,
            jnp.asarray(pos), jcfg, dtype=jnp.float32,
            start_vec=jnp.asarray(start), head=head)
        tl, tc2 = tt.transformer_decode_window(
            tparams, torch.from_numpy(tokens[:, w0:w0 + width]), tc,
            torch.from_numpy(pos), tcfg, dtype=torch.float32,
            start_vec=torch.from_numpy(start), head=head)
        assert tc2.k is tc.k
        if head == "none":
            assert tl is None and jl is None
        else:
            assert tuple(tl.shape) == tuple(jl.shape)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=TOL,
                               rtol=TOL)


def test_init_params_is_seeded_and_shaped():
    cfg = tcreate("llama-small-test").config
    a = convert.init_params(cfg, seed=1, device="cpu", dtype="bfloat16")
    b = convert.init_params(cfg, seed=1, device="cpu", dtype="bfloat16")
    c = convert.init_params(cfg, seed=2, device="cpu", dtype="bfloat16")
    wq = a["blocks"][0]["attn"]["wq"]["kernel"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (64, 64)
    assert a["blocks"][1]["attn"]["wk"]["kernel"].shape == (64, 32)
    assert a["tok_embed"]["table"].dtype == torch.float32
    assert torch.equal(wq, b["blocks"][0]["attn"]["wq"]["kernel"])
    assert not torch.equal(wq, c["blocks"][0]["attn"]["wq"]["kernel"])
    jshapes = jax.tree.map(lambda x: x.shape,
                           jcreate("llama-small-test").init(
                               jax.random.PRNGKey(0)))
    assert sorted(a) == sorted(jshapes)


# -- the dense scheduler's forwards and the full-sequence forward ----------

SMALL = ["gpt2-small-test", "llama-small-test", "mistral-small-test"]


def _left_padded(cfg, pb=32, lens=(32, 19), seed=5):
    """A left-padded batch of two prompts (tokens, attn_mask, pos_ids) as
    the dense scheduler builds one: row b's prompt at columns
    [pb - lens[b], pb), positions from 0 at its first token."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    tokens = np.zeros((b, pb), np.int32)
    attn = np.zeros((b, pb), np.int32)
    pos_ids = np.zeros((b, pb), np.int32)
    for r, n in enumerate(lens):
        tokens[r, pb - n:] = rng.integers(1, cfg.vocab, n)
        attn[r, pb - n:] = 1
        pos_ids[r, pb - n:] = np.arange(n)
    return tokens, attn, pos_ids


def _prefill_both(name, pb=32):
    jcfg, params, tcfg, tparams = _models(name)
    tokens, attn, pos_ids = _left_padded(jcfg, pb)
    jl, jc = jt.transformer_prefill(
        params, jnp.asarray(tokens), jt.init_caches(jcfg, 2, 48, jnp.float32),
        jcfg, dtype=jnp.float32, attn_mask=jnp.asarray(attn),
        pos_ids=jnp.asarray(pos_ids))
    tc = tt.init_caches(tcfg, 2, 48, torch.float32, device="cpu")
    tl, tc2 = tt.transformer_prefill(
        tparams, torch.from_numpy(tokens), tc, tcfg, dtype=torch.float32,
        attn_mask=torch.from_numpy(attn), pos_ids=torch.from_numpy(pos_ids))
    assert tc2.k is tc.k
    assert tuple(tl.shape) == tuple(jl.shape) == (2, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    # Every column: the prompt's K/V, the pad columns' (masked later by
    # the row's start), and the untouched zeros past the bucket.
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", SMALL)
def test_prefill_matches_jax(name):
    _prefill_both(name)


@pytest.mark.parametrize("name", ["llama-small-test", "mistral-small-test"])
def test_prefill_matches_jax_flash_path(name, monkeypatch):
    """The JAX side through its Pallas flash kernel (interpreted), as on a
    TPU: the port's prefill equals it too."""
    monkeypatch.setenv("TPU_ENGINE_FLASH", "1")
    assert jt.default_attention().__module__ == "tpu_engine.ops.flash"
    _prefill_both(name)


@pytest.mark.parametrize("name", SMALL)
def test_decode_rows_matches_jax(name):
    """Per-row positions and starts over a dense cache: two steps, rows at
    different depths, one row at the last cache column."""
    jcfg, params, tcfg, tparams = _models(name)
    rng = np.random.default_rng(6)
    shape = (jcfg.n_layers, 4, 48, jcfg.kv_heads, jcfg.d_head)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    pos = np.array([20, 33, 46, 5], np.int32)
    start = np.array([3, 0, 10, 5], np.int32)
    tok = rng.integers(0, jcfg.vocab, 4).astype(np.int32)
    jc = JKV(jnp.asarray(k0), jnp.asarray(v0))
    tc = tt.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    for _ in range(2):
        jl, jc = jt.transformer_decode_rows(
            params, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg,
            dtype=jnp.float32, start_vec=jnp.asarray(start))
        tl, tc2 = tt.transformer_decode_rows(
            tparams, torch.from_numpy(tok), tc, torch.from_numpy(pos), tcfg,
            dtype=torch.float32, start_vec=torch.from_numpy(start))
        assert tc2.k is tc.k
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("masked", [False, True])
def test_apply_matches_jax(name, masked):
    jcfg, params, tcfg, tparams = _models(name)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 18:] = 0
    jl = jt.transformer_apply(params, jnp.asarray(tokens), jcfg,
                              mask=jnp.asarray(mask) if masked else None,
                              dtype=jnp.float32)
    tl = tt.transformer_apply(tparams, torch.from_numpy(tokens), tcfg,
                              mask=torch.from_numpy(mask) if masked
                              else None, dtype=torch.float32)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)


def test_dense_forwards_refuse_unported_dialects():
    _, _, tcfg, tparams = _models("llama-small-test")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    # The encoder dialect serves only the full-sequence forward. MoE
    # blocks serve every forward (tests/test_torch_moe.py).
    moe = dataclasses.replace(tcfg, n_experts=2)
    mp = convert.init_params(moe, seed=0, device="cpu", dtype="float32")
    logits, _ = tt.transformer_prefill(
        mp, tokens, tt.init_caches(moe, 1, 8, torch.float32, device="cpu"),
        moe, dtype=torch.float32)
    assert torch.isfinite(logits).all()
    for bad, why in ((dict(post_ln=True), "encoder"),
                     (dict(embed_ln=True), "encoder"),
                     (dict(type_vocab=2), "encoder")):
        cfg = dataclasses.replace(tcfg, **bad)
        with pytest.raises(NotImplementedError, match=why):
            tt.transformer_prefill(tparams, tokens,
                                   tt.init_caches(tcfg, 1, 8, torch.float32,
                                                  device="cpu"),
                                   cfg, dtype=torch.float32)
