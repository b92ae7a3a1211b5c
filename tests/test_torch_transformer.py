"""The port's transformer (tpu_engine_torch.models) against the JAX
package's: config fields for every dense decoder name, the weight
carry-across, and the ragged mixed step's logits and pool writes on a
ragged batch (decode rows plus a chunk crossing a block boundary) with
the same weights, within 1e-4 (f32 on both sides; two layers of
differently ordered f32 sums)."""

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
    assert available_models() == sorted(DENSE_NAMES)
    for name in ("gpt2-moe", "gpt2-moe-test", "mlp", "bert", "mamba2"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tcreate(name)
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
    args = (tparams, torch.from_numpy(tokens),
            tt.KVCache(torch.from_numpy(k0), torch.from_numpy(v0)),
            torch.from_numpy(tables), torch.from_numpy(pos0),
            torch.from_numpy(qlen))
    with pytest.raises(NotImplementedError, match="int8"):
        tt.transformer_step_rows_ragged(*args, tcfg, scales=object())
    mcfg = tcreate("mistral-small-test").config
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tt.transformer_step_rows_ragged(*args, mcfg)


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
