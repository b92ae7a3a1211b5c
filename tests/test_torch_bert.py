"""``bert-small-test`` in the port (``tpu_engine_torch.models.bert``: the
encoder dialect of ``transformer_apply`` through the flash attention's
padding mask) against the JAX package's on the same weights
(``params_from_jax``), then the port's engine and worker /infer against the
JAX engine, and the encoder's refusals on every generation lane. All on the
CPU, where the flash wrapper takes its plain version.

Tolerances: f32 1e-5 (the same f32 ops summed in another order); bf16 2e-2
on logits of magnitude ~4 (bf16 rounds the residual stream at each block's
end and the attention weights before the PV product, at the same points in
both, but XLA and PyTorch order the f32 sums differently, which moves a
rounding across a bf16 ulp, 8e-3 at 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
from tpu_engine_torch.models import transformer as tt
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops.flash import flash_attention_reference
from tpu_engine_torch.runtime.engine import InferenceEngine
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import WorkerConfig

_ensure_builtin_models_imported()

NAME = "bert-small-test"
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
REFERENCE_PAYLOAD = [0.1, 0.2, 0.3]  # truncates to token 0: all pad


@pytest.fixture(scope="module")
def models():
    jspec = jcreate(NAME)
    jparams = jspec.init(jax.random.PRNGKey(0))
    return jspec, jparams, jax.tree.map(np.asarray, jparams)


def _tparams(jspec, tree, dtype="float32"):
    return params_from_jax(tree, jspec.config, device="cpu", dtype=dtype)


def _batch() -> np.ndarray:
    """Full rows, right-padded rows, one all-pad row, fractional ids."""
    rng = np.random.default_rng(7)
    x = rng.integers(1, 512, (5, 32)).astype(np.float32)
    x[1, 9:] = 0.0
    x[2, 1:] = 0.0
    x[3] = 0.0
    x[4, :4] = [3.7, 511.9, 900.0, -2.5]  # truncation toward zero, clip
    return x


def test_config_and_spec_match_jax(models):
    jspec, _, tree = models
    tspec = tcreate(NAME)
    assert dataclasses.asdict(tspec.config) == dataclasses.asdict(
        jspec.config)
    assert (tspec.input_shape, tspec.output_shape) == (jspec.input_shape,
                                                       jspec.output_shape)
    assert tspec.state_family == "stateless" and tspec.token_input
    full = tcreate("bert")
    assert (full.config.n_layers, full.config.d_model, full.config.n_heads,
            full.input_shape, full.output_shape) == (12, 768, 12, (384,),
                                                     (384, 2))
    tp = tspec.init(0, device="cpu", dtype="float32")
    assert sorted(tp) == sorted(tree)
    assert tuple(tp["head"]["kernel"].shape) == (64, 2)
    assert "ln_f" not in tp and tuple(tp["type_embed"]["table"].shape) == (
        2, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_jax(models, dtype):
    jspec, jparams, tree = models
    x = _batch()
    want = np.asarray(jspec.apply(jparams, jnp.asarray(x),
                                  dtype=getattr(jnp, dtype)))
    got = tcreate(NAME).apply(_tparams(jspec, tree, dtype),
                              torch.from_numpy(x),
                              dtype=getattr(torch, dtype)).numpy()
    assert got.shape == (5, 32, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOLS[dtype],
                               rtol=TOLS[dtype])


def test_all_pad_rows_attend_nothing(models):
    """A row of pad ids only: every key masked, every query row's attention
    0 (no NaN into the post-LN), in the flash wrapper and its plain
    version alike; its logits are those of zero attention."""
    jspec, _, tree = models
    tp = _tparams(jspec, tree)
    cfg = tcreate(NAME).config
    tokens = torch.zeros((2, 32), dtype=torch.int32)
    tokens[0, :5] = torch.arange(1, 6)
    mask = (tokens > 0).to(torch.int32)
    out = tt.transformer_apply(tp, tokens, cfg, mask=mask,
                               dtype=torch.float32)
    ref = tt.transformer_apply(
        tp, tokens, cfg, mask=mask, dtype=torch.float32,
        attn_fn=lambda *a, **k: flash_attention_reference(*a, **k)[0])
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)

    def zero_attn(q, k, v, **_kw):
        return torch.zeros_like(q)

    zero = tt.transformer_apply(tp, tokens[1:], cfg, mask=mask[1:],
                                dtype=torch.float32, attn_fn=zero_attn)
    torch.testing.assert_close(out[1:], zero, atol=1e-6, rtol=1e-6)


def test_encoder_refused_on_generation_lanes(models):
    jspec, _, tree = models
    tp = _tparams(jspec, tree)
    cfg = tcreate(NAME).config
    tokens = torch.ones((1, 8), dtype=torch.int32)
    caches = tt.init_caches(cfg, 1, 8, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder"):
        tt.transformer_prefill(tp, tokens, caches, cfg, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="encoder"):
        tt.transformer_decode_rows(tp, tokens[:, 0], caches,
                                   torch.zeros(1, dtype=torch.int32), cfg,
                                   dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="encoder"):
        tt.transformer_decode_window(tp, tokens, caches,
                                     torch.zeros(1, dtype=torch.int32), cfg,
                                     dtype=torch.float32)
    pool = tt.KVCache(torch.zeros((2, 4, 16, 4, 16)),
                      torch.zeros((2, 4, 16, 4, 16)))
    tables = torch.ones((1, 1), dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="encoder"):
        tt.transformer_step_rows_ragged(tp, tokens, pool, tables, pos,
                                        torch.full((1,), 8), cfg,
                                        dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="encoder"):
        tt.transformer_decode_rows_paged(tp, tokens[:, 0], pool, tables, pos,
                                         cfg, dtype=torch.float32)
    # Mixture-of-experts blocks are ported: an encoder with experts runs
    # the full-sequence forward (and still no generation lane).
    from tpu_engine_torch.models.convert import init_params

    moe = dataclasses.replace(cfg, n_experts=2)
    mp = init_params(moe, seed=0, device="cpu", dtype="float32")
    out = tt.transformer_apply(mp, tokens, moe, dtype=torch.float32)
    assert out.shape == (1, 8, moe.vocab) and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="encoder"):
        tt.transformer_prefill(mp, tokens, caches, moe, dtype=torch.float32)
    for knobs in (dict(gen_kv_block_size=16), dict(gen_mixed_step=True),
                  dict(gen_continuous_spec_k=2)):
        with pytest.raises(RuntimeError):
            WorkerNode(WorkerConfig(model=NAME, device="cpu", **knobs))
    w = WorkerNode(WorkerConfig(model=NAME, device="cpu", dtype="float32"))
    try:
        with pytest.raises(ValueError, match="does not support generation"):
            w.handle_generate({"request_id": "g", "prompt_tokens": [1, 2]})
        with pytest.raises(ValueError, match="does not support scoring"):
            w.handle_score({"request_id": "s", "prompt_tokens": [1],
                            "completion_tokens": [2]})
    finally:
        w.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_matches_jax_engine(models, dtype):
    """Variable-length token-id payloads, zero-padded to 32 by both
    engines (f32 wire: ids past 256 stay exact in bf16 engines), with the
    all-pad reference payload among them."""
    jspec, jparams, tree = models
    je = JaxEngine(jspec, params=jparams, dtype=dtype, batch_buckets=(1, 4))
    te = InferenceEngine(NAME, params=_tparams(jspec, tree, dtype),
                         dtype=dtype, batch_buckets=(1, 4), device="cpu")
    rng = np.random.default_rng(3)
    inputs = [rng.integers(1, 512, n).astype(np.float32).tolist()
              for n in (1, 7, 32, 40, 16)] + [REFERENCE_PAYLOAD]
    want = je.batch_predict(inputs)
    got = te.batch_predict(inputs)
    for w_, g in zip(want, got):
        assert g.shape == (64,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w_, atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.parametrize("unified", [True, False])
def test_worker_infer_end_to_end(models, unified):
    jspec, jparams, tree = models
    je = JaxEngine(jspec, params=jparams, dtype="float32")
    w = WorkerNode(WorkerConfig(model=NAME, dtype="float32", device="cpu",
                                batch_buckets=(1, 2, 4),
                                unified_stateless=unified),
                   params=_tparams(jspec, tree))
    try:
        rng = np.random.default_rng(5)
        payloads = [rng.integers(1, 512, n).astype(np.float32).tolist()
                    for n in (3, 12, 32)] + [REFERENCE_PAYLOAD]
        for i, p in enumerate(payloads):
            r = w.handle_infer({"request_id": f"b{i}", "input_data": p})
            assert not r["cached"] and len(r["output_data"]) == 64
            np.testing.assert_allclose(r["output_data"],
                                       je.batch_predict([p])[0], atol=1e-5,
                                       rtol=1e-5)
        again = w.handle_infer({"request_id": "again",
                                "input_data": payloads[1]})
        assert again["cached"]
        health = w.get_health()
        assert "generator" not in health and health["cache_hits"] == 1
    finally:
        w.stop()
