"""The GPipe pipeline of the port (``tpu_engine_torch.parallel.pipeline``)
against the JAX package's ``pipeline_apply``, and the transformer's
module-level ``_block_apply`` that the pipeline runs as its layer.

JAX runs on the conftest's 8 virtual CPU devices, the port on
``Mesh(["cpu"] * n, (n,), ("stage",))``, on the same numpy inputs. The
pipeline tests of ``tests/test_moe_pipeline.py`` have their counterparts
here with JAX's tolerances (1e-5 on the tanh layers, 2e-4 on transformer
blocks), over both parameter forms (a tree of stacked (L, ...) tensors,
the port's list of per-layer trees), with JAX's messages for a batch or
a layer count that does not divide. The bubbles are skipped, so each
layer runs once per microbatch: L x M flash forwards over causal blocks.
The lift of ``_block_apply`` out of ``transformer_apply`` is held to the
same bits as the block it replaced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.transformer import (
    TransformerConfig as JConfig,
    _block_apply as jblock_apply,
    transformer_init as jtransformer_init,
)
from tpu_engine.parallel.mesh import create_mesh as jcreate_mesh
from tpu_engine.parallel.pipeline import pipeline_apply as jpipeline
from tpu_engine_torch.models import convert
from tpu_engine_torch.models import transformer as tmod
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import flash, kernels
from tpu_engine_torch.parallel.mesh import Mesh
from tpu_engine_torch.parallel.pipeline import pipeline_apply


def _layer_init(seed, n_layers, d):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_layers, d, d))
                  / np.sqrt(d)).astype(np.float32),
            "b": np.zeros((n_layers, d), np.float32)}


def _jlayer(lp, h):
    return jnp.tanh(h @ lp["w"] + lp["b"])


def _tlayer(lp, h):
    return torch.tanh(h @ lp["w"] + lp["b"])


def _tmesh(n):
    return Mesh(["cpu"] * n, (n,), ("stage",))


def _jmesh(n):
    return jcreate_mesh((n,), ("stage",), devices=jax.devices()[:n])


def _forms(params):
    """The port's two parameter forms of one stacked numpy tree."""
    stacked = {k: torch.from_numpy(v) for k, v in params.items()}
    per_layer = [{k: v[i] for k, v in stacked.items()}
                 for i in range(len(params["w"]))]
    return {"stacked": stacked, "per-layer": per_layer}


@pytest.mark.parametrize("form", ["stacked", "per-layer"])
@pytest.mark.parametrize("stages,layers,d,batch,micro", [
    (8, 16, 8, 16, None),      # test_pipeline_matches_plain_scan
    (4, 8, 4, 24, 8),          # test_pipeline_more_microbatches_than_stages
], ids=["plain-scan", "more-microbatches"])
def test_pipeline_matches_jax(form, stages, layers, d, batch, micro):
    params = _layer_init(stages + layers, layers, d)
    x = np.random.default_rng(1).standard_normal((batch, d)).astype(
        np.float32)
    want = jpipeline(_jlayer, jax.tree.map(jnp.asarray, params),
                     jnp.asarray(x), _jmesh(stages), n_microbatches=micro)
    got = pipeline_apply(_tlayer, _forms(params)[form], torch.from_numpy(x),
                         _tmesh(stages), n_microbatches=micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = torch.from_numpy(x)
    for lp in _forms(params)["per-layer"]:
        plain = _tlayer(lp, plain)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_pipeline_transformer_blocks_match_jax():
    """Transformer blocks pipelined over 8 stages (M 4) against JAX's
    pipeline of its ``_block_apply``; #5's plain version runs L x M times
    (no bubble work)."""
    fields = dict(vocab=64, n_layers=8, d_model=16, n_heads=2, d_ff=32,
                  max_seq=16, causal=True)
    jcfg = JConfig(**fields)
    jp = jax.tree.map(np.asarray, jtransformer_init(jax.random.PRNGKey(0),
                                                    jcfg))
    tokens = np.random.default_rng(1).integers(0, 64, (8, 10))
    h0 = (jp["tok_embed"]["table"][tokens]
          + jp["pos_embed"]["table"][None, :10]).astype(np.float32)

    def jblock(bp, h):
        return jblock_apply(bp, h, jcfg, mask=None, dtype=jnp.float32)

    want = jpipeline(jblock, jax.tree.map(jnp.asarray, jp["blocks"]),
                     jnp.asarray(h0), _jmesh(8), n_microbatches=4)
    cfg = tmod.TransformerConfig(**fields)
    tp = convert.params_from_jax(jp, cfg, "cpu", "float32")

    def tblock(bp, h):
        return tmod._block_apply(bp, h, cfg, mask=None, dtype=torch.float32)

    kernels.reset_counts()
    got = pipeline_apply(tblock, tp["blocks"], torch.from_numpy(h0),
                         _tmesh(8), n_microbatches=4)
    assert flash.flash_attention_fwd.plain_calls == 8 * 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    plain = torch.from_numpy(h0)
    for bp in tp["blocks"]:
        plain = tblock(bp, plain)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("layers,batch,micro", [(12, 8, None), (8, 10, 4)],
                         ids=["layers", "batch"])
def test_pipeline_rejects_bad_divisibility_with_jax_message(layers, batch,
                                                            micro):
    params = _layer_init(4, layers, 4)
    x = np.ones((batch, 4), np.float32)
    with pytest.raises(ValueError, match="not divisible") as jinfo:
        jpipeline(_jlayer, jax.tree.map(jnp.asarray, params),
                  jnp.asarray(x), _jmesh(8), n_microbatches=micro)
    for form in ("stacked", "per-layer"):
        with pytest.raises(ValueError) as info:
            pipeline_apply(_tlayer, _forms(params)[form],
                           torch.from_numpy(x), _tmesh(8),
                           n_microbatches=micro)
        assert str(info.value) == str(jinfo.value)


def test_pipeline_stage_axis_of_a_two_axis_mesh():
    """On a ``data`` x ``stage`` mesh, stage s runs on the rank at s on
    ``stage`` and 0 on ``data``; the result lands on ``mesh.home``."""
    seen = []

    def layer(lp, h):
        seen.append(lp["w"].device)
        return _tlayer(lp, h)

    params = _layer_init(5, 4, 4)
    mesh = Mesh(["cpu"] * 4, (2, 2), ("data", "stage"))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 4)).astype(np.float32))
    got = pipeline_apply(layer, _forms(params)["stacked"], x, mesh)
    plain = x
    for lp in _forms(params)["per-layer"]:
        plain = _tlayer(lp, plain)
    assert got.device == mesh.home
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert len(seen) == 4 * 2


# -- _block_apply, lifted out of transformer_apply --------------------------------

def _closure_forward(params, tokens, cfg, dtype):
    """``transformer_apply`` as it was before ``_block_apply`` was lifted
    out: the block as a closure over the forward's arguments."""
    positions = torch.arange(tokens.shape[1])
    h = tmod._embed(params, tokens, positions[None, :], cfg, dtype)
    attn_fn = flash.flash_attention

    def block(bp, h):
        if cfg.post_ln:
            h = tmod._norm(bp["ln1"], h + tmod._attn(
                bp, h, cfg, mask=None, dtype=dtype, attn_fn=attn_fn,
                positions=positions), cfg)
            h = tmod._norm(bp["ln2"], h + tmod._mlp(bp["mlp"], h, dtype,
                                                    cfg), cfg)
        else:
            h = h + tmod._attn(bp, tmod._norm(bp["ln1"], h, cfg), cfg,
                               mask=None, dtype=dtype, attn_fn=attn_fn,
                               positions=positions)
            h = h + tmod._mlp(bp["mlp"], tmod._norm(bp["ln2"], h, cfg),
                              dtype, cfg)
        return h.to(dtype)

    for bp in params["blocks"]:
        h = block(bp, h)
    return tmod._head(params, h, cfg, dtype)


@pytest.mark.parametrize("model", ["llama-small-test", "gpt2-small-test",
                                   "gpt2-moe-test", "bert-small-test"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_apply_lift_gives_the_same_bits(model, dtype):
    spec = create_model(model)
    cfg = spec.config
    params = convert.init_params(cfg, seed=3, device="cpu", dtype=dtype)
    dt = getattr(torch, dtype)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab, (2, 12)))
    got = tmod.transformer_apply(params, tokens, cfg, dtype=dt)
    want = _closure_forward(params, tokens, cfg, dt)
    assert torch.equal(got, want)

