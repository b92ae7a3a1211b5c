"""BERT family, the bidirectional encoder for extractive QA (counterpart of
``tpu_engine/models/bert.py``; same names, geometries and apply).

The serving contract of the reference's BERT-base-squad deployment
(BASELINE.json config 3): input = token ids as floats, shape (seq_len,),
pad id 0; output = the start/end logits, (seq_len, 2), flattened on the
wire. The engine zero-pads a short request to seq_len, and the padding
mask (``tokens > 0``) keeps the pad keys out of every query's attention;
a request of pad ids only attends nothing (its attention is 0).
"""

from __future__ import annotations

import torch

from tpu_engine_torch.models.registry import ModelSpec, register
from tpu_engine_torch.models.transformer import (
    TransformerConfig,
    transformer_apply,
)


def _bert_cfg(**kw) -> TransformerConfig:
    """The HF BERT dialect: post-LN blocks, LayerNorm'd embeddings with a
    segment table, erf GELU, eps 1e-12, no causal mask."""
    return TransformerConfig(causal=False, post_ln=True, embed_ln=True,
                             type_vocab=2, gelu_tanh=False, ln_eps=1e-12,
                             **kw)


def _make_bert(name: str, cfg: TransformerConfig, seq_len: int,
               n_outputs: int = 2) -> ModelSpec:
    def init(seed, device, dtype):
        from tpu_engine_torch.models.convert import init_params
        from tpu_engine_torch.models.mlp import dense_init
        from tpu_engine_torch.utils.device import resolve_device, resolve_dtype

        dev, dt = resolve_device(device), resolve_dtype(dtype)
        params = init_params(cfg, seed, device=dev, dtype=dt)
        # The QA span head (start/end logits) replaces the LM head.
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed) + 1)
        params["head"] = dense_init(g, cfg.d_model, n_outputs, dev, dt)
        return params

    def apply(params, x, dtype=torch.bfloat16):
        # Truncation toward zero, then the clip, as JAX's astype(int32).
        tokens = torch.clamp(torch.trunc(x), 0, cfg.vocab - 1).to(
            torch.int32)
        mask = (tokens > 0).to(torch.int32)
        return transformer_apply(params, tokens, cfg, mask=mask, dtype=dtype)

    # The JAX registry's declaration: the encoder's blocks take the
    # transformer families' named layout.
    return ModelSpec(name, cfg, apply=apply, input_shape=(seq_len,),
                     output_shape=(seq_len, n_outputs), init_fn=init,
                     tp_rule="transformer")


@register("bert")
def make_bert(seq_len: int = 384, vocab: int = 30522, n_layers: int = 12,
              d_model: int = 768, n_heads: int = 12, d_ff: int = 3072,
              max_seq: int = 512) -> ModelSpec:
    cfg = _bert_cfg(vocab=vocab, n_layers=n_layers, d_model=d_model,
                    n_heads=n_heads, d_ff=d_ff, max_seq=max_seq)
    return _make_bert("bert", cfg, seq_len)


@register("bert-small-test")
def make_bert_small(seq_len: int = 32, vocab: int = 512, n_layers: int = 2,
                    d_model: int = 64, n_heads: int = 4, d_ff: int = 128,
                    max_seq: int = 64) -> ModelSpec:
    cfg = _bert_cfg(vocab=vocab, n_layers=n_layers, d_model=d_model,
                    n_heads=n_heads, d_ff=d_ff, max_seq=max_seq)
    return _make_bert("bert-small-test", cfg, seq_len)
