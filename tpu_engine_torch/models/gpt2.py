"""GPT-2 family configs (counterpart of ``tpu_engine/models/gpt2.py``;
same names and values), the mixture-of-experts variants included.

One-shot /infer contract (``decoder_spec``): input = token ids as floats,
shape (seq_len,); output = the logits of the last non-pad position, shape
(vocab,)."""

from __future__ import annotations

import torch

from tpu_engine_torch.models.registry import ModelSpec, register
from tpu_engine_torch.models.transformer import (
    TransformerConfig,
    transformer_apply,
)


def decoder_spec(name: str, cfg: TransformerConfig, seq_len: int
                 ) -> ModelSpec:
    """A decoder's spec with the JAX package's one-shot apply: x (B,
    seq_len) float token ids, clipped to the vocab; each row's logits at
    its last non-zero position (0 if none), (B, vocab) f32. Id 0 after the
    first token counts as padding, matching the engine's zero-padding."""

    def apply(params, x, dtype=torch.bfloat16):
        tokens = torch.clamp(x, 0, cfg.vocab - 1).to(torch.int32)
        positions = torch.arange(seq_len, device=x.device)[None, :]
        last = torch.where(tokens > 0, positions, 0).amax(dim=1)
        return transformer_apply(params, tokens, cfg, dtype=dtype,
                                 head_rows=last)

    return ModelSpec(name, cfg, apply=apply, input_shape=(seq_len,),
                     output_shape=(cfg.vocab,))


def _gpt2(name, vocab, n_layers, d_model, n_heads, d_ff, max_seq, seq_len):
    return decoder_spec(name, TransformerConfig(
        vocab=vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        d_ff=d_ff, max_seq=max_seq, causal=True), seq_len)


@register("gpt2")
def make_gpt2(seq_len: int = 128, vocab: int = 50257, n_layers: int = 12,
              d_model: int = 768, n_heads: int = 12, d_ff: int = 3072,
              max_seq: int = 1024):
    return _gpt2("gpt2", vocab, n_layers, d_model, n_heads, d_ff, max_seq,
                 seq_len)


@register("distilgpt2")
def make_distilgpt2(seq_len: int = 128, vocab: int = 50257, n_layers: int = 6,
                    d_model: int = 768, n_heads: int = 12, d_ff: int = 3072,
                    max_seq: int = 1024):
    return _gpt2("distilgpt2", vocab, n_layers, d_model, n_heads, d_ff,
                 max_seq, seq_len)


@register("gpt2-small-test")
def make_gpt2_small(seq_len: int = 16, vocab: int = 256, n_layers: int = 2,
                    d_model: int = 64, n_heads: int = 4, d_ff: int = 128,
                    max_seq: int = 64):
    return _gpt2("gpt2-small-test", vocab, n_layers, d_model, n_heads, d_ff,
                 max_seq, seq_len)


@register("gpt2-chaos-test")
def make_gpt2_chaos(seq_len: int = 16, vocab: int = 1024, n_layers: int = 4,
                    d_model: int = 256, n_heads: int = 8, d_ff: int = 1024,
                    max_seq: int = 128):
    return _gpt2("gpt2-chaos-test", vocab, n_layers, d_model, n_heads, d_ff,
                 max_seq, seq_len)


@register("gpt2-moe")
def make_gpt2_moe(seq_len: int = 128, vocab: int = 50257, n_layers: int = 12,
                  d_model: int = 768, n_heads: int = 12, d_ff: int = 3072,
                  max_seq: int = 1024, n_experts: int = 8, top_k: int = 2,
                  capacity_factor: float = 1.25):
    """GPT-2 with a mixture-of-experts FFN in every block (``ops.moe``);
    the same /infer and /generate contracts as gpt2."""
    return decoder_spec("gpt2-moe", TransformerConfig(
        vocab=vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        d_ff=d_ff, max_seq=max_seq, causal=True, n_experts=n_experts,
        moe_top_k=top_k, moe_capacity_factor=capacity_factor), seq_len)


@register("gpt2-moe-test")
def make_gpt2_moe_test(seq_len: int = 16, vocab: int = 256, n_layers: int = 2,
                       d_model: int = 64, n_heads: int = 4, d_ff: int = 128,
                       max_seq: int = 64, n_experts: int = 4):
    """Tiny MoE config; capacity factor 4, so it drops no token."""
    return decoder_spec("gpt2-moe-test", TransformerConfig(
        vocab=vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        d_ff=d_ff, max_seq=max_seq, causal=True, n_experts=n_experts,
        moe_capacity_factor=4.0), seq_len)
