"""GPT-2 family configs (counterpart of ``tpu_engine/models/gpt2.py``;
same names and values). The JAX factories' ``seq_len`` (the one-shot
/infer width) has no counterpart: the port has no /infer lane yet. The MoE
variants are not yet ported and refuse in ``models.registry``."""

from __future__ import annotations

from tpu_engine_torch.models.registry import ModelSpec, register
from tpu_engine_torch.models.transformer import TransformerConfig


def _gpt2(name, vocab, n_layers, d_model, n_heads, d_ff, max_seq):
    return ModelSpec(name, TransformerConfig(
        vocab=vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        d_ff=d_ff, max_seq=max_seq, causal=True))


@register("gpt2")
def make_gpt2(vocab: int = 50257, n_layers: int = 12, d_model: int = 768,
              n_heads: int = 12, d_ff: int = 3072, max_seq: int = 1024):
    return _gpt2("gpt2", vocab, n_layers, d_model, n_heads, d_ff, max_seq)


@register("distilgpt2")
def make_distilgpt2(vocab: int = 50257, n_layers: int = 6,
                    d_model: int = 768, n_heads: int = 12, d_ff: int = 3072,
                    max_seq: int = 1024):
    return _gpt2("distilgpt2", vocab, n_layers, d_model, n_heads, d_ff,
                 max_seq)


@register("gpt2-small-test")
def make_gpt2_small(vocab: int = 256, n_layers: int = 2, d_model: int = 64,
                    n_heads: int = 4, d_ff: int = 128, max_seq: int = 64):
    return _gpt2("gpt2-small-test", vocab, n_layers, d_model, n_heads, d_ff,
                 max_seq)


@register("gpt2-chaos-test")
def make_gpt2_chaos(vocab: int = 1024, n_layers: int = 4, d_model: int = 256,
                    n_heads: int = 8, d_ff: int = 1024, max_seq: int = 128):
    return _gpt2("gpt2-chaos-test", vocab, n_layers, d_model, n_heads, d_ff,
                 max_seq)
