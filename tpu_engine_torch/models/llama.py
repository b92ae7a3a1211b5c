"""Llama family configs (counterpart of ``tpu_engine/models/llama.py``;
same names and values): RMSNorm, rotary positions, SwiGLU, grouped-query
attention. ``llama`` is the TinyLlama-1.1B geometry. The mistral configs
(sliding window) serve on the dense lane, whose prefill band-masks through
the flash kernel and whose decode band-masks the dense cache; the paged
lanes refuse them."""

from __future__ import annotations

from tpu_engine_torch.models.gpt2 import decoder_spec
from tpu_engine_torch.models.registry import register
from tpu_engine_torch.models.transformer import TransformerConfig


def _llama(name, seq_len, vocab, n_layers, d_model, n_heads, n_kv_heads,
           d_ff, max_seq, rope_theta=10000.0, ln_eps=1e-5,
           sliding_window=None):
    return decoder_spec(name, TransformerConfig(
        vocab=vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        d_ff=d_ff, max_seq=max_seq, causal=True,
        norm="rmsnorm", pos="rope", mlp_act="swiglu",
        n_kv_heads=n_kv_heads, rope_theta=rope_theta, ln_eps=ln_eps,
        sliding_window=sliding_window), seq_len)


@register("llama")
def make_llama(seq_len: int = 128, vocab: int = 32000, n_layers: int = 22,
               d_model: int = 2048, n_heads: int = 32, n_kv_heads: int = 4,
               d_ff: int = 5632, max_seq: int = 2048,
               rope_theta: float = 10000.0, ln_eps: float = 1e-5):
    return _llama("llama", seq_len, vocab, n_layers, d_model, n_heads,
                  n_kv_heads, d_ff, max_seq, rope_theta, ln_eps)


@register("mistral")
def make_mistral(seq_len: int = 128, vocab: int = 32000, n_layers: int = 32,
                 d_model: int = 4096, n_heads: int = 32, n_kv_heads: int = 8,
                 d_ff: int = 14336, max_seq: int = 4096,
                 rope_theta: float = 10000.0, ln_eps: float = 1e-5,
                 sliding_window: int = 4096):
    return _llama("mistral", seq_len, vocab, n_layers, d_model, n_heads,
                  n_kv_heads, d_ff, max_seq, rope_theta, ln_eps,
                  sliding_window)


@register("mistral-small-test")
def make_mistral_small(seq_len: int = 16, vocab: int = 256,
                       n_layers: int = 2, d_model: int = 64,
                       n_heads: int = 4, n_kv_heads: int = 2,
                       d_ff: int = 128, max_seq: int = 64,
                       sliding_window: int = 8):
    return _llama("mistral-small-test", seq_len, vocab, n_layers, d_model,
                  n_heads, n_kv_heads, d_ff, max_seq,
                  sliding_window=sliding_window)


@register("llama-small-test")
def make_llama_small(seq_len: int = 16, vocab: int = 256, n_layers: int = 2,
                     d_model: int = 64, n_heads: int = 4, n_kv_heads: int = 2,
                     d_ff: int = 128, max_seq: int = 64):
    return _llama("llama-small-test", seq_len, vocab, n_layers, d_model,
                  n_heads, n_kv_heads, d_ff, max_seq)
