"""Transformer forward for the paged mixed step (counterpart of
``tpu_engine/models/transformer.py``).

Parameters are a dict tree with the JAX package's names, except that the
stacked (L, ...) ``blocks`` tree becomes a list of per-layer dicts: the
``lax.scan`` over layers is a Python loop here. Matmul kernels may be
stored in the compute dtype (``models.convert`` does so); ``nn.dense``
casts them at use, so a stored cast and an apply-time cast round alike.
Embedding tables, biases and norm scales stay f32, as in JAX.

The rounding points follow the JAX forward: the residual adds promote to
f32 (``nn.dense`` returns f32) and the carry is cast back to the compute
dtype only at each block's end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from tpu_engine_torch.ops import nn
from tpu_engine_torch.ops.attention import _split_heads, rope


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The port's copy of ``tpu_engine.models.transformer.TransformerConfig``
    (same fields and defaults; that module imports jax)."""
    vocab: int = 50257
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    causal: bool = True
    post_ln: bool = False
    embed_ln: bool = False
    type_vocab: int = 0
    gelu_tanh: bool = True
    ln_eps: float = 1e-5
    norm: str = "layernorm"     # "layernorm" | "rmsnorm"
    pos: str = "learned"        # "learned" | "rope"
    mlp_act: str = "gelu"       # "gelu" | "swiglu"
    n_kv_heads: Optional[int] = None
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


class KVCache(NamedTuple):
    """A K/V pair of pool tensors, each (L, NB, bs, H_kv, D)."""
    k: torch.Tensor
    v: torch.Tensor


def _norm(params, x, cfg: TransformerConfig):
    return (nn.rmsnorm(params, x, eps=cfg.ln_eps) if cfg.norm == "rmsnorm"
            else nn.layernorm(params, x, eps=cfg.ln_eps))


def _mlp(params, h, dtype, cfg: TransformerConfig):
    if cfg.mlp_act == "swiglu":
        gate = nn.silu(nn.dense(params["gate"], h, dtype=dtype))
        return nn.dense(params["proj"],
                        gate * nn.dense(params["up"], h, dtype=dtype),
                        dtype=dtype)
    h = nn.dense(params["fc"], h, dtype=dtype)
    h = nn.gelu(h, approximate=cfg.gelu_tanh)
    return nn.dense(params["proj"], h, dtype=dtype)


def _project_qkv(bp, x, cfg: TransformerConfig, *, dtype, positions):
    q = _split_heads(nn.dense(bp["attn"]["wq"], x, dtype=dtype), cfg.n_heads)
    k = _split_heads(nn.dense(bp["attn"]["wk"], x, dtype=dtype),
                     cfg.kv_heads)
    v = _split_heads(nn.dense(bp["attn"]["wv"], x, dtype=dtype),
                     cfg.kv_heads)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_step_rows_ragged(bp, h, ck, cv, tables, pos0, qlen,
                            cfg: TransformerConfig, *, dtype, attn_fn):
    """One layer of the ragged mixed step. ck/cv are this layer's
    (NB, bs, H_kv, D) pool slices, updated IN PLACE: all W slots' K/V are
    written into the rows' blocks before the attention read
    (write-before-attend); padding slots (i >= qlen) write into the null
    block 0, and columns past the table are clipped to its last column."""
    bs = ck.shape[1]
    b, w = h.shape[:2]
    x = _norm(bp["ln1"], h, cfg)
    offs = torch.arange(w, device=h.device)[None, :]
    logical = pos0[:, None].long() + offs                      # (B, W)
    q, k, v = _project_qkv(bp, x, cfg, dtype=dtype, positions=logical)
    rows = torch.arange(b, device=h.device)[:, None]
    max_col = tables.shape[1] * bs - 1
    cols = torch.clamp(logical, max=max_col)
    blk = tables.long()[rows, cols // bs]
    blk = torch.where(offs < qlen[:, None].long(), blk, 0)
    off = cols % bs
    ck.index_put_((blk, off), k.to(ck.dtype))
    cv.index_put_((blk, off), v.to(cv.dtype))
    a = attn_fn(q, ck, cv, tables, pos0, qlen).to(dtype)
    h = h + nn.dense(bp["attn"]["wo"], a.reshape(b, w, -1), dtype=dtype)
    h = h + _mlp(bp["mlp"], _norm(bp["ln2"], h, cfg), dtype, cfg)
    return h.to(dtype)


def transformer_step_rows_ragged(params, tokens, caches: KVCache, tables,
                                 pos0, qlen, cfg: TransformerConfig, *,
                                 dtype=torch.bfloat16, attn_fn=None,
                                 sample_slot=None, sample_width: int = 1,
                                 scales=None):
    """The mixed prefill+decode primitive: one ragged batch where row b
    consumes qlen[b] >= 0 new tokens at logical columns
    [pos0[b], pos0[b] + qlen[b]), writing their K/V into the row's pool
    blocks in the same call.

    tokens: (B, W) int, right-aligned at slot 0; caches: KVCache of
    (L, NB, bs, H_kv, D) pools (updated in place and returned); tables:
    (B, nb) int32 block tables; pos0, qlen: (B,) int32. ``attn_fn``
    defaults to ``ops.paged_attention.ragged_paged_attention`` (the CUDA
    kernel on CUDA tensors).

    ``sample_slot`` (B,) selects one slot per row to project through the
    LM head; the hidden state is gathered BEFORE ln_f and the head, so the
    head multiplies (B, d) and not (B*W, d). ``sample_width`` > 1 widens
    the gather to slots sample_slot..sample_slot + width - 1 (clipped to
    W-1). Returns (logits (B, vocab), caches), or (B, sample_width, vocab)
    when sample_width > 1, or (B, W, vocab) without ``sample_slot``."""
    if scales is not None:
        raise NotImplementedError(
            "the int8 KV pool (scales) is not yet ported")
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding_window models are not supported by the paged KV "
            "cache (use the dense scheduler)")
    if cfg.n_experts > 0 or cfg.post_ln or cfg.embed_ln or cfg.type_vocab:
        raise NotImplementedError(
            "only the decoder dialects (gpt2, llama) are ported")
    if attn_fn is None:
        from tpu_engine_torch.ops.paged_attention import (
            ragged_paged_attention,
        )

        attn_fn = ragged_paged_attention
    b, w = tokens.shape
    tokens = tokens.long()
    h = nn.embedding(params["tok_embed"], tokens)
    if cfg.pos == "learned":
        table = params["pos_embed"]["table"]
        logical = torch.clamp(
            pos0[:, None].long() + torch.arange(w, device=tokens.device),
            0, table.shape[0] - 1)
        h = h + table[logical]
    h = h.to(dtype)
    for li, bp in enumerate(params["blocks"]):
        h = _block_step_rows_ragged(bp, h, caches.k[li], caches.v[li],
                                    tables, pos0, qlen, cfg, dtype=dtype,
                                    attn_fn=attn_fn)
    if sample_slot is not None:
        slots = torch.clamp(
            sample_slot[:, None].long()
            + torch.arange(sample_width, device=h.device)[None, :],
            max=w - 1)
        h = h[torch.arange(b, device=h.device)[:, None], slots]  # (B, S, d)
    h = _norm(params["ln_f"], h, cfg)
    logits = nn.dense(params["head"], h, dtype=dtype).float()
    if sample_slot is not None and sample_width == 1:
        logits = logits[:, 0]
    return logits, caches
