"""Multi-head attention primitives (counterpart of
``tpu_engine/ops/attention.py``): grouped, unexpanded
``dot_product_attention`` with an int mask, rotary embeddings and the
head helpers. Layouts are the JAX package's: (B, S, H, D)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, inner = x.shape
    return x.reshape(b, s, n_heads, inner // n_heads)


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          base_pos: int = 0, window: Optional[int] = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, H_kv, D) with H_kv dividing H.

    Scores are taken in the inputs' dtype and softmaxed in f32; the
    weights are cast to v's dtype for the second product. H_kv < H is
    grouped-query attention computed against the un-expanded K/V.
    ``mask`` is (B, Sk) or (B, Sq, Sk), 1 = valid. A query row with no
    valid key gives 0 (the JAX function's nan_to_num)."""
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal")
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    grouped = h_kv != h
    # Mixed dtypes (f32 queries against a bf16 pool) promote, as jnp.einsum.
    qk_dtype = torch.promote_types(q.dtype, k.dtype)
    q, k = q.to(qk_dtype), k.to(qk_dtype)
    if grouped:
        g = h // h_kv
        qg = q.reshape(b, sq, h_kv, g, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    if causal:
        sk = k.shape[1]
        qpos = base_pos + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
        scores = torch.where(keep, scores, neg_inf)
    if mask is not None:
        if mask.dim() == 3:
            m = (mask[:, None, None, :, :] if grouped
                 else mask[:, None, :, :])
        else:
            m = mask.reshape(mask.shape[0], *([1] * (scores.dim() - 2)),
                             mask.shape[-1])
        scores = torch.where(m > 0, scores, neg_inf)
    weights = torch.softmax(scores, dim=-1)
    weights = torch.nan_to_num(weights)
    if grouped:
        out = torch.einsum("bhgqk,bkhd->bqhgd", weights.to(v.dtype), v)
        return out.reshape(b, sq, h, d)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, HF-llama rotate-half convention.
    x: (B, S, H, D); positions: (B, S) or (S,) logical positions. Angles
    in f32; the output is cast back to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) * 2.0 / d))
    pos = torch.clamp(torch.as_tensor(positions, device=x.device),
                      min=0).float()
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None] * inv                      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, H_kv, D) -> (B, S, H_kv*n_rep, D)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)
