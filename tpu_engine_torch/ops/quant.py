"""KV-cache payload quantization (counterpart of ``quantize_kv`` and
``dequantize_kv`` in ``tpu_engine/ops/quant.py``; weight quantization is
not ported).

One symmetric int8 vector and one f32 scale per leading index: the
head_dim axis reduces, so in the block pool that is one scale per (layer,
block slot, kv-head) and a decode append quantizes only its own vector.
``quantize_kv`` divides by the scale (multiplying by its reciprocal would
round some values to other int8 bytes than JAX's) and rounds half to
even, like ``jnp.round``: its bytes equal the JAX function's on the same
f32 input.
"""

from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor):
    """x (..., D) -> (int8 (..., D), f32 scale (...)): scale amax/127 per
    vector (1.0 for an all-zero vector), values rounded and clipped to
    [-127, 127]."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 * f32 scale in f32 (exact), then
    cast to ``dtype``."""
    return (q.float() * scale.float()[..., None]).to(dtype)
