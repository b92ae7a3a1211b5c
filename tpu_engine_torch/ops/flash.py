"""Flash attention forward (counterpart of ``tpu_engine/ops/flash.py``):
the prompt pass of the dense scheduler (``transformer_prefill``) and the
full-sequence forward (``transformer_apply``).

- ``flash_attention(q, k, v, *, causal, mask, window)`` has the contract
  of the JAX function: q (B, Sq, H, D), k and v (B, Sk, H, D) with equal
  head counts (callers expand grouped K/V with ``repeat_kv``), mask
  (B, Sk) int with 1 = valid, ``window`` (a sliding band of the last
  ``window`` keys) only with ``causal``. It returns the attention output
  in v's dtype; a query row with no valid key gives 0.
- ``flash_attention_fwd`` returns ``(out, lse)``: ``lse`` (B, H, Sq) f32
  is the logsumexp of the masked, scaled scores, -inf on fully masked
  rows, as ``_flash_kernel`` writes it for its backward pass.

``flash_attention_reference`` is the plain PyTorch version: scores of the
input values summed in f32, f32 softmax, weights rounded to v's dtype
before the PV product (the TPU kernel's rounding points). For CUDA tensors
the wrappers launch the hand-written port of ``_flash_kernel``
(``csrc/flash_attention.cu``), which picks its own tiles (the TPU tiling
arguments ``block_q``, ``block_k`` and ``interpret`` are not carried
over); for CPU tensors, and only for them, they take the plain version.
Nothing falls back: a kernel that does not build or launch raises. The
wrapper counts its launches (``launches``) and plain calls
(``plain_calls``); ``flash_attention`` is a view of the same counted call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tpu_engine_torch.ops.kernels import counted, launch, plain_or_cuda

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v, mask, causal: bool, window) -> None:
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (equal batch, heads and head dim;"
                         f" expand grouped K/V with repeat_kv)")
    if mask is not None and tuple(mask.shape) != (b, k.shape[1]):
        raise ValueError(f"mask must be (B, Sk) = ({b}, {k.shape[1]}), got "
                         f"{tuple(mask.shape)}")


def flash_attention_reference(q, k, v, *, causal: bool = False, mask=None,
                              window: Optional[int] = None):
    """Plain version: (out (B, Sq, H, D) in v's dtype, lse (B, H, Sq) f32).
    Query i attends key j when j <= i (``causal``), j > i - window
    (``window``) and mask[b, j] > 0 (``mask``)."""
    _check_shapes(q, k, v, mask, causal, window)
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    sq, sk = q.shape[1], k.shape[1]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
    keep = keep[None, None]
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    s = torch.where(keep, s, neg_inf)
    m = s.amax(-1, keepdim=True)
    safe_m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe.transpose(1, 2)[..., None]).to(v.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l_safe), neg_inf)
    return out, lse


def _operand(t):
    """The kernel reads (b, s, h) strides; the head dim must be dense."""
    return t if t.stride(-1) == 1 else t.contiguous()


@counted
def flash_attention_fwd(q, k, v, *, causal: bool = False, mask=None,
                        window: Optional[int] = None):
    """(out, lse) with the contract of ``flash_attention_reference``. CUDA
    tensors launch the port of ``_flash_kernel``; CPU tensors take the
    plain version."""
    if plain_or_cuda(flash_attention_fwd, q):
        return flash_attention_reference(q, k, v, causal=causal, mask=mask,
                                         window=window)
    _check_shapes(q, k, v, mask, causal, window)
    dev = q.device
    for name, t in (("k", k), ("v", v)) + ((("mask", mask),)
                                           if mask is not None else ()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not "
                         f"supported (float32 or bfloat16, all alike)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if sq == 0 or sk == 0:
        raise ValueError(f"empty sequence (Sq {sq}, Sk {sk})")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k, v = _operand(q), _operand(k), _operand(v)
    m = None if mask is None else mask.to(torch.int32).contiguous()
    out = torch.empty((b, sq, h, d), dtype=v.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    launch("flash_attention", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           None if m is None else m.data_ptr(), out.data_ptr(),
           lse.data_ptr(), b, sq, sk, h, d,
           q.stride(0), q.stride(1), q.stride(2),
           k.stride(0), k.stride(1), k.stride(2),
           v.stride(0), v.stride(1), v.stride(2),
           int(bool(causal)), 0 if window is None else int(window),
           1.0 / math.sqrt(d), _DTYPES[q.dtype])
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = False, mask=None,
                    window: Optional[int] = None):
    """Drop-in for ``dot_product_attention`` over equal head counts: the
    attention output of ``flash_attention_fwd`` (its counts count it)."""
    return flash_attention_fwd(q, k, v, causal=causal, mask=mask,
                               window=window)[0]


def parity_inputs(batch: int = 2, sq: int = 64, sk: Optional[int] = None,
                  n_heads: int = 4, d_head: int = 16, seed: int = 0):
    """Unit-normal (q, k, v) numpy f32 arrays at the JAX package's flash
    test shapes ((2, 64, 4, 16) by default)."""
    rng = np.random.default_rng(seed)
    sk = sk or sq
    q = rng.standard_normal((batch, sq, n_heads, d_head), np.float32)
    k = rng.standard_normal((batch, sk, n_heads, d_head), np.float32)
    v = rng.standard_normal((batch, sk, n_heads, d_head), np.float32)
    return q, k, v
