"""Flash attention, forward and backward (counterpart of
``tpu_engine/ops/flash.py``): the prompt pass of the dense scheduler
(``transformer_prefill``) and the full-sequence forward
(``transformer_apply``), whose gradient trains the model.

- ``flash_attention(q, k, v, *, causal, mask, window)`` has the contract
  of the JAX function: q (B, Sq, H, D), k and v (B, Sk, H, D) with equal
  head counts (callers expand grouped K/V with ``repeat_kv``), mask
  (B, Sk) int with 1 = valid, ``window`` (a sliding band of the last
  ``window`` keys) only with ``causal``. It returns the attention output
  in v's dtype; a query row with no valid key gives 0. When grad mode is
  on and q, k or v requires grad, it goes through ``FlashAttention``, the
  counterpart of the JAX ``custom_vjp``: the forward saves q, k, v, the
  mask, out and lse, and the backward returns dq, dk and dv. Otherwise it
  is one forward call.
- ``flash_attention_fwd`` returns ``(out, lse)``: ``lse`` (B, H, Sq) f32
  is the logsumexp of the masked, scaled scores, -inf on fully masked
  rows, as ``_flash_kernel`` writes it for its backward pass.
  ``out_dtype=torch.float32`` over bf16 inputs writes out unrounded in
  f32 (the ring's hops, which ``parallel.ring`` merges in f32 by their
  lse, so the merged output rounds once, as one call's does).
- ``flash_attention_bwd(q, k, v, mask, out, lse, do, *, causal, window)``
  returns ``(dq, dk, dv)`` in the inputs' dtypes. It computes
  delta = sum_d do * out (B, H, Sq) in f32 as a torch reduction (the JAX
  package computes it in XLA, outside its kernels), then calls
  ``flash_attention_bwd_dq`` (the port of ``_bwd_dq_kernel``) and
  ``flash_attention_bwd_dkv`` (the port of ``_bwd_dkv_kernel``), which
  recompute the probabilities from lse.

Each kernel has a plain PyTorch version (``*_reference``) with the TPU
kernel's rounding points: scores and products of the input values summed
in f32, f32 softmax; the forward rounds its weights to v's dtype before the
PV product, the backward rounds p to do's dtype before the dv product and
ds to k's (dq) or q's (dk) dtype before its product.
``flash_attention_bwd_reference`` is the whole backward in plain PyTorch.
For CUDA tensors the wrappers launch the hand-written kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), which pick
their own tiles (the TPU tiling arguments ``block_q``, ``block_k`` and
``interpret`` are not carried over); for CPU tensors, and only for them,
they take the plain versions. Nothing falls back: a kernel that does not
build or launch raises. Each kernel's wrapper counts its launches
(``launches``) and plain calls (``plain_calls``).

Every kernel owns one 64-row output tile per thread block and sweeps the
other axis, so its results are bit-identical from run to run. In bf16 the
kernels multiply on the tensor cores (``mma.sync``, bf16 tiles
double-buffered by 16-byte ``cp.async`` copies, p and ds kept in
registers); in f32 on the CUDA cores, register-tiled (TF32 stays off). The
copies need every (b, s, h) row of q, k, v and do 16-byte aligned: the
wrappers pass such tensors as they are, strided views included, and copy
any other to a contiguous tensor first (the same kernel then runs; the
copy is not the plain version and is counted nowhere).
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


def _keep(q, sk: int, causal: bool, mask, window):
    """(B or 1, 1, Sq, Sk) bool: the (query, key) pairs attended."""
    sq = q.shape[1]
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
    return keep


def flash_attention_reference(q, k, v, *, causal: bool = False, mask=None,
                              window: Optional[int] = None, out_dtype=None):
    """Plain version: (out (B, Sq, H, D) in ``out_dtype``, default v's
    dtype, lse (B, H, Sq) f32). Query i attends key j when j <= i
    (``causal``), j > i - window (``window``) and mask[b, j] > 0
    (``mask``)."""
    _check_shapes(q, k, v, mask, causal, window)
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    s = torch.where(_keep(q, k.shape[1], causal, mask, window), s, neg_inf)
    m = s.amax(-1, keepdim=True)
    safe_m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe.transpose(1, 2)[..., None]).to(out_dtype or v.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l_safe), neg_inf)
    return out, lse


def bwd_delta(do, out):
    """delta = sum_d do * out in f32, (B, H, Sq): the backward kernels'
    per-row correction (``_flash_bwd_call``'s Δ)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _p_ds(q, k, v, mask, lse, delta, do, causal, window):
    """The plain backward's f32 (B, H, Sq, Sk) p, recomputed from lse as
    ``_recompute_p`` does (0 on pairs not attended and on rows whose lse is
    -inf), and ds = p * (do . v^T - delta)."""
    _check_shapes(q, k, v, mask, causal, window)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.where(_keep(q, k.shape[1], causal, mask, window), s,
                    float("-inf"))
    lse_safe = torch.where(torch.isneginf(lse), 0.0, lse)
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_reference(q, k, v, mask, lse, delta, do, *,
                                     causal: bool = False,
                                     window: Optional[int] = None):
    """Plain version of ``_bwd_dq_kernel``: dq = round(ds) . k * scale,
    summed in f32, in q's dtype."""
    _, ds = _p_ds(q, k, v, mask, lse, delta, do, causal, window)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, mask, lse, delta, do, *,
                                      causal: bool = False,
                                      window: Optional[int] = None):
    """Plain version of ``_bwd_dkv_kernel``: (dk, dv) with
    dv = round(p)^T . do and dk = round(ds)^T . q * scale, summed in f32,
    in k's and v's dtypes."""
    p, ds = _p_ds(q, k, v, mask, lse, delta, do, causal, window)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dk = dk * (1.0 / math.sqrt(q.shape[-1]))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, mask, out, lse, do, *,
                                  causal: bool = False,
                                  window: Optional[int] = None):
    """The whole backward in plain PyTorch: (dq, dk, dv) of the attention
    output ``out`` (with its ``lse``) against the output gradient ``do``."""
    args = (q, k, v, mask, lse, bwd_delta(do, out), do)
    dq = flash_attention_bwd_dq_reference(*args, causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkv_reference(*args, causal=causal,
                                               window=window)
    return dq, dk, dv


def _rows_aligned(t) -> bool:
    """Whether every (b, s, h) row of t starts 16 bytes aligned, with its
    head dim dense: what the kernels' 16-byte copies need."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * item % 16 == 0 for i in range(3)))


def _aligned(t):
    """t itself where its rows are 16-byte aligned, else a contiguous copy
    (the copy runs the same kernel; it is not the plain version)."""
    return t if _rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format)


def _check_cuda(q, k, v, mask, causal, window, **more) -> None:
    """Device, dtype and shape checks before a launch; ``more`` names
    further tensors that must lie on q's device."""
    _check_shapes(q, k, v, mask, causal, window)
    dev = q.device
    named = {"k": k, "v": v, **more}
    if mask is not None:
        named["mask"] = mask
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not "
                         f"supported (float32 or bfloat16, all alike)")
    b, sq, _, d = q.shape
    sk = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if sq == 0 or sk == 0:
        raise ValueError(f"empty sequence (Sq {sq}, Sk {sk})")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _mask_arg(mask):
    return None if mask is None else mask.to(torch.int32).contiguous()


@counted
def flash_attention_fwd(q, k, v, *, causal: bool = False, mask=None,
                        window: Optional[int] = None, out_dtype=None):
    """(out, lse) with the contract of ``flash_attention_reference``. CUDA
    tensors launch the port of ``_flash_kernel``; CPU tensors take the
    plain version. ``out_dtype``: v's dtype (None), or float32 over bf16
    inputs."""
    if out_dtype not in (None, v.dtype) and not (
            out_dtype == torch.float32 and v.dtype == torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} over {v.dtype} inputs: "
                         f"the output is v's dtype, or float32 over "
                         f"bfloat16")
    if plain_or_cuda(flash_attention_fwd, q):
        return flash_attention_reference(q, k, v, causal=causal, mask=mask,
                                         window=window, out_dtype=out_dtype)
    _check_cuda(q, k, v, mask, causal, window)
    dev = q.device
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    m = _mask_arg(mask)
    out_dtype = out_dtype or v.dtype
    code = _DTYPES[q.dtype] + (out_dtype != v.dtype)  # 2: bf16 in, f32 out
    out = torch.empty((b, sq, h, d), dtype=out_dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    launch("flash_attention", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           None if m is None else m.data_ptr(), out.data_ptr(),
           lse.data_ptr(), b, sq, sk, h, d,
           q.stride(0), q.stride(1), q.stride(2),
           k.stride(0), k.stride(1), k.stride(2),
           v.stride(0), v.stride(1), v.stride(2),
           int(bool(causal)), 0 if window is None else int(window),
           1.0 / math.sqrt(d), code)
    flash_attention_fwd.launches += 1
    return out, lse


def _bwd_launch_args(q, k, v, mask, lse, delta, do, causal, window):
    """Checks, then (operands, the kernel's leading pointer arguments, its
    sizes, strides and flags) for a backward launch. The caller holds the
    operands until the launch is queued: a contiguous copy made here must
    not be freed, and its memory handed to an output, before that."""
    _check_cuda(q, k, v, mask, causal, window, lse=lse, delta=delta, do=do)
    b, sq, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} must match q "
                         f"{q.dtype} {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 (B, H, Sq) ="
                             f" {(b, h, sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    m = _mask_arg(mask)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if m is None else m.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    rest = (b, sq, k.shape[1], h, d,
            *(t.stride(i) for t in (q, k, v, do) for i in range(3)),
            int(bool(causal)), 0 if window is None else int(window),
            1.0 / math.sqrt(d), _DTYPES[q.dtype])
    return (q, k, v, do, m), ptrs, rest


@counted
def flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, *,
                           causal: bool = False,
                           window: Optional[int] = None):
    """dq with the contract of ``flash_attention_bwd_dq_reference``. CUDA
    tensors launch the port of ``_bwd_dq_kernel``; CPU tensors take the
    plain version."""
    if plain_or_cuda(flash_attention_bwd_dq, q):
        return flash_attention_bwd_dq_reference(
            q, k, v, mask, lse, delta, do, causal=causal, window=window)
    _held, ptrs, rest = _bwd_launch_args(q, k, v, mask, lse, delta, do,
                                         causal, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch("flash_attention_bwd_dq", q.device, *ptrs, dq.data_ptr(), *rest)
    flash_attention_bwd_dq.launches += 1
    return dq


@counted
def flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do, *,
                            causal: bool = False,
                            window: Optional[int] = None):
    """(dk, dv) with the contract of ``flash_attention_bwd_dkv_reference``.
    CUDA tensors launch the port of ``_bwd_dkv_kernel``; CPU tensors take
    the plain version."""
    if plain_or_cuda(flash_attention_bwd_dkv, q):
        return flash_attention_bwd_dkv_reference(
            q, k, v, mask, lse, delta, do, causal=causal, window=window)
    _held, ptrs, rest = _bwd_launch_args(q, k, v, mask, lse, delta, do,
                                         causal, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    launch("flash_attention_bwd_dkv", q.device, *ptrs, dk.data_ptr(),
           dv.data_ptr(), *rest)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, mask, out, lse, do, *, causal: bool = False,
                        window: Optional[int] = None):
    """(dq, dk, dv) with the contract of ``flash_attention_bwd_reference``:
    delta as a torch reduction, then the two backward kernels (CUDA
    tensors) or their plain versions (CPU tensors)."""
    delta = bwd_delta(do, out)
    args = (q, k, v, mask, lse, delta, do)
    dq = flash_attention_bwd_dq(*args, causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkv(*args, causal=causal, window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The flash forward and backward paired, as the JAX ``custom_vjp``
    pairs ``_flash_kernel`` with ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``: the forward saves q, k, v, the mask, out and lse
    and returns out; the backward recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, mask=mask,
                                       window=window)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse,
                                         do.to(q.dtype), causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, mask=None,
                    window: Optional[int] = None):
    """Drop-in for ``dot_product_attention`` over equal head counts. Under
    autograd (grad mode on, q, k or v requiring grad) it goes through
    ``FlashAttention``; otherwise it is the output of one
    ``flash_attention_fwd`` call (its counts count it)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, mask, bool(causal), window)
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
