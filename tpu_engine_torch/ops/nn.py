"""Functional NN building blocks over parameter dicts (counterpart of
``tpu_engine/ops/nn.py``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``{"kernel": (in, out), "bias": (out,)}``), so converted weights
drop in unchanged. The rounding points follow the JAX functions exactly:

- ``dense`` casts its input and kernel to the compute dtype, accumulates
  in f32 and returns **f32** plus the (f32) bias;
- ``rmsnorm`` computes in f32;
- ``layernorm`` computes in its input's dtype and is promoted to f32 by
  the f32 scale and bias;
- ``conv2d`` casts its input and kernel to the compute dtype and returns
  **f32**; ``batchnorm``, the pools and the residual adds of a conv net
  run in f32 on that result.

Weight-only int8 trees (``ops.quant``: ``kernel_q`` and ``kernel_scale``
in place of ``kernel``) take JAX's branch in ``dense`` and ``conv2d``:
the int8 kernel goes to the compute dtype (x's dtype without one; int8
values are exact in bf16), the product sums in f32, and the
per-output-channel scale multiplies its result before the bias. The
int8 kernel is converted to a full copy at every call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _mm_f32_out(x2, kernel):
    if x2.is_cuda:
        return torch.mm(x2, kernel, out_dtype=torch.float32)
    return x2.float() @ kernel.float()


class MatmulF32Out(torch.autograd.Function):
    """x2 @ kernel of two narrow (bf16) matrices with an f32 result, the
    counterpart of ``dot_general(..., preferred_element_type=f32)``.

    Forward: on the GPU the product runs on the tensor cores with an f32
    output (``torch.mm(..., out_dtype=float32)``, which has no derivative
    of its own); on the CPU the same values are multiplied in f32, which is
    exact for bf16 inputs and sums in f32 likewise. Backward: JAX's
    transpose rule for that ``dot_general``: the f32 cotangent times the
    other operand in f32, rounded once to the operand's dtype (what
    autograd of the CPU forward gives)."""

    @staticmethod
    def forward(ctx, x2, kernel):
        ctx.save_for_backward(x2, kernel)
        return _mm_f32_out(x2, kernel)

    @staticmethod
    def backward(ctx, g):
        x2, kernel = ctx.saved_tensors
        gx = gk = None
        if ctx.needs_input_grad[0]:
            gx = (g @ kernel.float().t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gk = (x2.float().t() @ g).to(kernel.dtype)
        return gx, gk


def dense(params, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
          bias: bool = True) -> torch.Tensor:
    """x @ kernel + bias with f32 accumulation and an f32 result.
    ``bias=False`` leaves the bias out: a row-parallel rank's partial
    product, whose bias is added once, after the ranks' sum.

    In f32 this is a plain matmul. In a narrower compute dtype the product
    is ``MatmulF32Out``, so the result is not rounded to the compute dtype
    before the bias add, as in the JAX function, and its gradient is the
    JAX function's. A quantized kernel (``kernel_q``) scales the f32
    product by ``kernel_scale``; such trees serve and do not train."""
    quantized = "kernel_q" in params
    kernel = params["kernel_q"] if quantized else params["kernel"]
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
    elif quantized:
        kernel = kernel.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32:
        y = x2 @ kernel
    elif not quantized and torch.is_grad_enabled() and (
            x2.requires_grad or kernel.requires_grad):
        y = MatmulF32Out.apply(x2, kernel)
    else:
        y = _mm_f32_out(x2, kernel)
    if quantized:
        y = y * params["kernel_scale"]
    if bias:
        y = y + params["bias"]
    return y.reshape(*lead, kernel.shape[-1])


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (llama family), computed in f32."""
    x = x.float()
    ms = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * params["scale"]


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    default), False the erf form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def embedding(params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


# -- convolutional nets -------------------------------------------------------
#
# Activations are NCHW tensors, in torch.channels_last memory when the
# caller starts from NHWC data (``x.permute(0, 3, 1, 2)`` of an NHWC tensor
# is channels_last without a copy); conv kernels are OIHW (converted from
# the JAX package's HWIO once, in models.convert).


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: out = ceil(size / stride),
    total = max((out - 1) * stride + k - size, 0), lo = total // 2 and the
    rest at the high end. At stride 2 it is asymmetric (the 7x7/2 stem at
    224 pads (2, 3); a 3x3/2 at an even size (0, 1)), which torch's
    symmetric ``padding=k // 2`` is not."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int, padding):
    """((h_lo, h_hi), (w_lo, w_hi)) for "SAME" or an explicit pair."""
    if padding == "SAME":
        return (same_pads(x.shape[2], k, stride),
                same_pads(x.shape[3], k, stride))
    return tuple(tuple(p) for p in padding)


def conv2d(params, x: torch.Tensor, stride: int = 1, padding="SAME",
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """2-D convolution with an f32 result, the counterpart of
    ``conv_general_dilated(..., preferred_element_type=f32)``: x (B, C, H,
    W), ``params["kernel"]`` (O, I, kh, kw); ``padding`` "SAME" (XLA's,
    ``same_pads``) or ((h_lo, h_hi), (w_lo, w_hi)).

    x and the kernel are rounded to ``dtype`` and then convolved in f32,
    so a narrow dtype's products are exact and summed in f32, unrounded,
    as in JAX. On the GPU cuDNN runs that f32 convolution on the TF32
    tensor cores when ``torch.backends.cudnn.allow_tf32`` is on (its
    default), and TF32 holds every bf16 value, so the products stay exact;
    with it off the CUDA cores give the same values. A quantized kernel
    (``kernel_q``, OIHW int8) scales the result per output channel by
    ``kernel_scale``."""
    quantized = "kernel_q" in params
    kernel = params["kernel_q"] if quantized else params["kernel"]
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
    elif quantized:
        kernel = kernel.to(x.dtype)
    x, kernel = x.float(), kernel.float()
    (hlo, hhi), (wlo, whi) = _pads(x, kernel.shape[-1], stride, padding)
    if hlo == hhi and wlo == whi:
        y = F.conv2d(x, kernel, stride=stride, padding=(hlo, wlo))
    else:
        y = F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), kernel, stride=stride)
    if quantized:
        y = y * params["kernel_scale"][:, None, None]
    return y


def batchnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm with stored statistics over the channel
    axis (1), in f32 as the JAX function computes it."""
    inv = torch.rsqrt(params["var"] + eps) * params["scale"]
    shift = params["bias"] - params["mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding="SAME") -> torch.Tensor:
    """``reduce_window(max)`` over H and W: "SAME" (XLA's pads, filled with
    -inf) or ((h_lo, h_hi), (w_lo, w_hi))."""
    (hlo, hhi), (wlo, whi) = _pads(x, window, stride, padding)
    if hlo == hhi and wlo == whi:  # max_pool2d pads with -inf itself
        return F.max_pool2d(x, window, stride, padding=(hlo, wlo))
    x = F.pad(x, (wlo, whi, hlo, hhi), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C): the mean over H and W."""
    return x.mean(dim=(2, 3))
