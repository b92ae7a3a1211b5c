"""Functional NN building blocks over parameter dicts (counterpart of
``tpu_engine/ops/nn.py``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``{"kernel": (in, out), "bias": (out,)}``), so converted weights
drop in unchanged. The rounding points follow the JAX functions exactly:

- ``dense`` casts its input and kernel to the compute dtype, accumulates
  in f32 and returns **f32** plus the (f32) bias;
- ``rmsnorm`` computes in f32;
- ``layernorm`` computes in its input's dtype and is promoted to f32 by
  the f32 scale and bias.
"""

from __future__ import annotations

from typing import Optional

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


def dense(params, x: torch.Tensor, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """x @ kernel + bias with f32 accumulation and an f32 result.

    In f32 this is a plain matmul. In a narrower compute dtype the product
    is ``MatmulF32Out``, so the result is not rounded to the compute dtype
    before the bias add, as in the JAX function, and its gradient is the
    JAX function's."""
    kernel = params["kernel"]
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32:
        y = x2 @ kernel
    elif torch.is_grad_enabled() and (x2.requires_grad
                                      or kernel.requires_grad):
        y = MatmulF32Out.apply(x2, kernel)
    else:
        y = _mm_f32_out(x2, kernel)
    return (y + params["bias"]).reshape(*lead, kernel.shape[-1])


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
