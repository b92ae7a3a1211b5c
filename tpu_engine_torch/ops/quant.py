"""Weight-only int8 quantization and KV-cache payload quantization
(counterpart of ``tpu_engine/ops/quant.py``).

**Weights.** Dense and conv kernels are stored int8 with one f32 scale
per output channel, applied to the product's OUTPUT, which is exact:

    X @ (Wq * s_j)  ==  (X @ Wq) * s_j      (s_j per output column)

so the error comes only from the int8 rounding of W. ``quantize_kernel``
rounds exactly as the JAX function does: scale ``amax / 127`` in f32 (1
for an all-zero channel), ``round(kernel / scale)`` half to even, clipped
to [-127, 127]; on the same f32 kernel its bytes and scales equal JAX's.
Quantize f32 kernels: a kernel already rounded to bf16 gives other
bytes and scales. The port's layouts: dense kernels (in, out) and MoE
expert stacks (E, in, out) reduce over ``in``; conv kernels are OIHW
(``models.convert``), so their scale reduces over I, kh and kw.
``quantize_params`` rewrites a parameter tree as JAX's does; the
transformer's per-layer ``blocks`` list stands for JAX's stacked blocks
tree, and every other list (yolo's C2f bottlenecks and head branches)
passes through unquantized, as JAX's dict-only recursion leaves it.

**KV.** One symmetric int8 vector and one f32 scale per leading index:
the head_dim axis reduces, so in the block pool that is one scale per
(layer, block slot, kv-head) and a decode append quantizes only its own
vector. ``quantize_kv`` divides by the scale (multiplying by its
reciprocal would round some values to other int8 bytes than JAX's) and
rounds half to even, like ``jnp.round``: its bytes equal the JAX
function's on the same f32 input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_engine_torch.training.train import tree_leaves


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, correctly rounded on every device: on the GPU, torch
    divides by a Python scalar as a product with its rounded reciprocal,
    which gives some scales one ulp off the CPU's and JAX's."""
    return amax / torch.full_like(amax, 127.0)


def quantize_kv(x: torch.Tensor):
    """x (..., D) -> (int8 (..., D), f32 scale (...)): scale amax/127 per
    vector (1.0 for an all-zero vector), values rounded and clipped to
    [-127, 127]."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, _div127(amax), torch.ones_like(amax))
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 * f32 scale in f32 (exact), then
    cast to ``dtype``."""
    return (q.float() * scale.float()[..., None]).to(dtype)


# -- weights --------------------------------------------------------------------

def _is_dense_kernel(kernel) -> bool:
    return kernel.dim() in (2, 3)  # (in, out) or stacked (E, in, out)


def _is_conv_kernel(kernel) -> bool:
    return kernel.dim() in (4, 5)  # OIHW or stacked (L, O, I, kh, kw)


def _reduce_axes(kernel, kind: Optional[str]) -> Tuple[int, ...]:
    if kind == "dense" or (kind is None and _is_dense_kernel(kernel)):
        return (kernel.dim() - 2,)
    if kind == "conv" or (kind is None and _is_conv_kernel(kernel)):
        return tuple(range(kernel.dim() - 3, kernel.dim()))
    raise ValueError(f"unsupported kernel rank {kernel.dim()}")


def _expand(scale: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    for a in axes:
        scale = scale.unsqueeze(a)
    return scale


def quantize_kernel(kernel: torch.Tensor, kind: Optional[str] = None):
    """kernel -> (int8 kernel_q, f32 per-output-channel scale), computed in
    f32. The scale reduces over the input axis (dense) or I, kh, kw (an
    OIHW conv), keeping leading stacked axes; ``kind`` ("dense" or
    "conv") overrides the rank rule, as for MoE expert stacks."""
    kernel = kernel.detach().float()
    axes = _reduce_axes(kernel, kind)
    amax = kernel.abs().amax(dim=axes)
    scale = torch.where(amax > 0, _div127(amax), torch.ones_like(amax))
    q = torch.round(kernel / _expand(scale, axes))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    if kernel.dim() == 4 and kernel.is_contiguous(
            memory_format=torch.channels_last):
        q = q.contiguous(memory_format=torch.channels_last)
    return q, scale


def dequantize_kernel(kernel_q: torch.Tensor, scale: torch.Tensor,
                      kind: Optional[str] = None) -> torch.Tensor:
    """kernel_q * scale in f32 (exact), by the same axis rule."""
    axes = _reduce_axes(kernel_q, kind)
    return kernel_q.float() * _expand(scale.float(), axes)


def is_quantized(params) -> bool:
    return isinstance(params, dict) and "kernel_q" in params


def tree_is_quantized(params) -> bool:
    """True when any subtree carries weight-quantized kernels."""
    if isinstance(params, (list, tuple)):
        return any(tree_is_quantized(v) for v in params)
    if not isinstance(params, dict):
        return False
    if "kernel_q" in params or "wi_q" in params:
        return True
    return any(tree_is_quantized(v) for v in params.values())


def _map_tree(fn, params):
    """fn over the values of a dict; a ``blocks`` list (the per-layer
    split of JAX's stacked tree) element by element; other lists and
    leaves unchanged."""
    return {k: ([fn(b) for b in v] if k == "blocks" and isinstance(v, list)
                else fn(v))
            for k, v in params.items()}


def quantize_params(params):
    """Tree transform: every dict holding a dense or conv ``kernel``
    becomes ``{"kernel_q": int8, "kernel_scale": f32, ...rest}``; dicts
    without one (norms, embeddings) pass through; already quantized dicts
    are kept (idempotent). An MoE FFN dict (``{"gate", "wi", "wo"}``,
    ``ops.moe``) quantizes its expert stacks to ``wi_q``/``wi_scale`` and
    ``wo_q``/``wo_scale`` and keeps the router ``gate`` in full
    precision: top-k routing is discontinuous, and a perturbed router
    sends boundary tokens to other experts."""
    if not isinstance(params, dict):
        return params
    if "kernel_q" in params or "wi_q" in params:
        return params
    if "gate" in params and "wi" in params and "wo" in params:
        out = {k: v for k, v in params.items() if k not in ("wi", "wo")}
        out["wi_q"], out["wi_scale"] = quantize_kernel(params["wi"], "dense")
        out["wo_q"], out["wo_scale"] = quantize_kernel(params["wo"], "dense")
        return out
    kernel = params.get("kernel")
    if torch.is_tensor(kernel) and (_is_dense_kernel(kernel)
                                    or _is_conv_kernel(kernel)):
        out = {k: v for k, v in params.items() if k != "kernel"}
        out["kernel_q"], out["kernel_scale"] = quantize_kernel(kernel)
        return out
    return _map_tree(quantize_params, params)


def dequantize_params(params):
    """Inverse transform: f32 kernels and expert stacks."""
    if not isinstance(params, dict):
        return params
    if "kernel_q" in params:
        out = {k: v for k, v in params.items()
               if k not in ("kernel_q", "kernel_scale")}
        out["kernel"] = dequantize_kernel(params["kernel_q"],
                                          params["kernel_scale"])
        if out["kernel"].dim() == 4 and params["kernel_q"].is_contiguous(
                memory_format=torch.channels_last):
            out["kernel"] = out["kernel"].contiguous(
                memory_format=torch.channels_last)
        return out
    if "wi_q" in params:
        out = {k: v for k, v in params.items()
               if k not in ("wi_q", "wi_scale", "wo_q", "wo_scale")}
        for name in ("wi", "wo"):
            out[name] = dequantize_kernel(params[f"{name}_q"],
                                          params[f"{name}_scale"], "dense")
        return out
    return _map_tree(dequantize_params, params)


def param_bytes(params) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in tree_leaves(params)))
