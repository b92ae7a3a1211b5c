"""Tiny MLP (counterpart of ``tpu_engine/models/mlp.py``; same name,
defaults and parameter tree): 16 -> 128 -> 16 with a ReLU between, the
fast model for tests and for the reference benchmark's 3-float inputs."""

from __future__ import annotations

import torch

from tpu_engine_torch.models.registry import ModelSpec, register
from tpu_engine_torch.ops import nn


def dense_init(g: torch.Generator, n_in: int, n_out: int, device, dtype):
    """He-normal kernel (in, out) in the compute dtype and a zero f32 bias
    (``nn.dense_init``'s distributions; the numbers are not JAX's)."""
    k = torch.randn((n_in, n_out), generator=g, device=device)
    return {"kernel": (k * (2.0 / n_in) ** 0.5).to(dtype),
            "bias": torch.zeros((n_out,), device=device)}


@register("mlp")
def make_mlp(input_dim: int = 16, hidden_dim: int = 128, output_dim: int = 16,
             num_layers: int = 2) -> ModelSpec:
    dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]

    def init(seed, device, dtype):
        from tpu_engine_torch.utils.device import resolve_device, resolve_dtype

        dev, dt = resolve_device(device), resolve_dtype(dtype)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        return {f"layer_{i}": dense_init(g, dims[i], dims[i + 1], dev, dt)
                for i in range(len(dims) - 1)}

    def apply(params, x, dtype=torch.bfloat16):
        h = x
        for i in range(len(dims) - 1):
            h = nn.dense(params[f"layer_{i}"], h, dtype=dtype)
            if i < len(dims) - 2:
                h = nn.relu(h)
        return h.float()

    return ModelSpec("mlp", apply=apply, init_fn=init,
                     input_shape=(input_dim,), output_shape=(output_dim,))
