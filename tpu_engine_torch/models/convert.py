"""Parameters for the port: carried across from the JAX package, or drawn
at random from a seed.

Both return the port's parameter tree: the JAX names, the stacked
``blocks`` tree split into a list of per-layer dicts, matmul kernels in
the compute dtype and everything else (embeddings, biases, norm scales)
in f32 — exactly the values the JAX forward uses after its apply-time
casts, so the two packages compute the same function.
"""

from __future__ import annotations

import math

import numpy as np

import torch

from tpu_engine_torch.models.transformer import TransformerConfig
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype


def _to_tensor(name: str, arr, device, dtype):
    t = torch.from_numpy(np.array(arr)).to(device)
    return t.to(dtype if name == "kernel" else torch.float32)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: (_convert(v, device, dtype) if isinstance(v, dict)
                    else _to_tensor(k, v, device, dtype))
                for k, v in tree.items()}
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def _layer(tree, li: int):
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def params_from_jax(tree, cfg: TransformerConfig, device="cpu",
                    dtype="float32"):
    """The JAX package's param pytree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), to the port's tree. The
    stacked (L, ...) ``blocks`` leaves are split per layer."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    out = {k: _convert(v, dev, dt) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = [_convert(_layer(tree["blocks"], li), dev, dt)
                     for li in range(cfg.n_layers)]
    return out


def params_to(params, device):
    """A copy of a parameter tree on ``device`` (same dtypes)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                dtype="bfloat16"):
    """Seeded random parameters at full width, drawn on ``device``. The
    distributions are ``transformer_init``'s (embeddings N(0, 0.02²),
    attention projections N(0, 1/d_model), MLP and head He-normal, zero
    biases, unit norm scales); the numbers are not JAX's."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))

    def normal(shape, std, out_dtype):
        t = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (t * std).to(out_dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def dense(n_in, n_out, std=None):
        std = math.sqrt(2.0 / n_in) if std is None else std
        return {"kernel": normal((n_in, n_out), std, dt), "bias": zeros(n_out)}

    def norm():
        out = {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                   device=dev)}
        if cfg.norm != "rmsnorm":
            out["bias"] = zeros(cfg.d_model)
        return out

    d, inner = cfg.d_model, cfg.n_heads * cfg.d_head
    kv_inner = cfg.kv_heads * cfg.d_head
    attn_std = 1.0 / math.sqrt(d)
    blocks = []
    for _ in range(cfg.n_layers):
        bp = {"ln1": norm(), "ln2": norm(),
              "attn": {"wq": dense(d, inner, attn_std),
                       "wk": dense(d, kv_inner, attn_std),
                       "wv": dense(d, kv_inner, attn_std),
                       "wo": dense(inner, d, attn_std)}}
        if cfg.mlp_act == "swiglu":
            bp["mlp"] = {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                         "proj": dense(cfg.d_ff, d)}
        else:
            bp["mlp"] = {"fc": dense(d, cfg.d_ff), "proj": dense(cfg.d_ff, d)}
        blocks.append(bp)
    params = {"tok_embed": {"table": normal((cfg.vocab, d), 0.02,
                                            torch.float32)},
              "blocks": blocks,
              "head": dense(d, cfg.vocab),
              "ln_f": norm()}
    if cfg.pos == "learned":
        params["pos_embed"] = {"table": normal((cfg.max_seq, d), 0.02,
                                               torch.float32)}
    return params
