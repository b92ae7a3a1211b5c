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
from tpu_engine_torch.training.train import (
    TrainState,
    adamw,
    tree_leaves,
    tree_map,
)
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


def params_from_jax(tree, cfg: TransformerConfig, device=None,
                    dtype="float32"):
    """The JAX package's param pytree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), to the port's tree on
    ``device`` (None = the CUDA card). The stacked (L, ...) ``blocks``
    leaves are split per layer."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    out = {k: _convert(v, dev, dt) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = [_convert(_layer(tree["blocks"], li), dev, dt)
                     for li in range(cfg.n_layers)]
    return out


def params_to(params, device):
    """A parameter tree on ``device`` (same dtypes; leaves already there
    are not copied)."""
    return tree_map(lambda t: t.to(device), params)


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


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def train_state_from_jax(state_np, cfg: TransformerConfig, device=None):
    """The JAX package's ``TrainState`` as numpy arrays
    (``jax.tree.map(np.asarray, state)``, or the dict of ``params``,
    ``opt_state`` and ``step`` its checkpoint holds) to the port's, on
    ``device`` (None = the CUDA card): the parameters through
    ``params_from_jax`` in f32, and optax.adamw's state
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())`` into
    the AdamW state of each leaf (``step`` = count, ``exp_avg`` = mu,
    ``exp_avg_sq`` = nu), so a run resumed in the port continues the JAX
    run. The optimizer is ``training.train.adamw()``, the counterpart of
    ``optax.adamw(1e-3)``: optax's state does not carry the learning rate
    (set ``opt_state.param_groups[0]["lr"]`` to continue at another)."""
    params = params_from_jax(_field(state_np, "params"), cfg, device,
                             "float32")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = adamw()(leaves)
    adam = _field(state_np, "opt_state")[0]
    count = int(np.asarray(_field(adam, "count")))
    moments = [tree_leaves(params_from_jax(_field(adam, name), cfg, device,
                                           "float32"))
               for name in ("mu", "nu")]
    for leaf, mu, nu in zip(leaves, *moments):
        opt.state[leaf] = {"step": torch.tensor(float(count)),
                           "exp_avg": mu, "exp_avg_sq": nu}
    return TrainState(params=params, opt_state=opt,
                      step=int(np.asarray(_field(state_np, "step"))))
