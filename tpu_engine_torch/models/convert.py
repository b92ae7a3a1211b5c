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
from typing import Optional

import numpy as np

import torch

from tpu_engine_torch.models.transformer import TransformerConfig
from tpu_engine_torch.ops.moe import moe_init
from tpu_engine_torch.training.train import (
    TrainState,
    adamw,
    tree_leaves,
    tree_map,
)
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype


# Matmul weights, stored in the compute dtype: dense and conv kernels and
# the MoE expert stacks. Their int8 forms keep int8; the rest is f32.
_KERNELS = ("kernel", "wi", "wo")
_INT8 = ("kernel_q", "wi_q", "wo_q")


def _to_tensor(name: str, arr, device, dtype):
    t = torch.from_numpy(np.array(arr)).to(device)
    if name in _INT8:
        dt = torch.int8
    elif name in _KERNELS:
        dt = dtype
    else:
        return t.to(torch.float32)
    if name in ("kernel", "kernel_q") and t.dim() == 4:
        # conv: HWIO -> OIHW, stored channels_last
        return t.permute(3, 2, 0, 1).to(dt).contiguous(
            memory_format=torch.channels_last)
    return t.to(dt)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: (_convert(v, device, dtype)
                    if isinstance(v, (dict, list, tuple))
                    else _to_tensor(k, v, device, dtype))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # yolo's C2f "m" and "head" lists
        return [_convert(v, device, dtype) for v in tree]
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def _layer(tree, li: int):
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def params_from_jax(tree, cfg: Optional[TransformerConfig] = None,
                    device=None, dtype="float32"):
    """The JAX package's param pytree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), to the port's tree on
    ``device`` (None = the CUDA card). A transformer's (``cfg``) stacked
    (L, ...) ``blocks`` leaves are split per layer; the encoder's
    ``type_embed``, ``embed_ln`` and QA ``head`` carry over as they are.
    The trees of the other models (mlp, resnets, yolo with its nested
    ``conv``/``bn`` dicts and its lists of C2f bottlenecks under ``"m"`` and
    of head branches) keep their names and nesting: dense kernels as they
    are, conv kernels from HWIO to OIHW (channels_last), both in
    ``dtype``; biases and batch-norm ``scale``, ``bias``, ``mean`` and
    ``var`` in f32. An MoE block's ``mlp`` (``{"gate": {"kernel"}, "wi"
    (L, E, d, f), "wo" (L, E, f, d)}``) splits per layer like the rest,
    its expert stacks in ``dtype``. Weight-quantized trees
    (``ops.quant``) carry across as they are: ``kernel_q``, ``wi_q`` and
    ``wo_q`` int8 (conv ``kernel_q`` to OIHW), their scales f32."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    out = _convert({k: v for k, v in tree.items() if k != "blocks"}, dev, dt)
    if cfg is None:
        return out
    out["blocks"] = [_convert(_layer(tree["blocks"], li), dev, dt)
                     for li in range(cfg.n_layers)]
    return out


def tp_params_from_jax(tree, spec, devices, dtype="float32"):
    """The JAX package's param pytree (numpy arrays) sharded for tensor-
    parallel serving over ``devices`` (one rank each): a
    ``models.transformer.TPParams`` of the per-rank trees that
    ``models.registry.tp_rank_trees`` cuts from ``params_from_jax``'s
    tree, each on its rank's device."""
    from tpu_engine_torch.models.registry import tp_rank_trees
    from tpu_engine_torch.models.transformer import TPParams
    from tpu_engine_torch.parallel.mesh import TPGroup

    group = TPGroup(devices)
    params = params_from_jax(tree, spec.config, group.home, dtype)
    return TPParams(tp_rank_trees(spec, params, group.devices), group)


def ssd_params_from_jax(tree, cfg, device=None):
    """The JAX package's ``ssd_init`` tree as numpy arrays to the port's
    recurrent-decoder tree on ``device``: the stacked (L, ...) ``blocks``
    split per layer (``in_proj``/``out_proj`` as ``{"kernel", "bias"}``,
    ``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``, the norms), and
    every leaf f32, as the mixer computes (``cfg``: an ``SSDConfig``)."""
    return params_from_jax(tree, cfg, device, "float32")


def init_ssd_params(cfg, seed: int = 0, device=None):
    """Seeded random parameters at full width, all f32, drawn on
    ``device``: ``ssd_init``'s distributions (embedding N(0, 0.02²),
    He-normal projections and head, conv_w N(0, 1/d_conv), A_log =
    log(1..H), dt_bias N(0, 0.01), D and norm scales ones, zero biases)
    and tree; the numbers are not JAX's."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    f32 = torch.float32
    di, N, H = cfg.d_inner, cfg.d_state, cfg.n_heads

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=dev, dtype=f32) * std

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), math.sqrt(2.0 / n_in)),
                "bias": torch.zeros((n_out,), dtype=f32, device=dev)}

    def ones(n):
        return {"scale": torch.ones((n,), dtype=f32, device=dev)}

    blocks = [{
        "ln": ones(cfg.d_model),
        "in_proj": dense(cfg.d_model, 2 * di + 2 * N + H),
        "conv_w": normal((cfg.d_conv, di), 1.0 / math.sqrt(cfg.d_conv)),
        "conv_b": torch.zeros((di,), dtype=f32, device=dev),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=dev)),
        "dt_bias": normal((H,), 0.1),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "gate_norm": ones(di),
        "out_proj": dense(di, cfg.d_model),
    } for _ in range(cfg.n_layers)]
    return {"tok_embed": {"table": normal((cfg.vocab, cfg.d_model), 0.02)},
            "blocks": blocks, "ln_f": ones(cfg.d_model),
            "head": dense(cfg.d_model, cfg.vocab)}


def params_to(params, device):
    """A parameter tree on ``device`` (same dtypes; leaves already there
    are not copied)."""
    return tree_map(lambda t: t.to(device), params)


def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                dtype="bfloat16"):
    """Seeded random parameters at full width, drawn on ``device``. The
    distributions are ``transformer_init``'s (embeddings N(0, 0.02²),
    attention projections N(0, 1/d_model), MLP and head He-normal, the
    MoE gate and expert stacks ``moe_init``'s, zero biases, unit norm
    scales), and so is the tree: no ``ln_f`` in post-LN
    dialects, ``embed_ln`` and ``type_embed`` where the config has them;
    the numbers are not JAX's."""
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
        if cfg.n_experts > 0:
            bp["mlp"] = moe_init(cfg.moe, g, dev, dt)
        elif cfg.mlp_act == "swiglu":
            bp["mlp"] = {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                         "proj": dense(cfg.d_ff, d)}
        else:
            bp["mlp"] = {"fc": dense(d, cfg.d_ff), "proj": dense(cfg.d_ff, d)}
        blocks.append(bp)
    params = {"tok_embed": {"table": normal((cfg.vocab, d), 0.02,
                                            torch.float32)},
              "blocks": blocks,
              "head": dense(d, cfg.vocab)}
    if cfg.pos == "learned":
        params["pos_embed"] = {"table": normal((cfg.max_seq, d), 0.02,
                                               torch.float32)}
    if not cfg.post_ln:
        params["ln_f"] = norm()
    if cfg.embed_ln:
        params["embed_ln"] = norm()
    if cfg.type_vocab > 0:
        params["type_embed"] = {"table": normal((cfg.type_vocab, d), 0.02,
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
