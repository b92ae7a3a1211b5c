"""Model registry: name -> factory (counterpart of
``tpu_engine/models/registry.py``). The names, config values and shapes
are the JAX package's.

A ``ModelSpec`` carries what serving needs: the model's ``config`` (a
``TransformerConfig`` for the decoders, which the generation lanes run,
and for the bert encoder; an ``SSDConfig`` for the recurrent decoders; a
``YoloConfig``; None for the mlp, the resnets and ONNX graphs), and for
one-shot /infer serving ``apply(params, x, dtype)`` over a batch of
``input_shape`` samples with ``output_shape`` results, and the
``state_family``: "kv_paged" for causal transformers, "state_slab" for a
config that declares it (``serving_state_family``: the SSD/Mamba family,
one fixed-size state row per stream), "stateless" for every other model,
which serves only one-shot rows. As in the JAX registry, the family
declares the serving ``capabilities`` (``FAMILY_CAPABILITIES``,
``supports``), and ``tp_rule`` the tensor-parallel partition rule
("unshardable:<reason>" where a config pins it, as ``SSDConfig`` does).
``init_fn`` draws a model's random parameters; a spec without one is a
plain transformer of its config (``models.convert.init_params``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tpu_engine_torch.models.transformer import TransformerConfig

# Serving-capability flags per state family, the JAX registry's: the
# registry, not the serving machinery, declares what a family can do, and
# the scheduler and worker fence mismatches loudly.
FAMILY_CAPABILITIES: Dict[str, Tuple[str, ...]] = {
    "kv_paged": ("generate", "two_path", "mixed_step", "spec_decode",
                 "paged_kv", "prefix_sharing", "kv_quantize",
                 "kv_host_tier", "migration", "handoff",
                 "tensor_parallel", "oneshot_rows"),
    "state_slab": ("generate", "two_path", "mixed_step", "migration",
                   "handoff", "oneshot_rows"),
    "stateless": ("oneshot_rows",),
}


@dataclasses.dataclass
class ModelSpec:
    name: str
    config: Optional[object] = None
    # (params, x (B, *input_shape), dtype) -> (B, *output_shape) f32.
    apply: Optional[Callable] = None
    input_shape: Tuple[int, ...] = ()
    output_shape: Tuple[int, ...] = ()
    # (seed, device, dtype) -> params; None: a plain transformer of config.
    init_fn: Optional[Callable] = None
    state_family: str = ""
    # "" derives both from the family (and the config's declarations).
    capabilities: Tuple[str, ...] = ()
    tp_rule: str = ""

    def __post_init__(self):
        if not self.state_family:
            fam = getattr(self.config, "serving_state_family", None)
            if fam is None and isinstance(self.config, TransformerConfig) \
                    and self.config.causal:
                fam = "kv_paged"
            self.state_family = fam or "stateless"
        if self.state_family not in FAMILY_CAPABILITIES:
            raise ValueError(
                f"model '{self.name}' declares unknown state family "
                f"{self.state_family!r}; known: "
                f"{sorted(FAMILY_CAPABILITIES)}")
        if not self.tp_rule:
            rule = getattr(self.config, "tp_partition_rule", None)
            if rule is None:
                rule = {"kv_paged": "transformer",
                        "state_slab": "unshardable: recurrent state_slab "
                                      "models declare no shardable heads "
                                      "axis"}.get(self.state_family,
                                                  "dense_output")
            self.tp_rule = rule
        if not self.capabilities:
            caps = FAMILY_CAPABILITIES[self.state_family]
            if self.tp_rule.startswith("unshardable"):
                caps = tuple(c for c in caps if c != "tensor_parallel")
            self.capabilities = caps

    def supports(self, flag: str) -> bool:
        return flag in self.capabilities

    @property
    def token_input(self) -> bool:
        """Whether the one-shot input is token ids (a transformer's or a
        recurrent decoder's), which the engine stages in f32: bf16 would
        round ids past 256."""
        return (isinstance(self.config, TransformerConfig)
                or self.state_family == "state_slab")

    def init(self, seed: int = 0, device=None, dtype="bfloat16"):
        """Seeded random parameters at full width (models.convert)."""
        if self.init_fn is not None:
            return self.init_fn(seed, device, dtype)
        from tpu_engine_torch.models.convert import init_params

        return init_params(self.config, seed, device=device, dtype=dtype)

    @property
    def input_size(self) -> int:
        n = 1
        for d in self.input_shape:
            n *= d
        return n


# -- tensor-parallel partition rules ------------------------------------------
#
# The JAX registry's rules, ending in per-rank parameter trees instead of
# NamedShardings. A rule is a list of (regex over the '/'-joined leaf
# path, spec tail) pairs, first match wins; the tail is right-aligned onto
# the leaf's shape (the port's per-layer ``blocks`` leaves lack JAX's
# leading L axis, which no tail names), and "model" marks the sharded dim.
# The transformer families' Megatron placement: QKV and the MLP
# up-projections shard their output dim (column parallel), the attention
# output and the MLP down-projection their input dim (row parallel: the
# forward sums the ranks' partials), the LM head its vocab dim; norms,
# embeddings, the row-parallel biases and the MoE expert banks replicate.
_TRANSFORMER_TP_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"attn/w[qkv]/kernel$", (None, "model")),
    (r"attn/w[qkv]/bias$", ("model",)),
    (r"attn/wo/kernel$", ("model", None)),
    (r"mlp/(fc|gate|up)/kernel$", (None, "model")),
    (r"mlp/(fc|gate|up)/bias$", ("model",)),
    (r"mlp/proj/kernel$", ("model", None)),
    (r"head/kernel$", (None, "model")),
    (r"head/bias$", ("model",)),
    (r".*", ()),
]


def _named_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map_named(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _refuse_quantized(params) -> None:
    """Weight-quantized trees refuse tensor parallelism (the JAX
    registry's message): int8 kernels and their per-channel scales would
    shard along mismatched axes or silently replicate."""
    from tpu_engine_torch.ops.quant import tree_is_quantized

    if tree_is_quantized(params):
        raise RuntimeError(
            "tensor-parallel sharding cannot place a weight-quantized "
            "param tree (ops.quant kernel_q/wi_q leaves): the TP "
            "partition rules target full-precision kernels. Use int8 "
            "weight quantization OR tensor parallelism per deployment, "
            "not both.")


def _match_rules_dims(rules, params, tp: int):
    """(regex, tail) rules + a parameter tree -> the tree of each leaf's
    sharded dim (None: replicated). A sharded dim that does not divide by
    ``tp`` replicates its leaf (gpt2's 50257-wide head stays whole)."""

    def dim_for(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        for pat, tail in rules:
            if re.search(pat, name):
                if nd < len(tail):
                    return None
                spec = (None,) * (nd - len(tail)) + tuple(tail)
                for dim, t in enumerate(spec):
                    if t is not None:
                        return dim if shape[dim] % tp == 0 else None
                return None
        return None

    return _map_named(dim_for, params)


def _transformer_tp_rule(params, tp: int):
    _refuse_quantized(params)
    return _match_rules_dims(_TRANSFORMER_TP_RULES, params, tp)


def _dense_output_tp_rule(params, tp: int):
    """The generic rule for models without a named layout (mlp, resnet,
    ONNX graphs), the JAX registry's: kernels of 2+ dims shard their
    output-feature dim, divisible 1-D leaves of more than one element
    shard, the rest replicates. The output-feature dim is JAX's last one;
    a port conv kernel is OIHW, so its output channels are dim 0."""
    _refuse_quantized(params)

    def dim_for(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) >= 2:
            dim = 0 if len(shape) == 4 else len(shape) - 1
            return dim if shape[dim] % tp == 0 else None
        if len(shape) == 1 and shape[0] % tp == 0 and shape[0] > 1:
            return 0
        return None

    return _map_named(dim_for, params)


# name -> callable(params, tp) -> tree of sharded dims (None: replicated).
TP_RULES: Dict[str, Callable] = {
    "transformer": _transformer_tp_rule,
    "dense_output": _dense_output_tp_rule,
}


def tp_unshardable_reason(spec) -> Optional[str]:
    """The declared reason ``spec`` cannot shard tensor-parallel (its
    ``tp_rule`` is "unshardable:<reason>", or a rule no table names), or
    None when its rule resolves. Bare stand-in specs default to the
    transformer layout, as in the JAX registry."""
    rule = getattr(spec, "tp_rule", "") or "transformer"
    if rule.startswith("unshardable"):
        _, _, reason = rule.partition(":")
        return reason.strip() or "model declares itself unshardable"
    if rule not in TP_RULES:
        return f"unknown TP partition rule {rule!r}"
    return None


def tp_shard_dims(spec, params, tp: int):
    """Resolve ``spec.tp_rule`` over ``params`` for ``tp`` ranks: the tree
    of each leaf's sharded dim (None: replicated). Raises RuntimeError
    (the JAX registry's message) for an unshardable or unknown rule."""
    reason = tp_unshardable_reason(spec)
    if reason is not None:
        raise RuntimeError(
            f"model '{getattr(spec, 'name', '?')}' cannot be "
            f"tensor-parallel sharded: {reason}")
    rule = getattr(spec, "tp_rule", "") or "transformer"
    return TP_RULES[rule](params, int(tp))


def tp_rank_trees(spec, params, devices) -> list:
    """The per-rank parameter trees of ``params`` over ``devices`` (one
    rank each; the counterpart of placing the tree by JAX's
    ``tp_shardings``): rank r's leaf is the r-th contiguous chunk of its
    sharded dim, or the whole leaf where it replicates, on
    ``devices[r]``. A replicated leaf already on its rank's device is
    shared, not copied."""
    devices = [torch.device(d) for d in devices]
    tp = len(devices)
    dims = dict(_named_leaves(tp_shard_dims(spec, params, tp)))

    def rank_tree(r):
        def place(name, leaf):
            dim = dims[name]
            if dim is not None:
                leaf = leaf.chunk(tp, dim)[r]
            leaf = leaf.to(devices[r])
            return leaf.contiguous() if dim is not None else leaf
        return _map_named(place, params)

    return [rank_tree(r) for r in range(tp)]


_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {}


def register(name: str):
    def deco(factory: Callable[..., ModelSpec]):
        _REGISTRY[name] = factory
        return factory
    return deco


def _ensure_builtin_models_imported() -> None:
    from tpu_engine_torch.models import (  # noqa: F401
        bert, gpt2, llama, mlp, resnet, ssd, yolo)


def create_model(name: str, **kwargs) -> ModelSpec:
    _ensure_builtin_models_imported()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: "
                       f"{available_models()}")
    return _REGISTRY[name](**kwargs)


def available_models():
    _ensure_builtin_models_imported()
    return sorted(_REGISTRY)


def model_from_path(path_or_name: str) -> str:
    """Map a reference-style model path (e.g. models/resnet50-v2-7.onnx) to
    a registry name, as the JAX package's ``serving.app.model_from_path``
    does, over the same names."""
    names = available_models()
    if path_or_name in names:
        return path_or_name
    base = path_or_name.rsplit("/", 1)[-1].lower()
    for name in names:
        if name in base.replace("-", "").replace("_", ""):
            return name
    for name in names:  # resnet50-v2-7.onnx -> resnet50
        if base.startswith(name[: max(4, len(name) - 2)]):
            return name
    raise ValueError(f"cannot map '{path_or_name}' to a registered model "
                     f"{names}")
