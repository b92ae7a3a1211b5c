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
from typing import Callable, Dict, Optional, Tuple

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


def tp_unshardable_reason(spec) -> Optional[str]:
    """The declared reason ``spec`` cannot shard tensor-parallel (its
    ``tp_rule`` is "unshardable:<reason>"), or None."""
    rule = getattr(spec, "tp_rule", "") or "transformer"
    if rule.startswith("unshardable"):
        _, _, reason = rule.partition(":")
        return reason.strip() or "model declares itself unshardable"
    return None


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
