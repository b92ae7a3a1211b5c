"""Model registry: name -> factory (counterpart of
``tpu_engine/models/registry.py``) for the dense decoder transformers
this port serves. The names and config values are the JAX package's."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from tpu_engine_torch.models.transformer import TransformerConfig

# Names the JAX package registers whose families the port does not serve
# yet: asking for one is a loud refusal, never a silent stand-in.
NOT_YET_PORTED = frozenset({
    "gpt2-moe", "gpt2-moe-test", "mlp", "resnet50", "resnet50-v1", "bert",
    "bert-small-test", "yolov8n", "yolov8n-small-test", "mamba2",
    "ssd-small-test"})


@dataclasses.dataclass
class ModelSpec:
    name: str
    config: TransformerConfig

    def init(self, seed: int = 0, device=None, dtype="bfloat16"):
        """Seeded random parameters at full width (models.convert)."""
        from tpu_engine_torch.models.convert import init_params

        return init_params(self.config, seed, device=device, dtype=dtype)


_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {}


def register(name: str):
    def deco(factory: Callable[..., ModelSpec]):
        _REGISTRY[name] = factory
        return factory
    return deco


def _ensure_builtin_models_imported() -> None:
    from tpu_engine_torch.models import gpt2, llama  # noqa: F401


def create_model(name: str, **kwargs) -> ModelSpec:
    _ensure_builtin_models_imported()
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not yet ported to tpu_engine_torch")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: "
                       f"{available_models()}")
    return _REGISTRY[name](**kwargs)


def available_models():
    _ensure_builtin_models_imported()
    return sorted(_REGISTRY)


