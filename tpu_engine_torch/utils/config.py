"""Worker configuration: the fields of ``tpu_engine``'s ``WorkerConfig``
that the port's lanes use, with the same names and defaults (``model``
defaults to ``"resnet50"``, the one-shot /infer lane a default launch
serves), plus the port's own ``device`` and ``seed``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class WorkerConfig:
    port: int = 8001
    node_id: str = "worker_1"
    model: str = "resnet50"             # registry name (models.registry)
    # A reference-style model path (e.g. models/resnet50-v2-7.onnx) names
    # the model only; the port loads no ONNX graph or HF checkpoint.
    model_path: Optional[str] = None
    # The /infer lane: result cache, dynamic batcher, engine buckets.
    cache_capacity: int = 1000
    max_batch_size: int = 32
    batch_timeout_ms: float = 20.0
    batch_linger_ms: float = 0.0        # accumulation window (0 = off)
    dtype: str = "bfloat16"
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    fake_cached_latency_us: int = 50    # inference_time_us of a cache hit
    # Dispatched /infer batches in flight before the batcher collects the
    # oldest (engine batch_submit / batch_collect); 1 = lockstep.
    pipeline_depth: int = 4
    gen_max_batch_size: int = 8         # decode rows (scheduler slots)
    gen_step_chunk: int = 16            # two-path decode steps per chunk
    gen_prefill_chunk: int = 256
    gen_prefix_cache_mb: int = 64       # dense lane's prompt prefix cache
    gen_kv_block_size: int = 0          # 0: dense KV cache; > 0: paged
    gen_kv_blocks: int = 0              # 0 = auto (dense-equivalent)
    gen_kv_quantize: str = ""           # "int8": quantized block pool
    gen_prefix_sharing: bool = True
    gen_mixed_step: bool = False        # paged only; False: two-path
    gen_mixed_token_budget: int = 0     # 0 = auto (gen_prefill_chunk)
    # Continuous speculation (paged only, either mode): proposals per
    # decode row per tick, 0 = off (--spec-k); the drafter, "ngram" or
    # "model" (--spec-draft); the draft model, None = by the target
    # (gpt2 -> distilgpt2) (--gen-draft-model); draft weights, which the
    # port does not load yet (a non-empty value refuses).
    gen_continuous_spec_k: int = 0
    gen_spec_draft: str = "ngram"
    gen_draft_model: Optional[str] = None
    gen_draft_path: Optional[str] = None
    # One-shot /infer and /score requests ride the continuous scheduler as
    # single-tick rows; False serves them through the dedicated batch lane
    # (runtime.batch_processor) instead (--no-unified-stateless).
    unified_stateless: bool = True
    # The port's own: where the lane runs (None = the CUDA card) and the
    # seed of its random weights.
    device: Optional[str] = None
    seed: int = 0
