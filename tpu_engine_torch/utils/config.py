"""Worker configuration: the fields of ``tpu_engine``'s ``WorkerConfig``
that the port's /generate lane uses (same names and defaults, except
``model``, which defaults to the one family the port serves at full
width), plus the port's own ``device`` and ``seed``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class WorkerConfig:
    port: int = 8001
    node_id: str = "worker_1"
    model: str = "llama"
    dtype: str = "bfloat16"
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
    # The port's own: where the lane runs (None = the CUDA card) and the
    # seed of its random weights.
    device: Optional[str] = None
    seed: int = 0
