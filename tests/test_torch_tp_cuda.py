"""Tensor-parallel serving on the card: llama-small-test lanes whose
ranks all sit on one card (``tp_devices=["cuda:0"] * tp``).

- f32 greedy streams at tp 2 equal the tp 1 lane's, in the mixed and the
  two-path mode, over f32 and int8 blocks, each prompt sent alone (one
  batch composition for both degrees).
- Every tick launches the mode's kernel once per rank and layer (#1, #2,
  #3 or #4 == tp x layers x steps), with no plain call and no other
  kernel, and no block leaks.
- The pool's shards are contiguous, on the card, H_kv / tp heads each.

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_tp_cuda.py
"""

import pytest
import torch

from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import kernels
from tpu_engine_torch.ops import paged_attention as pa
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

PROMPTS = [[5, 9, 3, 17], [2, 4, 6, 8, 10, 12] * 5, [1] * 20]
MODES = {
    "mixed": (dict(mixed_step=True, mixed_token_budget=32),
              "ragged_paged_attention", 1),
    "two-path": (dict(step_chunk=4), "paged_attention", 4),
    "mixed-int8": (dict(mixed_step=True, mixed_token_budget=32,
                        kv_quantize="int8"),
                   "quant_ragged_paged_attention", 1),
    "two-path-int8": (dict(step_chunk=4, kv_quantize="int8"),
                      "quant_paged_attention", 4),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: tensor-parallel lanes' kernels on "
                    "the card")
    return torch.device("cuda")


def _lane(spec, params, tp, kw):
    dev = {"tp_devices": ["cuda:0"] * tp} if tp > 1 else {"device": "cuda"}
    return ContinuousGenerator(spec, params=params, dtype="float32", tp=tp,
                               kv_block_size=16, prefill_chunk=16,
                               n_slots=4, **dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_lane_on_one_card(card, mode):
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = create_model("llama-small-test")
    params = spec.init(0, device=card, dtype="float32")
    kw, kernel, per_step = MODES[mode]
    runs = {}
    for tp in (1, 2):
        gen = _lane(spec, params, tp, kw)
        try:
            kernels.reset_counts()
            toks = [gen.generate([p], max_new_tokens=8)[0] for p in PROMPTS]
            st = gen.stats()
            steps = (st["mixed"]["ticks"] if "mixed" in st
                     else st["chunks"] * per_step)
            counts = {name: (getattr(pa, name).launches,
                             getattr(pa, name).plain_calls)
                      for name in ("ragged_paged_attention",
                                   "paged_attention",
                                   "quant_paged_attention",
                                   "quant_ragged_paged_attention")}
            assert counts[kernel] == (tp * spec.config.n_layers * steps, 0)
            assert all(c == (0, 0) for k, c in counts.items()
                       if k != kernel)
            pool = st["kv_pool"]
            assert (pool["blocks_free"] + pool["radix_nodes"]
                    == pool["blocks_total"])
            if tp > 1:
                assert st["tp"]["tp"] == pool["tp"] == tp
                for shard in gen._pool.caches.k:
                    assert shard.is_cuda and shard.is_contiguous()
                    assert shard.shape[3] == spec.config.kv_heads // tp
            runs[tp] = toks
        finally:
            gen.stop()
    assert runs[2] == runs[1]
