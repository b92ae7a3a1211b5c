"""Brownout on the card: a speculative scheduler of a small llama in f32
(TF32 off) gives the same greedy tokens with spec running and under the
spec_off and swap_defer stages' degradations (budget halved, spec
suspended, swap-ins deferred), proposes nothing while suspended, and its
ragged kernel launches exactly layers x spec ticks whether suspended or
not (no plain call). Every test carries the ``cuda`` marker and skips
where no CUDA device is present. This file imports no jax, so the card's
machine runs it without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_overload_cuda.py
"""

import pytest
import torch

from tpu_engine_torch.models.convert import init_params
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import kernels
from tpu_engine_torch.ops import paged_attention as tpa
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

MODES = {"mixed": dict(mixed_step=True, mixed_token_budget=32),
         "two-path": dict(step_chunk=4)}
MOTIF = [7, 91, 33, 5, 18, 120, 64, 2]


@pytest.fixture
def f32_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ragged kernel has no CPU "
                    "mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_suspended_greedy_identity_and_launches(f32_card, mode):
    spec = create_model("llama-small-test", max_seq=256)
    params = init_params(spec.config, seed=0, device=f32_card,
                         dtype="float32")
    gen = ContinuousGenerator(spec, params=params, dtype="float32",
                              n_slots=4, max_seq=256, kv_block_size=16,
                              prefill_chunk=16, spec_k=4, device=f32_card,
                              **MODES[mode])
    prompts = [(MOTIF * 8)[:60], [(i * 37) % 250 + 1 for i in range(45)]]
    layers = spec.config.n_layers
    try:
        runs = {}
        for key, stage in (("spec", {}),
                           ("spec_off", dict(budget_frac=0.5,
                                             suspend_spec=True,
                                             defer_swap_in=True))):
            gen.set_brownout(**stage)
            kernels.reset_counts()
            st0 = gen.stats()["spec"]
            runs[key] = gen.generate(prompts, max_new_tokens=24,
                                     repetition_penalty=[0.1, 1.0])
            st1 = gen.stats()["spec"]
            proposed = st1["proposed_tokens"] - st0["proposed_tokens"]
            ticks = st1["dispatches"] - st0["dispatches"]
            ragged = tpa.ragged_paged_attention
            assert ragged.plain_calls == 0
            assert ragged.launches == layers * ticks > 0
            assert (proposed == 0) is (key == "spec_off")
            if key == "spec_off":
                assert gen.stats()["brownout"] == {
                    "budget_frac": 0.5, "spec_suspended": True,
                    "swap_in_deferred": True}
        assert runs["spec"] == runs["spec_off"]
    finally:
        gen.set_brownout()
        gen.stop()
