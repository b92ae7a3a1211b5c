"""The batch lanes on the card (the batch Generator and the batch
SpeculativeGenerator; tpu_engine_torch.runtime.generator and
runtime.speculative):

- the flash forward (#5) at the batch lanes' prefill: a bucket of 8 rows
  with 3 live ones, left-padded at 256, 4 heads of 64, so 5 rows are
  fully masked: out and lse against the plain version (f32 1e-5, bf16
  2e-2), the masked rows 0 with lse -inf, no NaN anywhere, bit-identical
  over two runs;
- llama-small-test in f32 (TF32 off) on the card: the streams with and
  without ``fused`` (one decode loop serves both; greedy, and seeded at
  temperature 0.8 with top_p 0.9) equal each other and the CPU's on the
  same weights; beam width 4 equals the CPU's;
- the speculative self-draft (k = 3) on the card: its greedy stream is
  the plain Generator's and every round advances k + 1 tokens.

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_batch_lanes_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_engine_torch.models.convert import params_to
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import flash
from tpu_engine_torch.runtime.generator import Generator, left_pad_batch
from tpu_engine_torch.runtime.speculative import SpeculativeGenerator

F32_TOL = 1e-5
BF16_TOL = 2e-2
MODEL = "llama-small-test"
K = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel and the batch "
                    "lanes on the card")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_flash_over_fully_masked_bucket_rows(card, dtype, tol):
    b, s, h, d = 8, 256, 4, 64
    _, mask, _, _ = left_pad_batch(
        _prompts(100, (200, 37, 256)), b, s)
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=g).to(card, dtype)
               for _ in range(3))
    m = torch.from_numpy(mask).to(card)
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True, mask=m)
    ref, ref_lse = flash.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(),
                                             causal=True, mask=m.cpu())
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((out.cpu().float() - ref.float()).abs().max()) \
        <= tol * scale
    live = torch.isfinite(ref_lse)
    assert torch.equal(live, torch.isfinite(lse.cpu()))
    assert float((lse.cpu()[live] - ref_lse[live]).abs().max()) \
        <= tol * scale
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    dead = m.sum(1) == 0
    assert int(dead.sum()) == 5
    assert (out[dead] == 0).all() and (lse[dead] == float("-inf")).all()
    out2, lse2 = flash.flash_attention_fwd(q, k, v, causal=True, mask=m)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.fixture
def pair(card):
    spec = create_model(MODEL)
    cpu = spec.init(0, device="cpu", dtype="float32")
    return (Generator(spec, params=params_to(cpu, card), dtype="float32",
                      step_chunk=4, device=card),
            Generator(spec, params=cpu, dtype="float32", step_chunk=4,
                      device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, top_p=0.9,
                                             seed=[3, 4, 5, 6, 7])],
                         ids=["greedy", "seeded"])
def test_fused_equals_chunked_and_the_cpu(pair, kw):
    gpu, cpu = pair
    prompts = _prompts(gpu.cfg.vocab, (5, 12, 3, 9, 1))
    chunked = gpu.generate(prompts, max_new_tokens=24, **kw)
    assert gpu.generate(prompts, max_new_tokens=24, fused=True,
                        **kw) == chunked
    assert cpu.generate(prompts, max_new_tokens=24, **kw) == chunked


@pytest.mark.cuda
def test_beam_search_equals_the_cpu(pair):
    gpu, cpu = pair
    prompt = _prompts(gpu.cfg.vocab, (9,))[0]
    assert gpu.beam_search(prompt, beam_width=4, max_new_tokens=16) == \
        cpu.beam_search(prompt, beam_width=4, max_new_tokens=16)


@pytest.mark.cuda
def test_speculative_self_draft_on_the_card(pair, card):
    gpu, _ = pair
    sg = SpeculativeGenerator(gpu.spec, gpu.spec, params=gpu.params,
                              draft_params=gpu.params, k=K,
                              dtype="float32", device=card)
    prompts = _prompts(gpu.cfg.vocab, (5, 12, 3))
    assert sg.generate(prompts, max_new_tokens=16) == \
        gpu.generate(prompts, max_new_tokens=16)
    assert sg.last_stats["mean_tokens_per_round"] == K + 1
