"""Sequence parallelism, GPipe and expert-parallel MoE on the card: every
mesh rank on one card (``Mesh(["cuda:0"] * n, ...)``), f32 with TF32 off.

- The ring over the flash forward (#5 a hop, merged by lse) against the
  plain ring (JAX's accumulation step, on CPU copies of the inputs),
  causal, masked and with fully masked rows, within 1e-5; #5 launches
  n(n+1)/2 times under causal and n² times without, with no plain call.
- Ulysses: #5 once a rank; the same bound.
- The merged ring refuses inputs that require grad.
- GPipe over llama-small-test's blocks: #5 == layers x microbatches.
- gpt2-moe-test with its expert banks split over 4 ranks: within 1e-4 of
  the unsharded forward, #5 once a layer.
- #5's f32 output over bf16 inputs (the ring's hops) against its plain
  version, and rounding to the bf16 output's bits.

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_seqpar_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_engine_torch.models import transformer as tt
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import flash, kernels
from tpu_engine_torch.parallel.mesh import Mesh
from tpu_engine_torch.parallel.pipeline import pipeline_apply
from tpu_engine_torch.parallel.ring import ring_attention, ulysses_attention

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash forward (#5) on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _qkv(seed, b=2, s=64, h=4, d=64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g) for _ in range(3)]


def _mask(b, s, valid):
    m = torch.zeros((b, s), dtype=torch.int32)
    m[:, :valid] = 1
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("causal,valid", [(True, None), (False, 40),
                                          (True, 50), (False, 0)],
                         ids=["causal", "mask", "causal+mask",
                              "fully-masked"])
def test_ring_on_the_card_matches_the_plain_ring(card, causal, valid):
    n = 4
    q, k, v = _qkv(0)
    mask = None if valid is None else _mask(2, 64, valid)
    want = ring_attention(q, k, v, Mesh(["cpu"] * n, (n,), ("seq",)),
                          causal=causal, kv_mask=mask)
    kernels.reset_counts()
    got = ring_attention(*(t.to(card) for t in (q, k, v)),
                         Mesh([card] * n, (n,), ("seq",)), causal=causal,
                         kv_mask=None if mask is None else mask.to(card))
    torch.cuda.synchronize()
    fwd = flash.flash_attention_fwd
    assert fwd.launches == (n * (n + 1) // 2 if causal else n * n)
    assert fwd.plain_calls == 0
    assert (got.cpu() - want).abs().max().item() <= TOL
    if valid == 0:
        assert (got == 0).all()


@pytest.mark.cuda
def test_ulysses_on_the_card_matches_the_plain_version(card):
    n = 4
    q, k, v = _qkv(1, h=8)
    mask = _mask(2, 64, 45)
    want = ulysses_attention(q, k, v, Mesh(["cpu"] * n, (n,), ("seq",)),
                             causal=True, kv_mask=mask)
    kernels.reset_counts()
    got = ulysses_attention(*(t.to(card) for t in (q, k, v)),
                            Mesh([card] * n, (n,), ("seq",)), causal=True,
                            kv_mask=mask.to(card))
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == n
    assert flash.flash_attention_fwd.plain_calls == 0
    assert (got.cpu() - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_ring_on_the_card_refuses_grad(card):
    q, k, v = (t.to(card).requires_grad_() for t in _qkv(2))
    with pytest.raises(NotImplementedError, match="forward-only"):
        ring_attention(q, k, v, Mesh([card] * 4, (4,), ("seq",)),
                       causal=True)


@pytest.mark.cuda
def test_gpipe_on_the_card_launches_once_per_layer_and_microbatch(card):
    spec = create_model("llama-small-test")
    cfg = spec.config
    params = spec.init(0, device=card, dtype="float32")
    h0 = torch.randn((8, 32, cfg.d_model), generator=torch.Generator(
        ).manual_seed(3)).to(card)

    def block(bp, h):
        return tt._block_apply(bp, h, cfg, mask=None, dtype=torch.float32)

    want = h0
    for bp in params["blocks"]:
        want = block(bp, want)
    kernels.reset_counts()
    got = pipeline_apply(block, params["blocks"], h0,
                         Mesh([card] * 2, (2,), ("stage",)),
                         n_microbatches=4)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == cfg.n_layers * 4
    assert (got - want).abs().max().item() <= 2e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_expert_parallel_gpt2_moe_on_the_card(card):
    spec = create_model("gpt2-moe-test")
    cfg = spec.config
    params = spec.init(0, device=card, dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab, (2, 16))).to(card)
    want = tt.transformer_apply(params, tokens, cfg, dtype=torch.float32)
    ep = tt.expert_parallel_params(params, Mesh([card] * 4, (4,),
                                                ("expert",)))
    kernels.reset_counts()
    got = tt.transformer_apply(ep, tokens, cfg, dtype=torch.float32)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == cfg.n_layers
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_flash_f32_output_over_bf16_inputs(card):
    """#5's f32 output (the ring's hops) against the plain version's; it
    rounds to the bf16 output's bits."""
    q, k, v = (t.to(card, torch.bfloat16) for t in _qkv(5, s=256, h=8))
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True,
                                         out_dtype=torch.float32)
    ref, ref_lse = flash.flash_attention_reference(
        q, k, v, causal=True, out_dtype=torch.float32)
    b16, lse16 = flash.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.equal(lse, lse16)
    assert (out - ref).abs().max().item() <= 2e-2
    assert torch.equal(out.to(torch.bfloat16), b16)
