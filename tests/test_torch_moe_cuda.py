"""The mixture-of-experts FFN and weight-only int8 quantization on the card
(plain PyTorch products: no kernel of the port's own), at gpt2-moe's full
width (d_model 768, d_ff 3072, 8 experts, top-2, capacity factor 1.25):

- ``moe_apply`` on the card against the CPU on the same weights and
  inputs: in f32 (TF32 off) the routing is the same and the outputs agree
  within 1e-4 of max(1, the CPU's largest magnitude); in bf16 at a mixed
  tick's shape (8 x 256 tokens) within 2e-2 of that scale on the tokens
  whose router margin exceeds 1e-3;
- ``quantize_params`` run on the card gives the CPU's int8 trees bit for
  bit (a gpt2-moe tree at full width and two layers, and yolov8n-small-
  test's conv kernels), and so does the KV pool's ``quantize_kv``;
- a full-width forward (2 x 128 tokens, f32) through the quantized tree
  against the same forward through ``dequantize_params`` of it: the
  scale applied to the product's output is exact up to the sum's
  rounding, within 1e-4 of max(1, |ref|).

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_moe_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_engine_torch.models.convert import init_params, params_to
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.models.transformer import transformer_apply
from tpu_engine_torch.ops import moe as tmoe
from tpu_engine_torch.ops import nn
from tpu_engine_torch.ops import quant as tq
from tpu_engine_torch.training.train import tree_leaves

TOL = 1e-4
BF16_TOL = 2e-2
MARGIN = 1e-3
CFG = tmoe.MoEConfig(d_model=768, d_ff=3072, n_experts=8, top_k=2,
                     capacity_factor=1.25)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's products against the "
                    "CPU's")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _routing(params, x, dtype):
    """The dispatch tensor of ``x``'s tokens (their capacity slots)."""
    gate = dict(params["gate"], bias=torch.zeros(
        CFG.n_experts, device=x.device))
    xf = x.reshape(-1, CFG.d_model)
    probs = torch.softmax(nn.dense(gate, xf, dtype=dtype), -1)
    return tmoe.route(probs, CFG, xf.shape[0])[0], probs


def _margin(probs, k):
    s = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
    return (s[:, :-1] - s[:, 1:]).amin(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t", [("float32", 2, 128),
                                       ("bfloat16", 8, 256)])
def test_moe_apply_full_width_card_matches_cpu(card, dtype, b, t):
    g = torch.Generator().manual_seed(0)
    params = tmoe.moe_init(CFG, g, "cpu")
    x = torch.randn((b, t, CFG.d_model), generator=g)
    dt = getattr(torch, dtype)
    ref = tmoe.moe_apply(params, x, CFG, dtype=dt)
    got = tmoe.moe_apply(params_to(params, card), x.to(card), CFG,
                         dtype=dt).cpu()
    assert torch.isfinite(got).all() and got.dtype == torch.float32
    scale = max(1.0, float(ref.abs().max()))
    d_cpu, probs = _routing(params, x, dt)
    d_card, _ = _routing(params_to(params, card), x.to(card), dt)
    if dtype == "float32":
        assert torch.equal(d_card.cpu(), d_cpu), "routing differs"
        err = float((got - ref).abs().max())
        assert err <= TOL * scale, err
    else:
        keep = (_margin(probs, CFG.top_k) > MARGIN).reshape(b, t)
        assert float(keep.float().mean()) > 0.8
        err = float((got - ref).abs()[keep].max())
        assert err <= BF16_TOL * scale, err


@pytest.mark.cuda
def test_int8_trees_on_card_bit_equal_to_cpu(card):
    spec = create_model("gpt2-moe", n_layers=2)
    f32 = init_params(spec.config, seed=0, device=card, dtype="float32")
    on_card = tq.quantize_params(f32)
    on_cpu = tq.quantize_params(params_to(f32, "cpu"))
    for a, b in zip(tree_leaves(on_card), tree_leaves(on_cpu)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    mlp = on_card["blocks"][0]["mlp"]
    assert mlp["wi_q"].dtype == torch.int8
    assert mlp["gate"]["kernel"].dtype == torch.float32
    # The KV pool's quantize_kv divides alike on the card.
    kv = torch.randn((4096, 64), generator=torch.Generator().manual_seed(2))
    for a, b in zip(tq.quantize_kv(kv.to(card)), tq.quantize_kv(kv)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    yolo = create_model("yolov8n-small-test")
    y32 = yolo.init(0, device=card, dtype="float32")
    for a, b in zip(tree_leaves(tq.quantize_params(y32)),
                    tree_leaves(tq.quantize_params(params_to(y32, "cpu")))):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_quantized_forward_matches_dequantized_on_card(card):
    spec = create_model("gpt2-moe", n_layers=2)
    q = tq.quantize_params(init_params(spec.config, seed=0, device=card,
                                       dtype="float32"))
    deq = tq.dequantize_params(q)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, spec.config.vocab, (2, 128)).astype(np.int32)).to(card)
    got = transformer_apply(q, tokens, spec.config, dtype=torch.float32)
    ref = transformer_apply(deq, tokens, spec.config, dtype=torch.float32)
    err = float((got - ref).abs().max())
    assert err <= TOL * max(1.0, float(ref.abs().max())), err
