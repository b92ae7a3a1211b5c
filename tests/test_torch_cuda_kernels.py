"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``cuda`` marker and skips where no CUDA
device is present (the kernels have no CPU mode). This file imports no
jax, so the card's machine runs it without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: 1e-5 with an f32 pool (only the summation order differs);
2e-2 with a bf16 pool on unit-normal inputs (the kernel keeps the
softmax weights in f32 where the plain version rounds them to bf16);
2e-4 with the int8 pool, the JAX package's bound for its int8 kernels
(the kernel applies the K scales after the product, the plain version
dequantizes first)."""

import numpy as np
import pytest
import torch

from tpu_engine_torch.ops import paged_attention as tpa

# (q_lens, n_heads, n_kv_heads): the JAX package's ragged_parity_check and
# spec_verify_parity_check shapes, plus the G = 8 grouping of TinyLlama.
CASES = [((1, 7, 16, 17), 4, 2), ((1, 5, 5, 16, 17), 4, 2),
         ((1, 3, 16, 17), 8, 1)]
# Decode shapes: the JAX package's parity_check defaults and second case,
# and TinyLlama's G = 8 at D 64 with 8-block tables.
DECODE_CASES = [dict(),
                dict(n_heads=8, n_kv_heads=2, d_head=16, block_size=8,
                     n_blocks=17, table_len=6),
                dict(n_heads=16, n_kv_heads=2, d_head=64, n_blocks=33,
                     table_len=8)]
QUANT_TOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _valid_err(out, ref, qlen):
    diff = (out.float() - ref.float()).abs().cpu().numpy()
    valid = np.arange(diff.shape[1])[None, :] < qlen[:, None]
    return float(np.where(valid[:, :, None, None], diff, 0.0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,h,h_kv", CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ragged_kernel_matches_plain(cuda_device, q_lens, h, h_kv, dtype,
                                     tol):
    arrs = tpa.ragged_parity_inputs(q_lens=q_lens, n_heads=h,
                                    n_kv_heads=h_kv)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    launches = tpa.ragged_paged_attention.launches
    out = tpa.ragged_paged_attention(*t)
    ref = tpa.ragged_paged_attention_reference(*t)
    torch.cuda.synchronize()
    assert tpa.ragged_paged_attention.launches == launches + 1
    assert out.dtype == dtype
    assert _valid_err(out, ref, arrs[5]) < tol


@pytest.mark.cuda
def test_ragged_kernel_refuses_bad_arguments(cuda_device):
    t = [torch.from_numpy(a).to(cuda_device)
         for a in tpa.ragged_parity_inputs()]
    bad_tables = t[3].long()
    with pytest.raises(ValueError, match="int32"):
        tpa.ragged_paged_attention(t[0], t[1], t[2], bad_tables, t[4], t[5])
    with pytest.raises(ValueError, match="head dim"):
        tpa.ragged_paged_attention(t[0][..., :6].contiguous(),
                                   t[1][..., :6].contiguous(),
                                   t[2][..., :6].contiguous(), *t[3:])
    with pytest.raises(ValueError, match="is on"):
        tpa.ragged_paged_attention(t[0], t[1].cpu(), t[2], *t[3:])


def _on(dev, arrs):
    return [torch.from_numpy(a).to(dev) for a in arrs]


def _launched(fn, call):
    launches, plain = fn.launches, fn.plain_calls
    out = call()
    torch.cuda.synchronize()
    assert fn.launches == launches + 1 and fn.plain_calls == plain
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kw", DECODE_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain(cuda_device, kw, dtype, tol):
    t = _on(cuda_device, tpa.parity_inputs(**kw))
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    out = _launched(tpa.paged_attention, lambda: tpa.paged_attention(*t))
    ref = tpa.paged_attention_reference(*t)
    assert out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("kw", DECODE_CASES)
def test_quant_paged_kernel_matches_plain(cuda_device, kw):
    t = _on(cuda_device, tpa.parity_inputs(quant=True, **kw))
    out = _launched(tpa.quant_paged_attention,
                    lambda: tpa.quant_paged_attention(*t))
    ref = tpa.quant_paged_attention_reference(*t)
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) < QUANT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,h,h_kv", CASES)
def test_quant_ragged_kernel_matches_plain(cuda_device, q_lens, h, h_kv):
    arrs = tpa.ragged_parity_inputs(q_lens=q_lens, n_heads=h,
                                    n_kv_heads=h_kv, quant=True)
    t = _on(cuda_device, arrs)
    out = _launched(tpa.quant_ragged_paged_attention,
                    lambda: tpa.quant_ragged_paged_attention(*t))
    ref = tpa.quant_ragged_paged_attention_reference(*t)
    assert out.dtype == torch.float32
    assert _valid_err(out, ref, arrs[-1]) < QUANT_TOL


@pytest.mark.cuda
def test_slice2_kernels_refuse_bad_arguments(cuda_device):
    t = _on(cuda_device, tpa.parity_inputs())
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(t[0], t[1], t[2], t[3].long(), t[4])
    with pytest.raises(ValueError, match="one query slot"):
        tpa.paged_attention(t[0].repeat(1, 2, 1, 1), *t[1:])
    qt = _on(cuda_device, tpa.parity_inputs(quant=True))
    with pytest.raises(ValueError, match="int8"):
        tpa.quant_paged_attention(qt[0], qt[1].float(), qt[2], *qt[3:])
    with pytest.raises(ValueError, match="k_scale"):
        tpa.quant_paged_attention(qt[0], qt[1], qt[2], qt[3].double(),
                                  *qt[4:])
    rt = _on(cuda_device, tpa.ragged_parity_inputs(quant=True))
    with pytest.raises(ValueError, match="is on"):
        tpa.quant_ragged_paged_attention(rt[0], rt[1], rt[2], rt[3].cpu(),
                                         *rt[4:])
    with pytest.raises(ValueError, match="qlen"):
        tpa.quant_ragged_paged_attention(*rt[:7], rt[7][:2].contiguous())
