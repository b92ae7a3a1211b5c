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
dequantizes first). The flash forward: 1e-5 in f32, 2e-2 in bf16 (both
round the weights to bf16, the kernel against its running maximum, the
plain version against the row's), on out and on lse."""

import numpy as np
import pytest
import torch

from tpu_engine_torch.ops import flash as tfl
from tpu_engine_torch.ops import kernels
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


# name -> (parity_inputs kwargs, causal, valid keys per row or None, window)
FLASH_CASES = {
    "causal": (dict(sq=64), True, None, None),
    "ragged-37-53": (dict(sq=37, sk=53), False, None, None),
    "causal-ragged-200": (dict(sq=200), True, None, None),
    "causal-left-pad": (dict(sq=130), True, (130, 71), None),
    "padding-mask": (dict(sq=64), False, (40, 64), None),
    "fully-masked": (dict(sq=64), False, (0, 0), None),
    "window-7": (dict(sq=200), True, None, 7),
    "window-64-pad": (dict(sq=200), True, (200, 90), 64),
}


def _flash_inputs(dev, case, d, dtype):
    kw, causal, valid, window = FLASH_CASES[case]
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in tfl.parity_inputs(d_head=d, seed=d, **kw))
    mask = None
    if valid is not None:
        # Left padding as the dense prefill has it: the valid keys end at
        # the row's last column.
        sk = k.shape[1]
        m = np.zeros((2, sk), np.int32)
        for r, n in enumerate(valid):
            m[r, sk - n:] = 1
        mask = torch.from_numpy(m).to(dev)
    return q, k, v, dict(causal=causal, mask=mask, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("d", tfl.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda_device, case, d, dtype, tol):
    q, k, v, kw = _flash_inputs(cuda_device, case, d, dtype)
    out, lse = _launched(tfl.flash_attention_fwd,
                         lambda: tfl.flash_attention_fwd(q, k, v, **kw))
    ref, ref_lse = tfl.flash_attention_reference(q, k, v, **kw)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert float((out.float() - ref.float()).abs().max()) < tol
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead)
    assert float(torch.where(dead, 0.0, lse - ref_lse).abs().max()) < tol
    if case == "fully-masked":
        assert float(out.float().abs().max()) == 0.0


@pytest.mark.cuda
def test_flash_kernel_reads_strided_operands(cuda_device):
    """q, k, v as (B, H, S, D) tensors viewed as (B, S, H, D): the kernel
    reads them through their strides, no copy."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).transpose(1, 2)
               .contiguous().transpose(1, 2)
               for a in tfl.parity_inputs(sq=100, d_head=64))
    assert not q.is_contiguous()
    out = _launched(tfl.flash_attention_fwd,
                    lambda: tfl.flash_attention(q, k, v, causal=True))
    ref = tfl.flash_attention_reference(q, k, v, causal=True)[0]
    assert float((out - ref).abs().max()) < 1e-5


@pytest.mark.cuda
def test_flash_kernel_refuses_bad_arguments(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in tfl.parity_inputs())
    with pytest.raises(ValueError, match="head dim"):
        tfl.flash_attention(q[..., :8], k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="dtypes"):
        tfl.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="is on"):
        tfl.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="requires causal"):
        tfl.flash_attention(q, k, v, window=4)
    # A launch the library refuses (no batch) raises, it never runs.
    out = torch.empty_like(q)
    lse = torch.empty((2, 4, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="flash_attention launch failed"):
        kernels.launch("flash_attention", q.device, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
                       lse.data_ptr(), 0, 64, 64, 4, 16,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       1, 0, 0.25, 0)
