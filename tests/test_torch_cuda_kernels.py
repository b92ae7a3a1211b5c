"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``cuda`` marker and skips where no CUDA
device is present (the kernels have no CPU mode). This file imports no
jax, so the card's machine runs it without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: 1e-5 with an f32 pool (only the summation order differs);
2e-2 with a bf16 pool on unit-normal inputs (the kernel keeps the
softmax weights in f32 where the plain version rounds them to bf16)."""

import numpy as np
import pytest
import torch

from tpu_engine_torch.ops import paged_attention as tpa

# (q_lens, n_heads, n_kv_heads): the JAX package's ragged_parity_check and
# spec_verify_parity_check shapes, plus the G = 8 grouping of TinyLlama.
CASES = [((1, 7, 16, 17), 4, 2), ((1, 5, 5, 16, 17), 4, 2),
         ((1, 3, 16, 17), 8, 1)]


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
