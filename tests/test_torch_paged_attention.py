"""The port's ragged paged attention (tpu_engine_torch.ops.paged_attention).

On the CPU: the plain PyTorch version against the JAX package's Pallas
kernel (interpret mode) and its XLA reference, on the same numpy-seeded
f32 inputs, over valid query slots, within 1e-5 (f32 on both sides; only
the summation order differs). The CUDA kernel against the plain version
is tests/test_torch_cuda_kernels.py (card only)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.ops import paged_attention as jpa
from tpu_engine_torch.ops import paged_attention as tpa

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (q_lens, n_heads, n_kv_heads): the JAX package's ragged_parity_check and
# spec_verify_parity_check shapes, plus the G = 8 grouping of TinyLlama.
CASES = [((1, 7, 16, 17), 4, 2), ((1, 5, 5, 16, 17), 4, 2),
         ((1, 3, 16, 17), 8, 1)]


def _valid_err(out, ref, qlen):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    valid = np.arange(out.shape[1])[None, :] < qlen[:, None]
    return float(np.abs(np.where(valid[:, :, None, None], out - ref,
                                 0.0)).max())


@pytest.mark.parametrize("q_lens,h,h_kv", CASES)
def test_plain_matches_jax_kernel_and_reference(q_lens, h, h_kv):
    arrs = tpa.ragged_parity_inputs(q_lens=q_lens, n_heads=h,
                                    n_kv_heads=h_kv)
    qlen = arrs[5]
    out = tpa.ragged_paged_attention_reference(
        *[torch.from_numpy(a) for a in arrs]).numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    ref = jpa.ragged_paged_attention_reference(*jarrs)
    pallas = jpa.ragged_paged_attention(*jarrs, interpret=True)
    assert _valid_err(out, ref, qlen) < TOL
    assert _valid_err(out, pallas, qlen) < TOL


def test_free_row_gives_zero():
    """A free row (qlen 0, all-null table, pos0 0) attends only the null
    block's first column: with a zero null block its output is 0."""
    q, k, v, tables, pos0, qlen = tpa.ragged_parity_inputs(q_lens=(1, 7))
    k[0] = 0.0
    v[0] = 0.0
    tables[1] = 0
    pos0[1] = 0
    qlen[1] = 0
    out = tpa.ragged_paged_attention(*[torch.from_numpy(a) for a in
                                       (q, k, v, tables, pos0, qlen)])
    assert float(out[1].abs().max()) == 0.0


def test_cpu_tensors_take_the_plain_path():
    arrs = [torch.from_numpy(a) for a in tpa.ragged_parity_inputs()]
    launches = tpa.ragged_paged_attention.launches
    plain = tpa.ragged_paged_attention.plain_calls
    out = tpa.ragged_paged_attention(*arrs)
    assert tpa.ragged_paged_attention.launches == launches
    assert tpa.ragged_paged_attention.plain_calls == plain + 1
    assert torch.equal(out, tpa.ragged_paged_attention_reference(*arrs))


def test_import_needs_neither_nvcc_nor_triton():
    """Importing the module builds nothing: with no nvcc on PATH and no
    CUDA_HOME it imports, names its library path, and loads no triton."""
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=REPO)
    code = ("import sys\n"
            "import tpu_engine_torch.ops.paged_attention as pa\n"
            "assert pa._library is None\n"
            "assert pa.kernel_library_path().suffix == '.so'\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
