"""The port's paged attention (tpu_engine_torch.ops.paged_attention): the
decode read, the ragged read and both over the int8 pool.

On the CPU: each plain PyTorch version against the JAX package's XLA
reference and its Pallas kernel (interpret mode), on the same
numpy-seeded inputs, over valid query slots. Tolerances: 1e-5 against the
references and the f32 kernels (f32 on both sides; only the summation
order differs); 2e-4 against the int8 kernels, the JAX package's own bound
for them (tests/test_kv_quant.py), since they apply the K scales after the
product. The CUDA kernels against the plain versions are
tests/test_torch_cuda_kernels.py (card only)."""

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
QUANT_KERNEL_TOL = 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (q_lens, n_heads, n_kv_heads): the JAX package's ragged_parity_check and
# spec_verify_parity_check shapes, plus the G = 8 grouping of TinyLlama.
CASES = [((1, 7, 16, 17), 4, 2), ((1, 5, 5, 16, 17), 4, 2),
         ((1, 3, 16, 17), 8, 1)]
# Decode shapes: the JAX package's parity_check defaults, its second case
# (test_paged_kv.py), and TinyLlama's G = 8 at D 64.
DECODE_CASES = [dict(),
                dict(n_heads=8, n_kv_heads=2, d_head=16, block_size=8,
                     n_blocks=17, table_len=6),
                dict(n_heads=16, n_kv_heads=2, d_head=64, n_blocks=33,
                     table_len=8)]


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


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kw", DECODE_CASES)
def test_decode_plain_matches_jax_kernel_and_reference(kw):
    arrs = tpa.parity_inputs(**kw)
    out = tpa.paged_attention_reference(
        *[torch.from_numpy(a) for a in arrs]).numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    ref = jpa.paged_attention_reference(*jarrs)
    pallas = jpa.paged_attention(*jarrs, interpret=True)
    assert out.shape == ref.shape == (arrs[0].shape)
    assert np.abs(out - _np(ref)).max() < TOL
    assert np.abs(out - _np(pallas)).max() < TOL


def test_decode_plain_bf16_pool_matches_jax_reference():
    """A bf16 pool: both plain versions return bf16 and round the softmax
    weights to bf16 before the second product, at the same points."""
    q, k, v, tables, pos = tpa.parity_inputs(**DECODE_CASES[2])
    t = [torch.from_numpy(a) for a in (q, k, v, tables, pos)]
    t[1], t[2] = t[1].bfloat16(), t[2].bfloat16()
    out = tpa.paged_attention_reference(*t)
    assert out.dtype == torch.bfloat16
    ref = jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(pos))
    assert np.abs(out.float().numpy() - _np(ref)).max() < TOL


@pytest.mark.parametrize("kw", DECODE_CASES)
def test_quant_decode_plain_matches_jax_kernel_and_reference(kw):
    arrs = tpa.parity_inputs(quant=True, **kw)
    assert arrs[1].dtype == np.int8 and arrs[3].dtype == np.float32
    out = tpa.quant_paged_attention_reference(
        *[torch.from_numpy(a) for a in arrs])
    assert out.dtype == torch.float32
    jarrs = [jnp.asarray(a) for a in arrs]
    ref = jpa.quant_paged_attention_reference(*jarrs)
    pallas = jpa.quant_paged_attention(*jarrs, interpret=True)
    assert np.abs(out.numpy() - _np(ref)).max() < TOL
    assert np.abs(out.numpy() - _np(pallas)).max() < QUANT_KERNEL_TOL


@pytest.mark.parametrize("q_lens,h,h_kv", CASES)
def test_quant_ragged_plain_matches_jax_kernel_and_reference(q_lens, h,
                                                             h_kv):
    arrs = tpa.ragged_parity_inputs(q_lens=q_lens, n_heads=h,
                                    n_kv_heads=h_kv, quant=True)
    qlen = arrs[-1]
    out = tpa.quant_ragged_paged_attention_reference(
        *[torch.from_numpy(a) for a in arrs]).numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    ref = jpa.quant_ragged_paged_attention_reference(*jarrs)
    pallas = jpa.quant_ragged_paged_attention(*jarrs, interpret=True)
    assert _valid_err(out, ref, qlen) < TOL
    assert _valid_err(out, pallas, qlen) < QUANT_KERNEL_TOL


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
    # The decode read's free row (pos 0, null table) likewise.
    q, k, v, tables, pos = tpa.parity_inputs()
    k[0] = 0.0
    v[0] = 0.0
    tables[1] = 0
    pos[1] = 0
    out = tpa.paged_attention(*[torch.from_numpy(a) for a in
                                (q, k, v, tables, pos)])
    assert float(out[1].abs().max()) == 0.0


@pytest.mark.parametrize("wrapper,reference,inputs", [
    ("ragged_paged_attention", "ragged_paged_attention_reference",
     lambda: tpa.ragged_parity_inputs()),
    ("paged_attention", "paged_attention_reference",
     lambda: tpa.parity_inputs()),
    ("quant_paged_attention", "quant_paged_attention_reference",
     lambda: tpa.parity_inputs(quant=True)),
    ("quant_ragged_paged_attention",
     "quant_ragged_paged_attention_reference",
     lambda: tpa.ragged_parity_inputs(quant=True)),
])
def test_cpu_tensors_take_the_plain_path(wrapper, reference, inputs):
    fn = getattr(tpa, wrapper)
    arrs = [torch.from_numpy(a) for a in inputs()]
    launches, plain = fn.launches, fn.plain_calls
    out = fn(*arrs)
    assert fn.launches == launches
    assert fn.plain_calls == plain + 1
    assert torch.equal(out, getattr(tpa, reference)(*arrs))


def test_import_needs_neither_nvcc_nor_triton():
    """Importing the kernel modules builds nothing: with no nvcc on PATH
    and no CUDA_HOME they import, the shared library names its path, and
    no triton loads."""
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=REPO)
    code = ("import sys\n"
            "import tpu_engine_torch.ops.paged_attention as pa\n"
            "import tpu_engine_torch.ops.flash as fl\n"
            "import tpu_engine_torch.ops.kernels as kl\n"
            "assert kl._library is None\n"
            "assert kl.kernel_library_path().suffix == '.so'\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
