"""The split paths of the decode reads and of the int8 ragged read
(tpu_engine_torch.ops.paged_attention) on the CPU: the plain PyTorch
repetitions of the CUDA kernels' split and merge arithmetic
(``paged_attention_split_reference``,
``quant_paged_attention_split_reference``,
``quant_ragged_paged_attention_split_reference``) against the JAX
package's XLA references and its Pallas kernels (interpret mode), on the
same numpy-seeded inputs, over valid query slots; the decode split plan of
a row against the same row in other batches, over both pools; the decode
kernel's shared memory; and the three-term bf16 split of the int8 ragged
read's f32 weights.

Tolerances: 1e-5 over f32 pools (f32 on both sides; the splits only change
the order of the sums); 2e-2 over bf16 pools on unit-normal inputs, as in
test_torch_ragged_split.py (the split version rounds the softmax weights
to bf16 against each split's maximum, the TPU kernel against its running
maximum over each block, the XLA reference against the row's; an output
near 1-2 is then one or two bf16 ulps, 2^-7, apart); 2e-4 over the int8
pool, the JAX package's bound for its int8 kernels (tests/test_kv_quant.py:
the K scales multiply the scores after the product, where the reference
dequantizes first)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.ops import paged_attention as jpa
from tpu_engine_torch.ops import paged_attention as tpa
from tpu_engine_torch.ops.quant import quantize_kv

QUANT_TOL = 2e-4
TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# name -> (pos, n_heads, n_kv_heads, d_head, block_size, table_len, split):
# splits that end mid-block (24 keys over 16-token blocks, 12 over 8-token
# ones), pos 0 rows, G = 8 at D 64, G = 1 at D 128, and the kernel's own
# split length (None: DECODE_SPLIT_KEYS, over every pool; five splits of
# the 300-token row), D 8 (8-byte
# int8 rows), and G 32 x D 128 (G * D = 4096: no cap in the port's kernel,
# none in the JAX kernel).
DECODE_CASES = {
    "mid-block-24": ((40, 3, 63, 0), 4, 2, 16, 16, 4, 24),
    "mid-block-12-bs8": ((30, 41, 0, 12), 4, 2, 8, 8, 6, 12),
    "g8-d64": ((100, 0, 250), 16, 2, 64, 16, 16, 48),
    "g1-d128": ((70, 5), 2, 2, 128, 8, 10, 32),
    "kernel-split-g8": ((300, 127, 128, 0), 8, 1, 32, 16, 20, None),
    "d8-kernel-split": ((200, 0, 63), 4, 2, 8, 16, 16, None),
    "g32-d128": ((150, 0), 64, 2, 128, 16, 12, None),
}

# name -> (q_lens, pos0, n_heads, n_kv_heads, block_size, table_len,
# split) for the int8 ragged read, as test_torch_ragged_split.py's
# SPLIT_CASES: splits that end mid-block, a causal limit inside a split,
# qlen 0 and pos0 0 rows, G = 8, and the kernel's own split length.
QUANT_CASES = {
    "mid-block-24": ((1, 7, 16, 0), (40, 3, 20, 9), 4, 2, 16, 6, 24),
    "mid-block-12-bs8": ((5, 1, 0, 9), (30, 41, 0, 12), 4, 2, 8, 8, 12),
    "causal-inside-split": ((33, 1), (50, 90), 4, 2, 16, 6, 64),
    "g8-qlen0": ((1, 0, 17, 3), (60, 7, 30, 0), 8, 1, 16, 6, 32),
    "g8-kernel-split": ((24, 1), (500, 1000), 16, 2, 8, 160, None),
}


def _decode_inputs(case, dtype, seed=0):
    pos, h, h_kv, d, bs, nb, split = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    b = len(pos)
    n_pool = b * nb + 1
    q = rng.standard_normal((b, 1, h, d), np.float32)
    k = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    v = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    tables = (1 + rng.permutation(n_pool - 1)).reshape(b, nb).astype(
        np.int32)
    arrs = (q, k, v, tables, np.asarray(pos, np.int32))
    t = [torch.from_numpy(a) for a in arrs]
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    return arrs, t, split


def _jax_args(arrs, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (jnp.asarray(arrs[0]), jnp.asarray(arrs[1], jdt),
            jnp.asarray(arrs[2], jdt), *(jnp.asarray(a) for a in arrs[3:]))


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_matches_jax_kernel_and_reference(case, dtype):
    arrs, t, split = _decode_inputs(case, dtype)
    got = tpa.paged_attention_split_reference(*t, split=split)
    assert got.dtype == dtype and got.shape == t[0].shape
    jargs = _jax_args(arrs, dtype)
    for want in (jpa.paged_attention_reference(*jargs),
                 jpa.paged_attention(*jargs, interpret=True)):
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert float(err.max()) < TOLS[dtype]
    plan = tpa.decode_split_plan(arrs[4], arrs[1].shape[1],
                                 arrs[3].shape[1], split)
    assert plan.max() > 1  # the merge runs


def test_decode_split_plan_at_the_main_path_shape():
    """The smoke's decode step: 8 rows at contexts up to 2047 over 128-wide
    tables of 16-token blocks take 1-32 splits of 64 keys, 111 per kv
    head; one split's tiles fit the default 48 KB of shared memory."""
    pos = [100, 500, 1000, 2046, 17, 1500, 0, 1700]
    plan = tpa.decode_split_plan(pos, 16, 128)
    assert tpa.DECODE_SPLIT_KEYS == 64
    assert plan.tolist() == [2, 8, 16, 32, 1, 24, 1, 27]
    assert tpa.decode_split_plan([-1, 5000], 16, 128).tolist() == [0, 32]
    assert tpa.decode_smem_bytes(8, 64, 2) <= 48 * 1024
    assert tpa.decode_smem_bytes(32, 128, 4) <= tpa.MAX_SMEM_BYTES


@pytest.mark.parametrize("seed", range(4))
def test_decode_split_plan_of_a_row_ignores_the_other_rows(seed):
    """A row's split count depends on its own pos only: alone and beside
    other random rows it gets the same plan, and its output from the split
    version is the same bit for bit."""
    rng = np.random.default_rng(seed)
    bs, nb = 16, 128
    p = int(rng.integers(0, nb * bs))
    alone = tpa.decode_split_plan([p], bs, nb)
    for _ in range(3):
        pos = rng.integers(0, nb * bs, 5)
        pos[2] = p
        assert tpa.decode_split_plan(pos, bs, nb)[2] == alone[0]
    arrs, t, _ = _decode_inputs("kernel-split-g8", torch.float32, seed)
    out = tpa.paged_attention_split_reference(*t)
    for r in range(t[0].shape[0]):
        one = tpa.paged_attention_split_reference(
            t[0][r:r + 1], t[1], t[2], t[3][r:r + 1], t[4][r:r + 1])
        assert torch.equal(one[0], out[r])


def test_decode_wrapper_on_the_cpu_still_takes_the_dense_plain_version():
    arrs, t, _ = _decode_inputs("kernel-split-g8", torch.float32)
    calls = tpa.paged_attention.plain_calls
    got = tpa.paged_attention(*t)
    assert tpa.paged_attention.plain_calls == calls + 1
    split = tpa.paged_attention_split_reference(*t)
    assert float((got - split).abs().max()) < 1e-5


def _quant_decode_inputs(case, seed=0):
    """DECODE_CASES' inputs over the int8 pool and scales that the port's
    quantize_kv makes of the same f32 values: (numpy arrays, tensors,
    split), in the order (q, k_pool, v_pool, k_scale, v_scale, tables,
    pos)."""
    arrs, t, split = _decode_inputs(case, torch.float32, seed)
    (kq, ks), (vq, vs) = quantize_kv(t[1]), quantize_kv(t[2])
    arrs = (arrs[0], kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(),
            *arrs[3:])
    return arrs, [torch.from_numpy(a) for a in arrs], split


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_quant_decode_split_matches_jax_kernel_and_reference(case):
    arrs, t, split = _quant_decode_inputs(case)
    got = tpa.quant_paged_attention_split_reference(*t, split=split)
    assert got.dtype == torch.float32 and got.shape == t[0].shape
    jargs = [jnp.asarray(a) for a in arrs]
    for want in (jpa.quant_paged_attention_reference(*jargs),
                 jpa.quant_paged_attention(*jargs, interpret=True)):
        err = np.abs(got.numpy() - np.asarray(want, np.float32))
        assert float(err.max()) < QUANT_TOL
    plan = tpa.decode_split_plan(arrs[6], arrs[1].shape[1],
                                 arrs[5].shape[1], split)
    assert plan.max() > 1  # the merge runs


@pytest.mark.parametrize("seed", range(2))
def test_quant_decode_split_rows_ignore_the_other_rows(seed):
    """At the kernel's split length a row's plan depends on its own pos
    only, and its output from the int8 split version, run alone, equals
    its output in the batch bit for bit."""
    rng = np.random.default_rng(seed)
    bs, nb = 16, 128
    p = int(rng.integers(0, nb * bs))
    alone = tpa.decode_split_plan([p], bs, nb)
    for _ in range(3):
        pos = rng.integers(0, nb * bs, 5)
        pos[2] = p
        assert tpa.decode_split_plan(pos, bs, nb)[2] == alone[0]
    _, t, _ = _quant_decode_inputs("kernel-split-g8", seed)
    out = tpa.quant_paged_attention_split_reference(*t)
    for r in range(t[0].shape[0]):
        one = tpa.quant_paged_attention_split_reference(
            t[0][r:r + 1], *t[1:5], t[5][r:r + 1], t[6][r:r + 1])
        assert torch.equal(one[0], out[r])


def test_quant_decode_wrapper_on_the_cpu_takes_the_dense_plain_version():
    _, t, _ = _quant_decode_inputs("kernel-split-g8")
    calls = tpa.quant_paged_attention.plain_calls
    got = tpa.quant_paged_attention(*t)
    assert tpa.quant_paged_attention.plain_calls == calls + 1
    assert torch.equal(got, tpa.quant_paged_attention_reference(*t))
    split = tpa.quant_paged_attention_split_reference(*t)
    assert float((got - split).abs().max()) < QUANT_TOL


def test_quant_decode_smem_counts_int8_rows_and_scales():
    """The int8 split's shared memory: D-byte rows padded 16 bytes, q,
    scores, maxima and sums, 8 bytes of scales a key, the table slice. The
    main path's split fits the default 48 KB, G 32 x D 128 fits a thread
    block, G 512 x D 128 (q alone 256 KB) does not."""
    g, d, split = 8, 64, tpa.DECODE_SPLIT_KEYS
    assert tpa.decode_smem_bytes(g, d, 1) == (
        2 * split * (d + 16) + 4 * (g * d + g * split + 2 * g)
        + 8 * split + 4 * (split + 1))
    assert tpa.decode_smem_bytes(g, d, 1) <= 48 * 1024
    assert tpa.decode_smem_bytes(32, 128, 1) <= tpa.MAX_SMEM_BYTES
    assert tpa.decode_smem_bytes(512, 128, 1) > tpa.MAX_SMEM_BYTES
    # D 8 over an odd split: the 24-byte rows' region rounds up to 16 bytes.
    assert tpa.decode_smem_bytes(1, 8, 1, 3) == (
        2 * 80 + 4 * (8 + 3 + 2) + 24 + 16)


def _quant_inputs(case, d=16, seed=0):
    q_lens, pos0, h, h_kv, bs, nb, split = QUANT_CASES[case]
    rng = np.random.default_rng(seed)
    b, w = len(q_lens), max(q_lens)
    n_pool = b * nb + 1
    q = rng.standard_normal((b, w, h, d), np.float32)
    k = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    v = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(x)) for x in (k, v))
    tables = (1 + rng.permutation(n_pool - 1)).reshape(b, nb).astype(
        np.int32)
    arrs = (q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(), tables,
            np.asarray(pos0, np.int32), np.asarray(q_lens, np.int32))
    return arrs, [torch.from_numpy(a) for a in arrs], split


def _valid_err(got, want, qlen):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    valid = np.arange(diff.shape[1])[None, :] < qlen[:, None]
    return float(np.where(valid[:, :, None, None], diff, 0.0).max())


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quant_ragged_split_matches_jax_kernel_and_reference(case):
    arrs, t, split = _quant_inputs(case)
    got = tpa.quant_ragged_paged_attention_split_reference(*t, split=split)
    assert got.dtype == torch.float32
    qlen = arrs[7]
    jargs = [jnp.asarray(a) for a in arrs]
    for want in (jpa.quant_ragged_paged_attention_reference(*jargs),
                 jpa.quant_ragged_paged_attention(*jargs, interpret=True)):
        assert _valid_err(got.numpy(), want, qlen) < QUANT_TOL
    # Padding slots are zeros, as the kernel writes them.
    pad = np.arange(got.shape[1])[None, :] >= qlen[:, None]
    assert float(got.abs().numpy()[pad].max(initial=0.0)) == 0.0
    plan = tpa.ragged_split_plan(arrs[6], qlen, got.shape[1],
                                 t[0].shape[2] // t[1].shape[2],
                                 t[1].shape[1], arrs[5].shape[1], split)
    assert plan.max() > 1  # the merge runs


def test_quant_ragged_split_rows_ignore_the_other_rows():
    """Each row of the int8 split version, run alone (W its own qlen),
    equals its output in the batch bit for bit."""
    arrs, t, split = _quant_inputs("g8-qlen0")
    out = tpa.quant_ragged_paged_attention_split_reference(*t, split=split)
    for r, ql in enumerate(arrs[7].tolist()):
        one = tpa.quant_ragged_paged_attention_split_reference(
            t[0][r:r + 1, :max(ql, 1)], *t[1:5], t[5][r:r + 1],
            t[6][r:r + 1], t[7][r:r + 1], split=split)
        assert torch.equal(one[0, :ql], out[r, :ql])


def test_three_bf16_terms_carry_the_int8_reads_f32_weights():
    """p * vs in three bf16 terms times an int8 V (exact in bf16), summed
    in f32, gives the f32 product to within f32 rounding; one bf16 term
    (p * vs rounded to bf16) is about 2^-9 off."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.random((64, 128), np.float32))
    vs = torch.from_numpy((rng.random(128) * 0.03).astype(np.float32))
    vq = torch.from_numpy(rng.integers(-127, 128, (128, 64)).astype(
        np.float32))
    x = p * vs[None, :]
    exact = x.double() @ vq.double()
    scale = x.double().abs() @ vq.double().abs()
    three = tpa._three_term_product(x, vq)
    one = x.bfloat16().float() @ vq
    three_err = float(((three.double() - exact).abs() / scale).max())
    one_err = float(((one.double() - exact).abs() / scale).max())
    assert three_err < 1e-6
    assert one_err > 100 * three_err
