"""The ragged read's split path (tpu_engine_torch.ops.paged_attention) on
the CPU: the plain PyTorch repetition of the CUDA kernel's split and merge
arithmetic (``ragged_paged_attention_split_reference``) against the JAX
package's XLA reference, on the same numpy-seeded inputs, over valid
query slots; the split plan of a row against the same row in other
batches; and the three-term bf16 split of f32 q that the kernel's tensor
core products use.

Tolerances: 1e-5 over f32 pools (f32 on both sides; the splits only change
the order of the sums); 2e-2 over bf16 pools on unit-normal inputs (the
split version rounds the softmax weights to bf16 against each split's
maximum before the V product, as the TPU kernel rounds them, the reference
does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.ops import paged_attention as jpa
from tpu_engine_torch.ops import paged_attention as tpa

# name -> (q_lens, pos0, n_heads, n_kv_heads, block_size, table_len,
# split): splits that end mid-block (24 keys over 16-token blocks, 12 over
# 8-token ones), a causal limit inside a split (a chunk whose queries
# reach into the split they start in), qlen 0 rows, G = 8, and the
# kernel's own split length (several splits per tile at 8-token blocks).
SPLIT_CASES = {
    "mid-block-24": ((1, 7, 16, 0), (40, 3, 20, 9), 4, 2, 16, 6, 24),
    "mid-block-12-bs8": ((5, 1, 0, 9), (30, 41, 0, 12), 4, 2, 8, 8, 12),
    "causal-inside-split": ((33, 1), (50, 90), 4, 2, 16, 6, 64),
    "g8-qlen0": ((1, 0, 17, 3), (60, 7, 30, 0), 8, 1, 16, 6, 32),
    "g8-chunk-tiles": ((24, 1), (500, 1000), 16, 2, 8, 160, None),
}


def _inputs(case, dtype, d=16, seed=0):
    q_lens, pos0, h, h_kv, bs, nb, split = SPLIT_CASES[case]
    rng = np.random.default_rng(seed)
    b, w = len(q_lens), max(q_lens)
    n_pool = b * nb + 1
    q = rng.standard_normal((b, w, h, d), np.float32)
    k = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    v = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    tables = (1 + rng.permutation(n_pool - 1)).reshape(b, nb).astype(
        np.int32)
    arrs = (q, k, v, tables, np.asarray(pos0, np.int32),
            np.asarray(q_lens, np.int32))
    t = [torch.from_numpy(a) for a in arrs]
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    return arrs, t, split


def _valid_err(got, want, qlen):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    valid = np.arange(diff.shape[1])[None, :] < qlen[:, None]
    return float(np.where(valid[:, :, None, None], diff, 0.0).max())


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_split_and_merge_matches_jax_reference(case, dtype, tol):
    arrs, t, split = _inputs(case, dtype)
    got = tpa.ragged_paged_attention_split_reference(*t, split=split)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jpa.ragged_paged_attention_reference(
        jnp.asarray(arrs[0]), jnp.asarray(arrs[1], jdt),
        jnp.asarray(arrs[2], jdt), *(jnp.asarray(a) for a in arrs[3:]))
    assert got.dtype == dtype
    qlen = arrs[5]
    assert _valid_err(got.float().numpy(), np.asarray(want, np.float32),
                      qlen) < tol
    # Padding slots are zeros, as the kernel writes them.
    pad = np.arange(got.shape[1])[None, :] >= qlen[:, None]
    assert float(got.float().abs().numpy()[pad].max(initial=0.0)) == 0.0
    plan = tpa.ragged_split_plan(arrs[4], qlen, got.shape[1],
                                 t[0].shape[2] // t[1].shape[2],
                                 t[1].shape[1], arrs[3].shape[1], split)
    assert plan.max() > 1  # the merge pass runs


def test_kernel_split_length_is_whole_blocks():
    for bs in (1, 8, 16, 48, 128):
        split = tpa.ragged_split_len(bs)
        assert split % bs == 0 and 0 < split <= tpa.SPLIT_KEYS
        assert split // bs <= 512  # the kernel's staged table slice
    assert tpa.ragged_split_len(16) == tpa.SPLIT_KEYS


@pytest.mark.parametrize("seed", range(4))
def test_split_plan_of_a_row_ignores_the_other_rows(seed):
    """A row's split counts depend on its own pos0 and qlen only: the same
    row alone (W its own qlen), and beside other random rows at a larger
    W, gets the same plan over its tiles, and no plan for the tiles
    beyond them."""
    rng = np.random.default_rng(seed)
    bs, nb, g = 16, 128, 8
    ql = int(rng.integers(0, 300))
    p0 = int(rng.integers(0, nb * bs - ql))
    alone = tpa.ragged_split_plan([p0], [ql], max(ql, 1), g, bs, nb)[0]
    for _ in range(3):
        others = rng.integers(0, 300, 5)
        qlen = np.concatenate([others[:2], [ql], others[2:]])
        pos0 = np.array([int(rng.integers(0, nb * bs - x)) for x in qlen])
        pos0[2] = p0
        w = int(qlen.max())
        batch = tpa.ragged_split_plan(pos0, qlen, w, g, bs, nb)[2]
        n = len(alone)
        assert np.array_equal(batch[:n], alone)
        assert not batch[n:].any()


def test_wrapper_on_the_cpu_still_takes_the_dense_plain_version():
    """The wrapper's CPU path is the plain dense version, which the split
    version agrees with on the default split length."""
    arrs, t, _ = _inputs("g8-chunk-tiles", torch.float32)
    calls = tpa.ragged_paged_attention.plain_calls
    got = tpa.ragged_paged_attention(*t)
    assert tpa.ragged_paged_attention.plain_calls == calls + 1
    split = tpa.ragged_paged_attention_split_reference(*t)
    assert _valid_err(got.numpy(), split.numpy(), arrs[5]) < 1e-5


def test_three_bf16_terms_carry_f32_q():
    """hi + mid + lo reconstructs q to within 2^-24 of its magnitude (two
    terms leave about 2^-16), and the terms' three products with a bf16 K,
    summed in f32, give q's f32 product with K to within f32 rounding."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy((rng.standard_normal((64, 64))
                          * np.exp2(rng.integers(-8, 8, (64, 1))))
                         .astype(np.float32))
    hi, mid, lo = tpa.split_bf16_terms(q)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    q64 = q.double()
    three = hi.double() + mid.double() + lo.double()
    two = hi.double() + mid.double()
    assert float(((three - q64).abs() / q64.abs()).max()) <= 2.0 ** -24
    assert float(((two - q64).abs() / q64.abs()).max()) > 2.0 ** -20
    k = torch.from_numpy(rng.standard_normal((128, 64), np.float32)
                         ).bfloat16()
    exact = q64 @ k.double().T
    f32 = q @ k.float().T
    split = sum(t.float() @ k.float().T for t in (lo, mid, hi))
    scale = q64.abs() @ k.double().abs().T  # sum of |q_d k_d|
    f32_err = float(((f32.double() - exact).abs() / scale).max())
    split_err = float(((split.double() - exact).abs() / scale).max())
    assert split_err <= 4 * max(f32_err, 2.0 ** -24)
    assert split_err < 1e-6
    two_err = float((((hi.float() @ k.float().T + mid.float() @ k.float().T)
                      .double() - exact).abs() / scale).max())
    assert two_err > split_err
