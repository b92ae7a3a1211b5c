"""The port's flash attention (tpu_engine_torch.ops.flash, its plain
version on the CPU) against the JAX package's ``flash_attention`` run
through the Pallas interpreter, on the same numpy-seeded inputs, at the
shapes of tests/test_flash_attention.py (causal and not, ragged 37/53,
padding mask, causal plus mask, fully masked rows, bf16) and at
tests/test_sliding_window.py's window case; ``lse`` against a numpy
logsumexp of the masked scores. Tolerances: 1e-5 in f32 (differently
ordered f32 sums), 2e-2 in bf16 (the online kernel rounds its weights to
bf16 against a running maximum, the plain version against the row's
maximum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.ops.flash import flash_attention as jflash
from tpu_engine_torch.ops import flash as tf
from tpu_engine_torch.ops import kernels

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _mask(b, sk, valid):
    m = np.zeros((b, sk), np.int32)
    m[:, :valid] = 1
    return m


# name -> (parity_inputs kwargs, causal, mask (valid keys) or None, window)
CASES = {
    "plain": (dict(seed=0), False, None, None),
    "causal": (dict(seed=0), True, None, None),
    "ragged-37-53": (dict(sq=37, sk=53, seed=1), False, None, None),
    "causal-ragged-45": (dict(sq=45, seed=2), True, None, None),
    "padding-mask": (dict(seed=3), False, 40, None),
    "causal-plus-mask": (dict(seed=4), True, 50, None),
    "fully-masked": (dict(seed=5), False, 0, None),
    "window-7": (dict(sq=64, n_heads=2, d_head=32, seed=6), True, None, 7),
}


def _run_jax(q, k, v, causal, mask, window, dtype=jnp.float32):
    out = jflash(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                 jnp.asarray(v, dtype), causal=causal,
                 mask=None if mask is None else jnp.asarray(mask),
                 block_q=16, block_k=16, interpret=True, window=window)
    return np.asarray(out, np.float32)


def _numpy_lse(q, k, causal, mask, window):
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    sq, sk = q.shape[1], k.shape[1]
    keep = np.ones((sq, sk), bool)
    if causal:
        qp, kp = np.arange(sq)[:, None], np.arange(sk)[None, :]
        keep = qp >= kp
        if window is not None:
            keep &= qp - kp < window
    keep = np.broadcast_to(keep, s.shape).copy()
    if mask is not None:
        keep &= mask[:, None, None, :] > 0
    s = np.where(keep, s, -np.inf)
    m = s.max(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = m + np.log(np.exp(s - np.where(np.isinf(m), 0, m)[..., None])
                         .sum(-1))
    return np.where(keep.any(-1), lse, -np.inf)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax_interpreted(case):
    kw, causal, valid, window = CASES[case]
    q, k, v = tf.parity_inputs(**kw)
    mask = None if valid is None else _mask(q.shape[0], k.shape[1], valid)
    want = _run_jax(q, k, v, causal, mask, window)
    out, lse = tf.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, mask=None if mask is None else torch.from_numpy(mask),
        window=window)
    assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
    assert not torch.isnan(out).any()
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    want_lse = _numpy_lse(q, k, causal, mask, window)
    assert tuple(lse.shape) == (q.shape[0], q.shape[2], q.shape[1])
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(want_lse))
    live = np.isfinite(want_lse)
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live],
                               rtol=F32_TOL, atol=F32_TOL)
    if case == "fully-masked":
        assert float(out.abs().max()) == 0.0
        assert bool(torch.all(lse == float("-inf")))


def test_flash_bf16_matches_jax_interpreted():
    q, k, v = tf.parity_inputs(seed=6)
    want = _run_jax(q, k, v, True, None, None, jnp.bfloat16)
    out = tf.flash_attention(torch.from_numpy(q).bfloat16(),
                             torch.from_numpy(k).bfloat16(),
                             torch.from_numpy(v).bfloat16(), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_flash_long_window_matches_jax_interpreted():
    """tests/test_sliding_window.py's window 64 at S 200 (keys beyond the
    first 128-key tile are skipped below the band)."""
    q, k, v = tf.parity_inputs(sq=200, n_heads=2, d_head=32, seed=7)
    want = _run_jax(q, k, v, True, None, 64)
    out = tf.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, window=64)
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_window_without_causal_raises():
    q, k, v = (torch.from_numpy(a) for a in tf.parity_inputs())
    with pytest.raises(ValueError, match="requires causal"):
        tf.flash_attention(q, k, v, window=8)
    with pytest.raises(ValueError, match="requires causal"):
        tf.flash_attention_reference(q, k, v, window=8)
    with pytest.raises(ValueError, match="repeat_kv"):
        tf.flash_attention(q, k[:, :, :2], v[:, :, :2], causal=True)


def test_cpu_tensors_take_the_plain_path():
    q, k, v = (torch.from_numpy(a) for a in tf.parity_inputs())
    fn = tf.flash_attention_fwd
    launches, plain = fn.launches, fn.plain_calls
    out = tf.flash_attention(q, k, v, causal=True)
    assert fn.launches == launches and fn.plain_calls == plain + 1
    assert torch.equal(out, tf.flash_attention_reference(q, k, v,
                                                         causal=True)[0])
    assert fn in kernels.WRAPPERS
