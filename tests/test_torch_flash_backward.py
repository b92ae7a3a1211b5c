"""The port's flash attention gradients (tpu_engine_torch.ops.flash: the
``FlashAttention`` autograd Function, with its plain kernels on the CPU)
against the JAX package's, on the same numpy-seeded inputs: ``jax.grad``
through its ``flash_attention`` run by the Pallas interpreter (its
``custom_vjp`` and the two backward kernels), and ``jax.grad`` through its
XLA ``dot_product_attention``. The cases are tests/test_flash_backward.py's
(causal at two shapes with block_q 64 and block_k 128 on the JAX side, a
padding mask, non-causal, fully masked rows), tests/test_sliding_window.py's
window case and bf16. Also: ``flash_attention_bwd_reference`` against a
float64 numpy formula, the counts (no backward call under no_grad), and the
wrapper's rule for the kernels' 16-byte row copies (a view whose rows are
not 16-byte aligned is copied, any other is passed as it is).

Tolerances, as max|got - want| / max|want| per gradient: 1e-4 in f32
(differently ordered f32 sums), 2e-2 in bf16 (p and ds are rounded to bf16
at the kernels' points, against values that differ in the last bits)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.ops.attention import dot_product_attention as jdpa
from tpu_engine.ops.flash import flash_attention as jflash
from tpu_engine_torch.ops import flash as tf

F32_TOL = 1e-4
BF16_TOL = 2e-2

# name -> (shape (B, S, H, D), causal, mask kind, window, JAX blocks)
CASES = {
    "causal-2x64x2x32": ((2, 64, 2, 32), True, None, None, (64, 128)),
    "causal-1x200x4x64": ((1, 200, 4, 64), True, None, None, (64, 128)),
    "padding-mask": ((2, 96, 2, 32), True, "random", None, None),
    "non-causal": ((2, 48, 2, 32), False, None, None, None),
    "fully-masked-row": ((2, 32, 2, 16), True, "row-1-dead", None, None),
    "window-9": ((1, 96, 2, 16), True, None, 9, None),
}


def _inputs(case, seed):
    shape, causal, mask_kind, window, blocks = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape, np.float32) for _ in range(3))
    b, s = shape[:2]
    mask = None
    if mask_kind == "random":
        mask = (rng.uniform(size=(b, s)) > 0.3).astype(np.int32)
        mask[:, :2] = 1
    elif mask_kind == "row-1-dead":
        mask = np.zeros((b, s), np.int32)
        mask[0] = 1
    # Non-uniform output weights, so dq, dk and dv are all exercised.
    w = np.sin(np.arange(q.size, dtype=np.float32).reshape(shape) * 0.1)
    return q, k, v, mask, w, dict(causal=causal, window=window), blocks


def _jax_grads(attn, q, k, v, mask, w, kw, dtype):
    def loss(q, k, v):
        out = attn(q, k, v, mask=None if mask is None else jnp.asarray(mask),
                   **kw)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))
    g = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(x, np.float32) for x in g]


def _port_grads(q, k, v, mask, w, kw, dtype):
    t = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = tf.flash_attention(*t, mask=None if mask is None
                             else torch.from_numpy(mask), **kw)
    assert out.grad_fn is not None
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [x.grad.float().numpy() for x in t]


def _assert_close(got, want, tol):
    for name, g, w in zip("qkv", got, want):
        err = np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-6)
        assert err <= tol, f"d{name}: {err}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_interpreted_flash(case):
    q, k, v, mask, w, kw, blocks = _inputs(case, seed=len(case))
    attn = jflash if blocks is None else functools.partial(
        jflash, block_q=blocks[0], block_k=blocks[1])
    want = _jax_grads(functools.partial(attn, interpret=True), q, k, v, mask,
                      w, kw, jnp.float32)
    got = _port_grads(q, k, v, mask, w, kw, torch.float32)
    _assert_close(got, want, F32_TOL)
    if case == "fully-masked-row":
        dq, dk, dv = got
        assert np.isfinite(dq).all() and np.isfinite(dk).all()
        assert np.abs(dk[1]).max() == 0.0 and np.abs(dv[1]).max() == 0.0
        assert np.abs(dq[1]).max() == 0.0


@pytest.mark.parametrize("case", sorted(set(CASES) - {"fully-masked-row"}))
def test_grads_match_jax_xla_attention(case):
    """The XLA reference: ``dot_product_attention`` (a fully masked row's
    softmax is NaN before its nan_to_num, so that case is held against the
    interpreted flash only)."""
    q, k, v, mask, w, kw, _ = _inputs(case, seed=len(case))
    want = _jax_grads(jdpa, q, k, v, mask, w, kw, jnp.float32)
    got = _port_grads(q, k, v, mask, w, kw, torch.float32)
    _assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("ref", ["interpreted-flash", "xla"])
def test_bf16_grads_match_jax(ref):
    q, k, v, mask, w, kw, _ = _inputs("causal-2x64x2x32", seed=11)
    attn = (functools.partial(jflash, interpret=True)
            if ref == "interpreted-flash" else jdpa)
    want = _jax_grads(attn, q, k, v, mask, w, kw, jnp.bfloat16)
    got = _port_grads(q, k, v, mask, w, kw, torch.bfloat16)
    _assert_close(got, want, BF16_TOL)


def _numpy_backward(q, k, v, do, causal, mask):
    """dq, dk, dv of softmax attention in float64 by the textbook formulas."""
    q, k, v, do = (a.astype(np.float64) for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    sq, sk = q.shape[1], k.shape[1]
    keep = np.ones((1, 1, sq, sk), bool)
    if causal:
        keep = keep & (np.arange(sq)[:, None] >= np.arange(sk)[None, :])
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", p, v)
    dp = np.einsum("bqhd,bkhd->bhqk", do, v)
    delta = np.einsum("bqhd,bqhd->bhq", do, out)[..., None]
    ds = p * (dp - delta)
    return (np.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            np.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            np.einsum("bhqk,bqhd->bkhd", p, do))


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_bwd_reference_matches_numpy_formula(causal, masked):
    q, k, v = tf.parity_inputs(sq=48, sk=48, n_heads=2, d_head=32, seed=3)
    rng = np.random.default_rng(4)
    do = rng.standard_normal(q.shape, np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 48), np.int32)
        mask[1, 30:] = 0
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = tf.flash_attention_reference(*t, causal=causal, mask=tm)
    got = tf.flash_attention_bwd_reference(*t, tm, out, lse,
                                           torch.from_numpy(do),
                                           causal=causal)
    want = _numpy_backward(q, k, v, do, causal, mask)
    _assert_close([g.numpy() for g in got], want, 1e-5)


def _counts():
    return {fn.__name__: (fn.launches, fn.plain_calls)
            for fn in (tf.flash_attention_fwd, tf.flash_attention_bwd_dq,
                       tf.flash_attention_bwd_dkv)}


def _calls_since(before):
    return {k: v[1] - before[k][1] for k, v in _counts().items()}


def test_no_grad_is_one_forward_call():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in tf.parity_inputs())
    before = _counts()
    with torch.no_grad():
        out = tf.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    assert _calls_since(before) == {"flash_attention_fwd": 1,
                                    "flash_attention_bwd_dq": 0,
                                    "flash_attention_bwd_dkv": 0}
    # No input requiring grad: the same one forward call.
    before = _counts()
    out = tf.flash_attention(*(t.detach() for t in (q, k, v)), causal=True)
    assert out.grad_fn is None
    assert _calls_since(before)["flash_attention_fwd"] == 1


def test_backward_calls_each_kernel_once():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in tf.parity_inputs())
    before = _counts()
    out = tf.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert _calls_since(before) == {"flash_attention_fwd": 1,
                                    "flash_attention_bwd_dq": 1,
                                    "flash_attention_bwd_dkv": 1}


# (dtype, view) -> whether its rows are 16-byte aligned: the backward
# kernels copy 16-byte rows, so the wrapper copies a tensor that is not.
VIEWS = [(torch.float32, "contiguous", True),
         (torch.bfloat16, "contiguous", True),
         (torch.bfloat16, "transposed", True),
         (torch.float32, "odd-stride", False),
         (torch.bfloat16, "odd-stride", False),
         (torch.bfloat16, "offset-4", False),
         (torch.float32, "offset-4", True)]


@pytest.mark.parametrize("dtype,view,aligned", VIEWS)
def test_bwd_operand_copies_only_misaligned_rows(dtype, view, aligned):
    b, s, h, d = 2, 24, 3, 16
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, s, h, d), np.float32)).to(dtype)
    if view == "transposed":
        t = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif view == "odd-stride":
        t = torch.zeros((b, s, h, d + 1), dtype=dtype)[..., 1:]
        t.copy_(x)
    elif view == "offset-4":
        flat = torch.zeros(x.numel() + 4, dtype=dtype)
        t = flat[4:].view(b, s, h, d)
        t.copy_(x)
    else:
        t = x
    assert tf._rows_aligned(t) == aligned
    got = tf._aligned(t)
    assert torch.equal(got, x)
    assert (got.data_ptr() == t.data_ptr()) == aligned
    assert tf._rows_aligned(got)
