"""The port's tensor ops (tpu_engine_torch.ops.nn / ops.attention) against
the JAX package's on the same numpy-seeded f32 inputs. Tolerance 1e-5:
both compute in f32 on the CPU and differ only in summation order and the
last bits of transcendental functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.ops import attention as jattn
from tpu_engine.ops import nn as jnn
from tpu_engine_torch.ops import attention as tattn
from tpu_engine_torch.ops import nn as tnn

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 8)])
def test_dense_matches_jax(shape):
    rng = _rng(1)
    x = rng.standard_normal(shape, np.float32)
    p = {"kernel": rng.standard_normal((8, 6), np.float32),
         "bias": rng.standard_normal((6,), np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out = tnn.dense(tp, torch.from_numpy(x), dtype=torch.float32)
    assert out.dtype == torch.float32
    _close(jnn.dense({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), dtype=jnp.float32), out)


def test_dense_bf16_returns_f32_before_bias():
    """In bf16 the inputs round to bf16 but the product and the bias add
    stay f32, as in the JAX dense (no rounding of the output)."""
    rng = _rng(2)
    x = rng.standard_normal((4, 16), np.float32)
    p = {"kernel": rng.standard_normal((16, 8), np.float32),
         "bias": rng.standard_normal((8,), np.float32)}
    out = tnn.dense({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    _close(jnn.dense({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), dtype=jnp.bfloat16), out)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms_match_jax(norm):
    rng = _rng(3)
    x = rng.standard_normal((2, 5, 16), np.float32) * 3 + 1
    p = {"scale": rng.standard_normal((16,), np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal((16,), np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(getattr(jnn, norm)(jp, jnp.asarray(x), eps=1e-5),
           getattr(tnn, norm)(tp, torch.from_numpy(x), eps=1e-5))


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(approximate):
    x = _rng(4).standard_normal((64,), np.float32) * 4
    import jax

    _close(jax.nn.gelu(jnp.asarray(x), approximate=approximate),
           tnn.gelu(torch.from_numpy(x), approximate=approximate))


def test_silu_and_embedding_match_jax():
    rng = _rng(5)
    x = rng.standard_normal((32,), np.float32) * 4
    _close(jnn.silu(jnp.asarray(x)), tnn.silu(torch.from_numpy(x)))
    table = rng.standard_normal((10, 4), np.float32)
    ids = np.array([[0, 3, 9], [9, 9, 1]], np.int32)
    _close(jnn.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids)),
           tnn.embedding({"table": torch.from_numpy(table)},
                         torch.from_numpy(ids).long()))


@pytest.mark.parametrize("pos_rank", [1, 2])
def test_rope_matches_jax(pos_rank):
    rng = _rng(6)
    x = rng.standard_normal((2, 5, 3, 8), np.float32)
    pos = (np.arange(5, dtype=np.int32) + 7 if pos_rank == 1
           else rng.integers(-1, 300, (2, 5)).astype(np.int32))
    _close(jattn.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           tattn.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0))


def test_split_heads_and_repeat_kv_match_jax():
    x = _rng(7).standard_normal((2, 3, 12), np.float32)
    s = tattn._split_heads(torch.from_numpy(x), 3)
    _close(jattn._split_heads(jnp.asarray(x), 3), s)
    _close(jattn.repeat_kv(jattn._split_heads(jnp.asarray(x), 3), 2),
           tattn.repeat_kv(s, 2))


@pytest.mark.parametrize("case", ["grouped-2d-mask", "grouped-3d-mask",
                                  "mha-causal", "grouped-causal-window"])
def test_dot_product_attention_matches_jax(case):
    rng = _rng(8)
    b, sq, sk, d = 2, 4, 9, 8
    h, h_kv = (4, 4) if case == "mha-causal" else (8, 2)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, h_kv, d), np.float32)
    v = rng.standard_normal((b, sk, h_kv, d), np.float32)
    kw = {}
    if case == "grouped-2d-mask":
        kw["mask"] = (rng.random((b, sk)) > 0.3).astype(np.int32)
        kw["mask"][1] = 0          # a row with no valid key gives 0
    elif case == "grouped-3d-mask":
        kw["mask"] = (rng.random((b, sq, sk)) > 0.3).astype(np.int32)
        kw["mask"][0, 2] = 0
    else:
        kw["causal"] = True
        kw["base_pos"] = 5
        if case == "grouped-causal-window":
            kw["window"] = 3
    jkw = {k2: (jnp.asarray(v2) if isinstance(v2, np.ndarray) else v2)
           for k2, v2 in kw.items()}
    tkw = {k2: (torch.from_numpy(v2) if isinstance(v2, np.ndarray) else v2)
           for k2, v2 in kw.items()}
    ref = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **jkw)
    out = tattn.dot_product_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), **tkw)
    _close(ref, out)
    if case == "grouped-2d-mask":
        assert float(out[1].abs().max()) == 0.0
