"""The port's KV quantization (tpu_engine_torch.ops.quant) against the JAX
package's ops/quant.py on the CPU: on the same numpy-seeded f32 inputs
the int8 bytes and the f32 scales are bit-equal, and dequantization is
bit-equal in f32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.ops import quant as jq
from tpu_engine_torch.ops import quant as tq


def _inputs(seed, shape, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[..., 0, :] = 0.0                      # all-zero vectors: scale 1.0
    # Values at exact rounding ties for a scale of 1/127 * amax = 1.
    x[..., 1, :] = np.linspace(-127, 127, shape[-1]).round() + 0.5
    x[..., 1, 0] = 127.0
    return x


@pytest.mark.parametrize("shape,scale", [((3, 4, 2, 8), 5.0),
                                         ((2, 16, 4, 64), 1.0),
                                         ((1, 5, 3, 32), 1e-3)])
def test_quantize_kv_bit_equal_jax(shape, scale):
    x = _inputs(sum(shape), shape, scale)
    jqv, js = jq.quantize_kv(jnp.asarray(x))
    tqv, ts = tq.quantize_kv(torch.from_numpy(x))
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(ts.numpy()[..., 0] == 1.0)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_dequantize_kv_bit_equal_jax(dtype, jdtype):
    x = _inputs(7, (2, 16, 4, 64), 3.0)
    qv, s = jq.quantize_kv(jnp.asarray(x))
    want = np.asarray(jq.dequantize_kv(qv, s, jdtype).astype(jnp.float32))
    got = tq.dequantize_kv(torch.from_numpy(np.array(qv)),
                           torch.from_numpy(np.array(s)), dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
