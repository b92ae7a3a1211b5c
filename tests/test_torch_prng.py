"""The port's threefry (tpu_engine_torch.utils.prng) and seeded sampling
(runtime.generator._sample) against jax.random and the JAX package's
_sample, on the CPU: keys and random bits bit-equal for a sweep of
(seed, position) pairs, Gumbel noise within 1 ulp of max(|g|, 1) but for
at most one draw in 100,000, which stays within 2 ulps (neither
backend's float32 log is correctly rounded), and sampled tokens equal on
random logits with every filter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.runtime.generator import _sample as jax_sample
from tpu_engine_torch.runtime.generator import _sample
from tpu_engine_torch.utils import prng


def _pairs(seed, n=64):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    seeds[:4] = [0, 1, 7, 2**31 - 1]
    pos = rng.integers(0, 4096, n).astype(np.int32)
    pos[:4] = [0, 1, 2047, 4095]
    return seeds, pos


def _keys(seeds, pos):
    jkeys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s),
                                                     p))(seeds, pos)
    tkeys = prng.fold_in(prng.prng_key(torch.from_numpy(seeds)),
                         torch.from_numpy(pos))
    return jkeys, tkeys


@pytest.mark.parametrize("sweep", [0, 1, 2])
def test_keys_and_bits_equal_jax(sweep):
    seeds, pos = _pairs(sweep)
    jkeys, tkeys = _keys(seeds, pos)
    np.testing.assert_array_equal(np.asarray(jkeys).astype(np.int64),
                                  tkeys.numpy())
    for n in (1, 255, 256, 1000):
        jbits = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(
            jkeys)
        np.testing.assert_array_equal(np.asarray(jbits).astype(np.int64),
                                      prng.random_bits(tkeys, n).numpy())


def test_uniform_equal_and_gumbel_within_two_ulps():
    seeds, pos = _pairs(3, n=128)
    jkeys, tkeys = _keys(seeds, pos)
    n = 2048
    tiny = jnp.finfo(jnp.float32).tiny
    ju = jax.vmap(lambda k: jax.random.uniform(k, (n,), jnp.float32, tiny,
                                               1.0))(jkeys)
    np.testing.assert_array_equal(np.asarray(ju),
                                  prng.uniform(tkeys, n).numpy())
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,),
                                                         jnp.float32))(jkeys))
    tg = prng.gumbel(tkeys, n).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    err = np.abs(jg - tg)
    assert np.all(err <= 2 * ulp)
    assert np.count_nonzero(err > ulp) <= 1e-5 * err.size


@pytest.mark.parametrize("trial", range(4))
def test_sample_equals_jax_sample(trial):
    rng = np.random.default_rng(10 + trial)
    b, v = 48, 256
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    seeds, pos = _pairs(20 + trial, n=b)
    temps = rng.choice([0.0, 0.7, 1.0, 1.3], b).astype(np.float32)
    top_p = rng.choice([1.0, 0.9], b).astype(np.float32)
    top_k = rng.choice([0, 5], b).astype(np.int32)
    min_p = rng.choice([0.0, 0.05], b).astype(np.float32)
    want = jax_sample(*(jnp.asarray(a) for a in (logits, seeds, pos, temps,
                                                 top_p, top_k, min_p)))
    got = _sample(torch.from_numpy(logits), seeds, pos, temps, top_p, top_k,
                  min_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Positions may also come as a tensor (the decode chunk's).
    again = _sample(torch.from_numpy(logits), torch.from_numpy(seeds),
                    torch.from_numpy(pos), temps, top_p, top_k, min_p)
    assert torch.equal(again, got)
