"""An integer port of the part of ``jax.random`` (jax 0.9.0, threefry2x32
keys, ``jax_threefry_partitionable`` on) that seeded sampling uses:
``PRNGKey(seed)``, ``fold_in(key, data)``, the partitionable
``random_bits`` of a (V,) shape, ``_uniform`` and the low-resolution
``_gumbel`` that ``jax.random.categorical`` draws by default, the public
``jax.random.uniform`` on [0, 1) and ``jax.random.categorical``.

Keys are (..., 2) int64 tensors holding uint32 words; every word op masks
to 32 bits, so the same code runs on the CPU and on CUDA and gives the
bits ``jax.random`` gives. Functions are vectorised over leading key
dimensions: one call serves every sampled row of a batch.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY_F32 = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); all int64 tensors of uint32 values that broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` for integer seeds (any shape): the key words
    are the seed's high and low 32 bits."""
    seed = seed.to(torch.int64)
    return torch.stack([(seed >> 32) & _MASK, seed & _MASK], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, data as uint32)
    under ``key``. key (..., 2), data (...) integers."""
    data = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``random_bits`` of shape (..., n) under keys (..., 2): the
    partitionable scheme hashes the 64-bit iota (high word 0 here, since
    n < 2**32) and xors the two output words."""
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(iota), iota)
    return b1 ^ b2


def _unit_floats(key: torch.Tensor, n: int) -> torch.Tensor:
    """23 random mantissa bits under the exponent of 1.0, minus 1.0."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random._uniform`` on [tiny, 1) in float32: the unit floats,
    scaled and clamped as JAX does."""
    floats = _unit_floats(key, n)
    tiny = torch.tensor(_TINY_F32, dtype=torch.float32, device=key.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=key.device) - tiny
    return torch.maximum(tiny, floats * span + tiny)


def uniform01(key: torch.Tensor, n: int) -> torch.Tensor:
    """The public ``jax.random.uniform(key, (n,))`` (minval 0, maxval 1):
    the unit floats of ``uniform``, floored at 0 and not at ``tiny``. Bit
    for bit JAX's; ``n`` = 1 gives the scalar ``uniform(key, ())`` (the
    partitionable bits of shape () hash the counter 0, as those of shape
    (1,) do)."""
    return torch.clamp(_unit_floats(key, n), min=0.0)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random._gumbel`` in its default ("low") mode: -log(-log(u)) of
    JAX's float32 uniform draws, returned in float32.

    The two logs are evaluated in float64 and the result is rounded once to
    float32. In float32, torch's ``log`` and XLA's are each off by up to an
    ulp, and the two roundings add up: some draws then differ from JAX's by
    more than one ulp. Evaluated in float64, the only float32 rounding left
    is the final one, so the noise agrees with JAX's to within an ulp (XLA's
    own float32 error), not bit for bit."""
    u = uniform(key, n).double()
    return (-torch.log(-torch.log(u))).float()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of logits plus ``gumbel`` noise. key (..., 2), logits (..., V)
    float32; returns (...) int64. The noise agrees with JAX's to about an
    ulp (``gumbel``), so a draw agrees with JAX's wherever the perturbed
    top two differ by more than that."""
    return torch.argmax(logits + gumbel(key, logits.shape[-1]), dim=-1)
