"""The port's LRUCache (tpu_engine_torch.core.lru_cache) against the JAX
package's over seeded random get/put/clear sequences: the same hits,
misses, sizes, hit rates, values and eviction order."""

import numpy as np
import pytest

from tpu_engine.core.lru_cache import LRUCache as JaxLRU
from tpu_engine.core.lru_cache import compute_hit_rate as jax_rate
from tpu_engine_torch.core.lru_cache import LRUCache, compute_hit_rate


@pytest.mark.parametrize("seed,capacity", [(0, 1), (1, 4), (2, 16),
                                           (3, 64)])
def test_random_sequence_matches_jax(seed, capacity):
    rng = np.random.default_rng(seed)
    ours, ref = LRUCache(capacity), JaxLRU(capacity)
    keys = [bytes([k]) * 4 for k in range(3 * capacity + 2)]
    for step in range(2000):
        op = rng.random()
        key = keys[int(rng.integers(len(keys)))]
        if op < 0.5:
            assert ours.get(key) == ref.get(key)
        elif op < 0.995:
            ours.put(key, step)
            ref.put(key, step)
        else:
            ours.clear()
            ref.clear()
        assert ours.size() == ref.size() <= capacity
        assert (ours.hits, ours.misses) == (ref.hits, ref.misses)
        assert ours.hit_rate() == ref.hit_rate()
    # Eviction order: the survivors are the same keys, least recent first.
    assert list(ours._map.items()) == list(ref._map.items())


def test_eviction_is_least_recently_used():
    c = LRUCache(2)
    c.put(b"a", 1)
    c.put(b"b", 2)
    assert c.get(b"a") == 1  # a is now the most recent
    c.put(b"c", 3)           # evicts b
    assert c.get(b"b") is None and c.get(b"a") == 1 and c.get(b"c") == 3
    assert c.capacity == 2


@pytest.mark.parametrize("hits,misses", [(0, 0), (3, 1), (0, 5), (7, 0)])
def test_hit_rate_matches_jax(hits, misses):
    assert compute_hit_rate(hits, misses) == jax_rate(hits, misses)


def test_capacity_must_be_positive():
    for cls in (LRUCache, JaxLRU):
        with pytest.raises(ValueError, match="capacity must be positive"):
            cls(0)
