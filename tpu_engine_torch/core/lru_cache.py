"""Thread-safe LRU result cache: the port's copy of ``LRUCache`` and
``compute_hit_rate`` from ``tpu_engine/core/lru_cache.py`` (pure Python;
the native byte-blob cache, whose entries the combined server's C++ front
serves, is ``core.native.NativeLRUCache``).

``get``/``put``/``clear``, capacity-bounded eviction from the LRU end, and
hit/miss counters surfaced as ``cache_hit_rate`` in the worker's
``/health``. Keys are opaque ``bytes`` (the worker keys by the exact
serialized input); statistics reads are lock-free snapshots (ints are
atomic under the GIL).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional


class LRUCache:
    """Mutex-guarded LRU map with hit/miss accounting.

    Mirrors ``LRUCache<Key,Value>`` semantics: ``get`` promotes to MRU
    (reference ``lru_cache.h:18-28``), ``put`` updates-and-promotes or
    inserts-and-evicts (``:29-48``).
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._capacity = int(capacity)
        self._map: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            try:
                value = self._map[key]
            except KeyError:
                self._misses += 1
                return None
            self._map.move_to_end(key)
            self._hits += 1
            return value

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            if key in self._map:
                self._map[key] = value
                self._map.move_to_end(key)
                return
            if len(self._map) >= self._capacity:
                self._map.popitem(last=False)
            self._map[key] = value

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._hits = 0
            self._misses = 0

    def size(self) -> int:
        return len(self._map)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def hits(self) -> int:
        return self._hits

    @property
    def misses(self) -> int:
        return self._misses

    def hit_rate(self) -> float:
        """Fraction of ``get`` calls served from cache (0.0 when untouched).

        Matches ``LRUCache::getHitRate`` (reference ``lru_cache.h:66-71``).
        """
        return compute_hit_rate(self._hits, self._misses)


def compute_hit_rate(hits: int, misses: int) -> float:
    """hits / (hits + misses), 0.0 when both are 0."""
    total = hits + misses
    return (hits / total) if total else 0.0
