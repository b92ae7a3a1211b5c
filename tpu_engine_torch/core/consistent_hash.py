"""Consistent-hash routing ring (the port's copy of
``tpu_engine/core/consistent_hash.py``): 32-bit FNV-1a over the virtual
node labels ``"{node}#{i}"`` (150 per node by default), a key's node the
first vnode at or after its hash with wraparound, a hash collision
overwriting the earlier vnode, and the distinct nodes in ring order (the
gateway's failover order)."""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Sequence

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MASK32 = 0xFFFFFFFF


def fnv1a_32(key: str) -> int:
    """32-bit FNV-1a of ``key``'s UTF-8 bytes."""
    h = _FNV_OFFSET
    for b in key.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _MASK32
    return h


class ConsistentHash:
    """Hash ring mapping request keys to node names (thread-safe)."""

    DEFAULT_VIRTUAL_NODES = 150

    def __init__(self, virtual_nodes: int = DEFAULT_VIRTUAL_NODES):
        self._virtual_nodes = int(virtual_nodes)
        self._ring: Dict[int, str] = {}
        self._sorted_hashes: List[int] = []
        self._lock = threading.Lock()

    @property
    def virtual_nodes(self) -> int:
        return self._virtual_nodes

    def add_node(self, node: str) -> None:
        with self._lock:
            for i in range(self._virtual_nodes):
                h = fnv1a_32(f"{node}#{i}")
                if h not in self._ring:
                    bisect.insort(self._sorted_hashes, h)
                self._ring[h] = node

    def remove_node(self, node: str) -> None:
        """Erase the node's vnodes (those a later node's collision took
        stay with that node)."""
        with self._lock:
            for i in range(self._virtual_nodes):
                h = fnv1a_32(f"{node}#{i}")
                if self._ring.get(h) == node:
                    del self._ring[h]
                    idx = bisect.bisect_left(self._sorted_hashes, h)
                    self._sorted_hashes.pop(idx)

    def get_node(self, key: str) -> str:
        with self._lock:
            if not self._sorted_hashes:
                raise RuntimeError("hash ring is empty")
            idx = bisect.bisect_left(self._sorted_hashes, fnv1a_32(key))
            if idx == len(self._sorted_hashes):
                idx = 0
            return self._ring[self._sorted_hashes[idx]]

    def get_all_nodes(self) -> List[str]:
        """Distinct nodes by their first vnode in ascending hash order."""
        with self._lock:
            seen = set()
            out: List[str] = []
            for h in self._sorted_hashes:
                n = self._ring[h]
                if n not in seen:
                    seen.add(n)
                    out.append(n)
            return out

    def size(self) -> int:
        """Number of distinct nodes."""
        with self._lock:
            return len(set(self._ring.values()))

    def get_distribution(self, keys: Sequence[str]) -> Dict[str, int]:
        """Keys per node over ``keys``."""
        counts: Dict[str, int] = {}
        for k in keys:
            n = self.get_node(k)
            counts[n] = counts.get(n, 0) + 1
        return counts
