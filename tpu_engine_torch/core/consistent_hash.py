"""Consistent-hash routing ring (the port's copy of
``tpu_engine/core/consistent_hash.py``): 32-bit FNV-1a over the virtual
node labels ``"{node}#{i}"`` (150 per node by default, times the node's
weight), a key's node the first vnode at or after its hash with
wraparound, a hash collision overwriting the earlier vnode, and the
distinct nodes in ring order (the gateway's failover order)."""

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
    """Hash ring mapping request keys to node names (thread-safe). A node
    of weight w holds w x ``virtual_nodes`` vnodes (the topology-aware
    gateway weights a lane by its devices); weight 1 is the reference
    ring, label for label."""

    DEFAULT_VIRTUAL_NODES = 150

    def __init__(self, virtual_nodes: int = DEFAULT_VIRTUAL_NODES):
        self._virtual_nodes = int(virtual_nodes)
        self._ring: Dict[int, str] = {}
        self._sorted_hashes: List[int] = []
        # Per-node vnode weight (absent: not a member).
        self._weights: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def virtual_nodes(self) -> int:
        return self._virtual_nodes

    def add_node(self, node: str, weight: int = 1) -> None:
        """Insert ``weight * virtual_nodes`` vnodes ``node#i``; re-adding
        a member with another weight resizes its vnode set in place."""
        weight = max(1, int(weight))
        with self._lock:
            self._resize_locked(node, self._weights.get(node, 0), weight)

    def reweight_node(self, node: str, weight: int) -> bool:
        """Resize a member's vnode set to ``weight``, the membership check
        and the resize under one lock, so a concurrent ``remove_node``
        cannot be undone by it. False (ring untouched) for a
        non-member."""
        weight = max(1, int(weight))
        with self._lock:
            prev = self._weights.get(node)
            if prev is None:
                return False
            self._resize_locked(node, prev, weight)
            return True

    def _resize_locked(self, node: str, prev: int, weight: int) -> None:
        """Grow or shrink ``node``'s labels from ``prev`` to ``weight`` x
        virtual_nodes (caller holds the lock)."""
        if weight < prev:
            self._drop_labels(node, range(weight * self._virtual_nodes,
                                          prev * self._virtual_nodes))
        for i in range(prev * self._virtual_nodes,
                       weight * self._virtual_nodes):
            h = fnv1a_32(f"{node}#{i}")
            if h not in self._ring:
                bisect.insort(self._sorted_hashes, h)
            self._ring[h] = node
        self._weights[node] = weight

    def _drop_labels(self, node: str, label_range) -> None:
        """Erase the node's vnodes of these label indices (those a later
        node's collision took stay with that node; caller holds the
        lock)."""
        for i in label_range:
            h = fnv1a_32(f"{node}#{i}")
            if self._ring.get(h) == node:
                del self._ring[h]
                idx = bisect.bisect_left(self._sorted_hashes, h)
                if idx < len(self._sorted_hashes) \
                        and self._sorted_hashes[idx] == h:
                    self._sorted_hashes.pop(idx)

    def node_weight(self, node: str) -> int:
        """The node's vnode weight, 0 for a non-member."""
        with self._lock:
            return self._weights.get(node, 0)

    def remove_node(self, node: str) -> None:
        """Erase the node's vnodes."""
        with self._lock:
            weight = self._weights.pop(node, 1)
            self._drop_labels(node, range(weight * self._virtual_nodes))

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
