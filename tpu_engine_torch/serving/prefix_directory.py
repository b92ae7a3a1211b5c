"""The fleet prefix directory (the port's copy of ``PrefixDirectory`` in
``tpu_engine/serving/prefix_directory.py``): a bounded fingerprint ->
``{lane, blocks, generation}`` map the gateway keeps beside its ring,
naming the lane whose radix tree holds the deepest known KV chain of each
block-aligned prompt fingerprint.

It is a hint cache: the fetching lane verifies the chain's checksum and
geometry before it trusts a byte, and every miss, stale entry or refusal
falls back to local prefill. A lane's entries die by its generation
stamp: ``invalidate_lane`` (removal, eject, restore) bumps it, drops the
lane's entries at once, and any entry that escapes is dropped by
``lookup``. The caller holds the gateway's lock; the directory has no
lock or thread of its own.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional


class PrefixDirectory:
    """LRU-bounded fingerprint -> owner map with per-lane generations."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        # fp -> {"lane", "blocks", "generation"}; insertion order is the
        # LRU order (record and lookup move an entry to the end).
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._lane_gen: dict = {}

    def lane_generation(self, lane: str) -> int:
        return self._lane_gen.get(lane, 0)

    def record(self, fp: str, lane: str, blocks: int) -> int:
        """Record (or refresh) the owner of ``fp``. A live entry naming a
        deeper chain on another lane is kept (LRU-touched): the directory
        tracks the best known owner. Returns the entries the LRU bound
        evicted."""
        blocks = max(0, int(blocks))
        gen = self._lane_gen.setdefault(lane, 0)
        cur = self._entries.get(fp)
        if cur is not None:
            stale = self._lane_gen.get(cur["lane"], -1) != cur["generation"]
            if (not stale and cur["lane"] != lane
                    and cur["blocks"] > blocks):
                self._entries.move_to_end(fp)
                return 0
        self._entries[fp] = {"lane": lane, "blocks": blocks,
                             "generation": gen}
        self._entries.move_to_end(fp)
        evicted = 0
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            evicted += 1
        return evicted

    def lookup(self, fp: str) -> Optional[dict]:
        """A copy of the live entry of ``fp`` (LRU-touched), or None; a
        stale entry (its lane's generation moved) is dropped."""
        e = self._entries.get(fp)
        if e is None:
            return None
        if self._lane_gen.get(e["lane"], -1) != e["generation"]:
            del self._entries[fp]
            return None
        self._entries.move_to_end(fp)
        return dict(e)

    def invalidate_lane(self, lane: str) -> int:
        """Void every entry naming ``lane`` and bump its generation;
        returns the entries dropped."""
        self._lane_gen[lane] = self._lane_gen.get(lane, 0) + 1
        dead = [fp for fp, e in self._entries.items() if e["lane"] == lane]
        for fp in dead:
            del self._entries[fp]
        return len(dead)

    def stats(self) -> dict:
        per_lane: dict = {}
        for e in self._entries.values():
            per_lane[e["lane"]] = per_lane.get(e["lane"], 0) + 1
        return {"entries": len(self._entries), "capacity": self.capacity,
                "lanes": per_lane}
