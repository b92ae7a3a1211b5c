"""Paged KV cache: a static block pool, page tables and a radix tree of
shared prompt prefixes (counterpart of ``tpu_engine/runtime/kv_blocks.py``).

- One static tensor per K/V of shape (L, num_blocks, block_size, H_kv, D)
  on the pool's device, allocated once and written in place by the mixed
  step. Block 0 is the reserved null block: unallocated page-table entries
  point at it, padding writes land in it, and it is never attended.
- Host bookkeeping (free list, per-block refcounts, the radix tree) under
  one lock. The pool tensors themselves are read and written only by the
  scheduler's decode thread, so no device work needs the lock.
- Radix tree over FULL token blocks; refcounts with copy-on-write
  (``ensure_writable``); LRU eviction of tree-only leaves when allocation
  runs dry.
- Quantized block payloads (``quantize="int8"``): the pool tensors hold
  int8, with one f32 scale per (layer, block slot, kv-head) in ``scales``
  (a KVCache of (L, NB, bs, H_kv) tensors, ones when fresh, so unwritten
  slots dequantize to exact zeros). A token quantizes once, at its block
  write; copy-on-write moves payload and scales verbatim.

The bookkeeping is the JAX package's, line for line, so both pools hand
out the same block ids for the same sequence of calls. Not ported here:
the host tier and chain export/import, which refuse at construction.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_engine_torch.models.transformer import KVCache, TransformerConfig
from tpu_engine_torch.ops.quant import dequantize_kv, quantize_kv


def dense_block_bytes(cfg: TransformerConfig, block_size: int,
                      dtype: torch.dtype) -> int:
    """Device bytes one K+V block costs at a full-precision dtype."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return int(2 * cfg.n_layers * block_size * cfg.kv_heads * cfg.d_head
               * itemsize)


def quant_block_bytes(cfg: TransformerConfig, block_size: int) -> int:
    """Bytes of one quantized block: int8 K+V payload plus the f32 scale
    per (layer, slot, kv-head) vector, 2 * L * bs * H_kv * (D + 4)."""
    slot_heads = cfg.n_layers * block_size * cfg.kv_heads
    return int(2 * slot_heads * (cfg.d_head + 4))


class PoolExhausted(RuntimeError):
    """An allocation cannot be satisfied even after evicting every
    evictable radix leaf; callers defer the admission or complete the
    starved row early — never treat it as a device failure."""


class _RadixNode:
    __slots__ = ("children", "parent", "key", "block_id", "last_used")

    def __init__(self, parent: Optional["_RadixNode"], key, block_id: int):
        self.children: Dict[tuple, _RadixNode] = {}
        self.parent = parent
        self.key = key            # the block's token tuple (len block_size)
        self.block_id = block_id  # -1: root
        self.last_used = 0


class RadixTree:
    """Prefix index over FULL token blocks. One node per (path, block of
    tokens); the node's pool block holds exactly those tokens' KV at
    logical columns [depth*bs, (depth+1)*bs). All methods assume the
    owning pool's lock is held."""

    def __init__(self, pool: "BlockPool"):
        self._pool = pool
        self.root = _RadixNode(None, None, -1)
        self.nodes = 0
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _full_blocks(self, tokens: Sequence[int]) -> List[tuple]:
        bs = self._pool.block_size
        return [tuple(tokens[i:i + bs])
                for i in range(0, (len(tokens) // bs) * bs, bs)]

    def lookup(self, tokens: Sequence[int]) -> List[int]:
        """Longest-prefix match over full blocks. Returns the matched
        block ids in order, each retained once on behalf of the caller
        (release them when the row frees, or at once on a discarded
        admission)."""
        pool = self._pool
        pool.radix_lookups += 1
        ids: List[int] = []
        node = self.root
        stamp = self._tick()
        for key in self._full_blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = stamp
            pool.retain(child.block_id)
            ids.append(child.block_id)
            node = child
        if ids:
            pool.radix_hits += 1
        return ids

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int]) -> int:
        """Index a row's full prompt blocks; ``block_ids[j]`` holds prompt
        block j. New nodes retain their block (the tree's own reference);
        an existing node keeps its original block and the newcomer's
        duplicate stays row-private. Returns nodes added."""
        added = 0
        node = self.root
        stamp = self._tick()
        for j, key in enumerate(self._full_blocks(tokens)):
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(node, key, int(block_ids[j]))
                node.children[key] = child
                self._pool.retain(child.block_id)
                self.nodes += 1
                added += 1
            child.last_used = stamp
            node = child
        return added

    def _evictable(self) -> List[_RadixNode]:
        """Leaves whose block the tree alone references."""
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                elif self._pool.refcount(c.block_id) == 1:
                    out.append(c)
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU leaves that
        nothing but the tree references. Never touches a block a live row
        or a pinned lookup holds. Returns blocks freed."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_blocks:
                    break
                del leaf.parent.children[leaf.key]
                self._pool.release(leaf.block_id)
                self.nodes -= 1
                self._pool.evictions += 1
                freed += 1
        return freed

    def clear(self) -> None:
        """Drop every node (weight reload: cached KV is stale). Blocks
        still referenced by live rows survive until those rows free."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                stack.append(c)
                self._pool.release(c.block_id)
        self.root = _RadixNode(None, None, -1)
        self.nodes = 0


class BlockPool:
    """Device block pool + host bookkeeping for the paged KV cache."""

    def __init__(self, cfg: TransformerConfig, num_blocks: int,
                 block_size: int, dtype: torch.dtype = torch.bfloat16,
                 device="cpu", host_blocks: int = 0, quantize: str = ""):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if quantize not in ("", "int8"):
            raise ValueError(f"unsupported KV quantize mode {quantize!r} "
                             "(only 'int8')")
        if host_blocks:
            raise NotImplementedError(
                "the host KV tier is not yet ported to tpu_engine_torch")
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # `io_dtype` is the compute dtype (what gathers dequantize to);
        # `dtype` is the payload's storage dtype (int8 when quantized).
        self.quantized = quantize == "int8"
        self.io_dtype = dtype
        self.dtype = torch.int8 if self.quantized else dtype
        self.device = torch.device(device)
        self.scales: Optional[KVCache] = None
        # Guards the bookkeeping. RLock: eviction runs inside alloc.
        self.lock = threading.RLock()
        # Bumped by reset(): pins taken against an older generation are
        # void — holders compare generations instead of releasing ids.
        self.generation = 0
        self.caches = self._init_device()
        self._ref = np.zeros((self.num_blocks,), np.int32)
        self._ref[0] = 1  # null block: permanently pinned, never allocated
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self.radix = RadixTree(self)
        self.prefix_hit_tokens = 0
        self.prefilled_tokens = 0
        self.evictions = 0
        self.cow_copies = 0
        self.radix_lookups = 0
        self.radix_hits = 0

    def _init_device(self) -> KVCache:
        shape = (self.cfg.n_layers, self.num_blocks, self.block_size,
                 self.cfg.kv_heads, self.cfg.d_head)
        if self.quantized:
            self.scales = KVCache(
                torch.ones(shape[:-1], dtype=torch.float32,
                           device=self.device),
                torch.ones(shape[:-1], dtype=torch.float32,
                           device=self.device))
        return KVCache(torch.zeros(shape, dtype=self.dtype,
                                   device=self.device),
                       torch.zeros(shape, dtype=self.dtype,
                                   device=self.device))

    # -- bookkeeping (hold self.lock) -----------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block_id: int) -> int:
        return int(self._ref[block_id])

    def alloc(self, n: int) -> List[int]:
        """n fresh blocks (refcount 1 each), evicting radix leaves LRU
        when the free list runs short. Raises PoolExhausted (state
        unchanged) when even eviction cannot cover the request."""
        if n > len(self._free):
            self.radix.evict(n - len(self._free))
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free and nothing "
                f"evictable ({self.num_blocks} total)")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        return ids

    def retain(self, block_id: int) -> None:
        if self._ref[block_id] <= 0:
            raise RuntimeError(f"retain of free block {block_id}")
        self._ref[block_id] += 1

    def release(self, block_id: int) -> None:
        if block_id == 0:
            return  # null block: permanent
        if self._ref[block_id] <= 0:
            raise RuntimeError(f"double free of block {block_id}")
        self._ref[block_id] -= 1
        if self._ref[block_id] == 0:
            self._free.append(block_id)

    def release_many(self, block_ids: Sequence[int]) -> None:
        for i in block_ids:
            self.release(i)

    def release_tail(self, block_list: List[int], keep: int) -> int:
        """Trim a row's block list IN PLACE to its first ``keep`` entries,
        releasing the rest. Returns blocks released."""
        freed = 0
        while len(block_list) > max(0, int(keep)):
            self.release(block_list.pop())
            freed += 1
        return freed

    def ensure_writable(self, block_id: int) -> Tuple[int, bool]:
        """Copy-on-write: a caller about to write into ``block_id`` gets a
        private copy when anything else also references it. Returns
        (writable id, copied?); the caller swaps its page-table entry."""
        if self._ref[block_id] <= 1:
            return block_id, False
        new_id = self.alloc(1)[0]
        # Payload and (int8 pool) scales move verbatim: a bit-exact clone,
        # never a requantization.
        pairs = (self.caches, self.scales) if self.quantized \
            else (self.caches,)
        for pair in pairs:
            pair.k[:, new_id] = pair.k[:, block_id]
            pair.v[:, new_id] = pair.v[:, block_id]
        self.release(block_id)
        self.cow_copies += 1
        return new_id, True

    def reset(self) -> None:
        """Recovery after a failed device step: the pool tensors may hold
        half-written blocks, so everything is rebuilt. Pins and page
        tables taken against the old generation are void."""
        self.generation += 1
        self.caches = self._init_device()
        self._ref[:] = 0
        self._ref[0] = 1
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self.radix = RadixTree(self)

    def bytes_per_block(self) -> int:
        """Device bytes one block costs in this pool's layout: K+V payload
        at the storage dtype, plus (int8) the per-slot f32 scales."""
        if self.quantized:
            return quant_block_bytes(self.cfg, self.block_size)
        return dense_block_bytes(self.cfg, self.block_size, self.dtype)

    def dense_bytes_per_block(self) -> int:
        """What the same block would cost unquantized (at io_dtype)."""
        return dense_block_bytes(self.cfg, self.block_size, self.io_dtype)

    def stats(self) -> dict:
        with self.lock:
            shared = int(np.sum(self._ref[1:] > 1))
            hit, filled = self.prefix_hit_tokens, self.prefilled_tokens
            out = {
                "blocks_total": self.num_blocks - 1,  # null excluded
                "block_size": self.block_size,
                "blocks_free": len(self._free),
                "blocks_shared": shared,
                "radix_nodes": self.radix.nodes,
                "evictions": self.evictions,
                "cow_copies": self.cow_copies,
                "prefix_hit_tokens": hit,
                "prefilled_tokens": filled,
                "prefix_savings_frac": round(hit / (hit + filled), 4)
                if hit + filled else 0.0,
                "radix_lookups": self.radix_lookups,
                "radix_hits": self.radix_hits,
            }
            if self.quantized:
                # Present only in quantized pools, as in the JAX pool.
                bpb = self.bytes_per_block()
                dense = self.dense_bytes_per_block()
                out["quantized"] = "int8"
                out["bytes_per_block"] = bpb
                out["dense_bytes_per_block"] = dense
                out["capacity_multiplier"] = round(dense / bpb, 3)
            return out


# -- device-side block movement (two-path admission) --------------------------

def gather_blocks(pool_k, pool_v, ids) -> KVCache:
    """(L, NB, bs, H, D) pools + (nb,) block ids -> one row cache
    (L, 1, nb*bs, H, D): logical column j*bs+o reads pool[ids[j], o].
    Null-block entries give columns the position mask must exclude."""
    n_layers, _, bs, h, d = pool_k.shape
    nb = ids.shape[0]
    return KVCache(pool_k[:, ids].reshape(n_layers, 1, nb * bs, h, d),
                   pool_v[:, ids].reshape(n_layers, 1, nb * bs, h, d))


def scatter_blocks(caches: KVCache, row_k, row_v, ids) -> None:
    """Write a prefilled (L, 1, nb*bs, H, D) row cache into pool blocks
    ``ids``, in place. Radix-matched slots map to the null block 0, so a
    shared block is never rewritten; those duplicate indices make the
    write order into block 0 undefined, which is harmless because block 0
    is never attended."""
    n_layers, nb = caches.k.shape[0], ids.shape[0]
    shape = (n_layers, nb) + tuple(caches.k.shape[2:])
    caches.k[:, ids] = row_k.reshape(shape).to(caches.k.dtype)
    caches.v[:, ids] = row_v.reshape(shape).to(caches.v.dtype)


def gather_blocks_quant(pool_k, pool_v, k_scale, v_scale, ids, *,
                        dtype) -> KVCache:
    """``gather_blocks`` for the int8 pool: the gathered blocks dequantize
    (payload * per-slot scale) to ``dtype``; the pool is untouched."""
    n_layers, _, bs, h, d = pool_k.shape
    nb = ids.shape[0]
    k = dequantize_kv(pool_k[:, ids], k_scale[:, ids], dtype)
    v = dequantize_kv(pool_v[:, ids], v_scale[:, ids], dtype)
    return KVCache(k.reshape(n_layers, 1, nb * bs, h, d),
                   v.reshape(n_layers, 1, nb * bs, h, d))


def scatter_blocks_quant(caches: KVCache, scales: KVCache, row_k, row_v,
                         ids) -> None:
    """``scatter_blocks`` for the int8 pool, in place: the row cache
    quantizes here, once, one int8 vector and f32 scale per (layer, slot,
    kv-head), and payload and scales are written together (null-block
    duplicates as in ``scatter_blocks``)."""
    n_layers, nb = caches.k.shape[0], ids.shape[0]
    shape = (n_layers, nb) + tuple(caches.k.shape[2:])
    qk, sk = quantize_kv(row_k.reshape(shape))
    qv, sv = quantize_kv(row_v.reshape(shape))
    caches.k[:, ids] = qk
    caches.v[:, ids] = qv
    scales.k[:, ids] = sk
    scales.v[:, ids] = sv
