"""Paged KV cache: a static block pool, page tables, a radix tree of
shared prompt prefixes, a host tier for cold prefixes and the chain wire
format (counterpart of ``tpu_engine/runtime/kv_blocks.py``).

- One static tensor per K/V of shape (L, num_blocks, block_size, H_kv, D)
  on the pool's device, allocated once and written in place. Block 0 is
  the reserved null block: unallocated page-table entries point at it,
  padding writes land in it, and it is never attended.
- Host bookkeeping (free list, per-block refcounts, the radix tree, the
  host tier's free slots) under one lock.
- Radix tree over FULL token blocks; refcounts with copy-on-write
  (``ensure_writable``); LRU eviction of tree-only leaves when allocation
  runs dry.
- Quantized block payloads (``quantize="int8"``): the pool tensors hold
  int8, with one f32 scale per (layer, block slot, kv-head) in ``scales``
  (a KVCache of (L, NB, bs, H_kv) tensors, ones when fresh, so unwritten
  slots dequantize to exact zeros). A token quantizes once, at its block
  write; copy-on-write, demotion, promotion and the wire move payload and
  scales verbatim.
- Host tier (``host_blocks`` > 0): eviction DEMOTES a cold radix leaf's
  block into a host buffer of shape (host_blocks, L, bs, H_kv, D) at the
  pool's storage dtype (plus (host_blocks, L, bs, H_kv) f32 scales for
  int8), pinned when the pool lives on the card. The node stays in the
  tree; a later lookup with ``promote_reserve`` swaps the block back in
  instead of recomputing its prefill. A round trip is bit-exact.
- Tensor-parallel pools (``tp_devices``): one set of block ids, one
  radix tree and one host tier of bookkeeping over N payload shards, rank
  r's (L, NB, bs, H_kv/N, D) tensor (and int8 scales) on its own device,
  each contiguous (the kernels refuse strided views). Copy-on-write,
  demotion and promotion copy every shard; the wire carries the whole
  H_kv (the shards' heads concatenated in rank order) stamped with ``tp``.
- Chain wire format (``export_chain`` / ``chain_compatible`` /
  ``verify_chain`` / ``import_chain``): a block chain as the JAX
  package's JSON-safe dict, byte for byte: the blocks' bytes verbatim in
  base64, a crc32 over them in chain order and the pool's generation.
- ``StateSlabPool``: the state_slab family's pool, one fixed-size f32 row
  per stream, with the same lock, null row and generation discipline and
  a one-pseudo-block chain of the same wire format.

Device work and threads. Every pool copy (the tick's writes, copy-on-
write, demotion, promotion, export, import) is issued on the pool
device's current stream, the one default stream that every thread of
the process shares, so copies run in the order they are issued. Two
threads issue them: the decode thread (ticks, admissions, an ``alloc``
that demotes a block) and the prefill thread (a lookup that promotes a
block, or demotes colder ones to make room). Each is issued under the
pool lock. Demotion waits for its copy (the host bytes are there when it
returns); promotion does not.

The bookkeeping is the JAX package's, line for line, so both pools hand
out the same block ids and host slots for the same sequence of calls.
"""

from __future__ import annotations

import base64
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_engine_torch.models.transformer import KVCache, TransformerConfig
from tpu_engine_torch.ops.quant import dequantize_kv, quantize_kv
from tpu_engine_torch.utils.device import resolve_device


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
    __slots__ = ("children", "parent", "key", "block_id", "last_used",
                 "host_slot")

    def __init__(self, parent: Optional["_RadixNode"], key, block_id: int):
        self.children: Dict[tuple, _RadixNode] = {}
        self.parent = parent
        self.key = key            # the block's token tuple (len block_size)
        self.block_id = block_id  # -1: root, or a node demoted to the host
        self.last_used = 0
        self.host_slot = -1       # >= 0 while demoted to the host tier

    @property
    def demoted(self) -> bool:
        return self.host_slot >= 0


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

    def lookup(self, tokens: Sequence[int],
               promote_reserve: Optional[int] = None) -> List[int]:
        """Longest-prefix match over full blocks. Returns the matched
        block ids in order, each retained once on behalf of the caller
        (release them when the row frees, or at once on a discarded
        admission).

        ``promote_reserve``: when not None, a match reaching a DEMOTED
        node swaps its block back in (displacing LRU-colder resident
        leaves if the free list is short) provided the pool keeps at
        least that many free blocks afterwards; a refused promotion ends
        the match at the resident prefix and counts ``swap_in_deferred``.
        None never promotes: a demoted node is a miss."""
        pool = self._pool
        pool.radix_lookups += 1
        ids: List[int] = []
        node = self.root
        stamp = self._tick()
        promoted = 0
        for key in self._full_blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            if child.demoted:
                if promote_reserve is None or not pool._promote_node(
                        child, promote_reserve):
                    if promote_reserve is not None:
                        pool.swap_in_deferred += 1
                    break
                promoted += 1
            child.last_used = stamp
            pool.retain(child.block_id)
            ids.append(child.block_id)
            node = child
        if promoted:
            pool.swap_in_events += 1
        if ids:
            pool.radix_hits += 1
        return ids

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int]) -> int:
        """Index a row's full prompt blocks; ``block_ids[j]`` holds prompt
        block j. New nodes retain their block (the tree's own reference);
        an existing node keeps its original block and the newcomer's
        duplicate stays row-private. A DEMOTED node is re-adopted: it
        points at the newcomer's block, which holds the same tokens' KV,
        and its host slot frees. Returns nodes added."""
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
            elif child.demoted:
                self._pool._host_free.append(child.host_slot)
                child.host_slot = -1
                child.block_id = int(block_ids[j])
                self._pool.retain(child.block_id)
            child.last_used = stamp
            node = child
        return added

    def _evictable(self) -> List[_RadixNode]:
        """Nodes whose device block the tree alone references and whose
        children (if any) are all demoted: each branch's device-resident
        frontier, so demotion proceeds root-ward leaf by leaf."""
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                if c.demoted:
                    continue
                if (all(g.demoted for g in c.children.values())
                        and self._pool.refcount(c.block_id) == 1):
                    out.append(c)
        return out

    def _demoted_leaves(self) -> List[_RadixNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                elif c.demoted:
                    out.append(c)
        return out

    def chain_nodes(self, tokens: Sequence[int]) -> List[_RadixNode]:
        """Longest-prefix node chain for ``tokens`` without promoting,
        pinning or stamping anything: a demoted node stays in the chain
        (``export_chain`` reads it from the host tier)."""
        out: List[_RadixNode] = []
        node = self.root
        for key in self._full_blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def top_chains(self, top_k: int = 8, max_tokens: int = 256
                   ) -> List[dict]:
        """The ``top_k`` deepest root-to-leaf chains (ties: the most
        recently used first) as ``{"tokens", "blocks"}`` summaries of at
        most ``max_tokens`` tokens each: the fleet prefix tier's /health
        seed, never a dump of the tree. Demoted nodes count like resident
        ones (an export serves both)."""
        leaves: List[tuple] = []
        stack = [(self.root, 0)]
        while stack:
            n, d = stack.pop()
            if not n.children:
                if d:
                    leaves.append((d, n))
                continue
            for c in n.children.values():
                stack.append((c, d + 1))
        leaves.sort(key=lambda t: (-t[0], -t[1].last_used))
        out: List[dict] = []
        for depth, leaf in leaves[:max(0, int(top_k))]:
            keys = []
            node = leaf
            while node is not None and node.key is not None:
                keys.append(node.key)
                node = node.parent
            keys.reverse()
            toks: List[int] = []
            for key in keys:
                toks.extend(int(t) for t in key)
                if len(toks) >= max_tokens:
                    break
            out.append({"tokens": toks[:max_tokens], "blocks": int(depth)})
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` device blocks by demoting (host tier
        configured) or dropping LRU frontier nodes that nothing but the
        tree references. Never touches a block a live row or a pinned
        lookup holds. Returns device blocks freed."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_blocks:
                    break
                if self._pool._demote_leaf(leaf):
                    freed += 1  # the node survives in the tree, demoted
                    continue
                del leaf.parent.children[leaf.key]
                self._pool.release(leaf.block_id)
                self.nodes -= 1
                self._pool.evictions += 1
                freed += 1
        return freed

    def clear(self) -> None:
        """Drop every node (weight reload: cached KV is stale). Blocks
        still referenced by live rows survive until those rows free;
        demoted nodes' host slots free at once."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                stack.append(c)
                if c.demoted:
                    self._pool._host_free.append(c.host_slot)
                    c.host_slot = -1
                else:
                    self._pool.release(c.block_id)
        self.root = _RadixNode(None, None, -1)
        self.nodes = 0


class BlockPool:
    """Device block pool + host bookkeeping for the paged KV cache."""

    def __init__(self, cfg: TransformerConfig, num_blocks: int,
                 block_size: int, dtype: torch.dtype = torch.bfloat16,
                 device=None, host_blocks: int = 0, quantize: str = "",
                 tp_devices: Optional[Sequence] = None):
        """``tp_devices`` (tensor-parallel serving): one device per rank
        (entries may repeat). The pool shards its H_kv axis over them:
        ``caches`` (and ``scales``) then hold one tensor per rank in each
        field. ``kv_heads`` must divide by the degree; ``device`` and
        ``tp_devices`` are exclusive."""
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if quantize not in ("", "int8"):
            raise ValueError(f"unsupported KV quantize mode {quantize!r} "
                             "(only 'int8')")
        self.tp = 1
        if tp_devices is not None:
            if device is not None:
                raise ValueError("BlockPool: pass device OR tp_devices, not "
                                 "both (the ranks own their placement)")
            self.tp = len(tp_devices)
            if cfg.kv_heads % self.tp:
                raise ValueError(
                    f"kv_heads={cfg.kv_heads} must divide by the "
                    f"tensor-parallel degree {self.tp} (the pool shards its "
                    f"H_kv axis)")
            self.shard_devices = [resolve_device(d) for d in tp_devices]
        else:
            self.shard_devices = [resolve_device(device)]
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # `io_dtype` is the compute dtype (what gathers dequantize to);
        # `dtype` is the payload's storage dtype (int8 when quantized).
        self.quantized = quantize == "int8"
        self.io_dtype = dtype
        self.dtype = torch.int8 if self.quantized else dtype
        self.device = self.shard_devices[0]
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
        # The host tier: one buffer per pool tensor, slot-major, at the
        # pool's storage dtype; pinned when the pool is on the card (a
        # failure to pin raises), so both copy directions are DMA.
        self.host_blocks = int(host_blocks)
        self._host: List[torch.Tensor] = []
        self._host_free: List[int] = []
        self._promoting: Optional[_RadixNode] = None
        if self.host_blocks > 0:
            pin = self.device.type == "cuda"
            self._host = [torch.zeros((self.host_blocks,) + tuple(
                t.shape[:1] + t.shape[2:]), dtype=t.dtype, pin_memory=pin)
                for t in self._pool_tensors()]
            self._host_free = list(range(self.host_blocks - 1, -1, -1))
        self.prefix_hit_tokens = 0
        self.prefilled_tokens = 0
        self.evictions = 0
        self.cow_copies = 0
        self.radix_lookups = 0
        self.radix_hits = 0
        self.demotions = 0
        self.swap_ins = 0          # blocks promoted host -> device
        self.swap_in_events = 0    # lookups that promoted >= 1 block
        self.swap_in_deferred = 0  # promotions refused by the reserve rule
        self.host_evictions = 0    # demoted leaves destroyed (tier full)
        self.swapped_in_tokens = 0

    def _init_device(self) -> KVCache:
        shape = (self.cfg.n_layers, self.num_blocks, self.block_size,
                 self.cfg.kv_heads // self.tp, self.cfg.d_head)

        def pair(fill, shp, dt):
            made = [[fill(shp, dtype=dt, device=d)
                     for d in self.shard_devices] for _ in range(2)]
            return KVCache(*made) if self.tp > 1 else KVCache(
                made[0][0], made[1][0])

        if self.quantized:
            self.scales = pair(torch.ones, shape[:-1], torch.float32)
        return pair(torch.zeros, shape, self.dtype)

    def _pool_tensors(self) -> List[torch.Tensor]:
        """The pool's tensors, block axis 1: per rank k, v (and the int8
        pool's k and v scales), the chain's entry order within a rank."""
        parts = [self.caches] + ([self.scales] if self.quantized else [])
        if self.tp == 1:
            return [t for c in parts for t in c]
        return [t for r in range(self.tp) for c in parts for t in
                (c.k[r], c.v[r])]

    def _whole(self, arrays: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-rank arrays in ``_pool_tensors`` order -> the whole
        [k, v(, ks, vs)]: each kind's shards concatenated on its heads
        axis (-2 of a payload, -1 of a scale) in rank order."""
        if self.tp == 1:
            return list(arrays)
        n = 4 if self.quantized else 2
        return [torch.cat(arrays[i::n], dim=-2 if i < 2 else -1)
                for i in range(n)]

    def _split(self, arrays: List[torch.Tensor]) -> List[torch.Tensor]:
        """``_whole``'s inverse: whole [k, v(, ks, vs)] -> per-rank
        arrays in ``_pool_tensors`` order."""
        if self.tp == 1:
            return list(arrays)
        chunks = [a.chunk(self.tp, dim=-2 if i < 2 else -1)
                  for i, a in enumerate(arrays)]
        return [c[r].contiguous() for r in range(self.tp) for c in chunks]

    # -- bookkeeping (hold self.lock) -----------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block_id: int) -> int:
        return int(self._ref[block_id])

    def evictable_blocks(self) -> int:
        return len(self.radix._evictable())

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + self.evictable_blocks()

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
        for t in self._pool_tensors():
            t[:, new_id] = t[:, block_id]
        self.release(block_id)
        self.cow_copies += 1
        return new_id, True

    # -- host tier (hold self.lock) -------------------------------------------
    #
    # Hazard: a promoted slot returns to `_host_free` while its host-to-
    # device copy may still be in flight. Only copies issued on the pool
    # device's stream may ever write into a host slot (they run after that
    # read), never host code, or a later demotion could overwrite the
    # bytes before the promotion has read them.

    def _demote_leaf(self, leaf: _RadixNode) -> bool:
        """Move a tree-only frontier node's block to the host tier instead
        of destroying it: copy device -> host (verbatim, waited for), free
        the device block, mark the node demoted. A full tier first
        destroys its own LRU demoted leaf; no host tier, or only demoted
        interior nodes -> False, and the caller destroys the node."""
        if self.host_blocks <= 0:
            return False
        if not self._host_free:
            victims = [v for v in self.radix._demoted_leaves()
                       if v is not self._promoting]
            if not victims:
                return False  # demoted interior nodes only: can't destroy
            victims.sort(key=lambda n: n.last_used)
            v = victims[0]
            del v.parent.children[v.key]
            self._host_free.append(v.host_slot)
            v.host_slot = -1
            self.radix.nodes -= 1
            self.host_evictions += 1
        slot = self._host_free.pop()
        bid = leaf.block_id
        for host, t in zip(self._host, self._pool_tensors()):
            host[slot].copy_(t[:, bid])
        self.release(bid)
        leaf.block_id = -1
        leaf.host_slot = slot
        self.demotions += 1
        return True

    def _promote_node(self, node: _RadixNode, reserve: int) -> bool:
        """Swap a demoted node's block back onto the device: one host ->
        device copy per pool tensor, not waited for. The block comes from
        the free list, or by DISPLACING LRU-colder resident leaves
        (evict(), which demotes them to this tier); either way at least
        ``reserve`` free blocks must remain afterwards (live rows' growth
        outranks a cold prefix), else the promotion defers (False)."""
        need = 1 + max(0, int(reserve))
        if len(self._free) < need:
            # The walked chain's nodes are pinned (refcount >= 2), so the
            # displacement never takes a block this lookup relies on; the
            # node being promoted is stamped and shielded (_promoting) so
            # a full tier cannot destroy it.
            node.last_used = self.radix._tick()
            self._promoting = node
            try:
                self.radix.evict(need - len(self._free))
            finally:
                self._promoting = None
        if len(self._free) < need:
            return False
        bid = self._free.pop()
        self._ref[bid] = 1  # the tree's own reference
        for host, t in zip(self._host, self._pool_tensors()):
            t[:, bid].copy_(host[node.host_slot], non_blocking=True)
        self._host_free.append(node.host_slot)
        node.host_slot = -1
        node.block_id = bid
        self.swap_ins += 1
        self.swapped_in_tokens += self.block_size
        return True

    # -- chain export/import (hold self.lock) ---------------------------------
    #
    # The JAX package's wire format: one JSON-safe dict per chain, each
    # block's C-order bytes (L, bs, H_kv, D) at the storage dtype (int8
    # pools add their (L, bs, H_kv) f32 scales) in base64, a crc32 over
    # every payload byte in chain order, and the pool's generation.

    def _dtype_name(self) -> str:
        """The storage dtype as numpy names it (``bfloat16``, ``int8``)."""
        return str(self.dtype).replace("torch.", "")

    def _export_device_arrays(self, bids: Sequence[int]
                              ) -> List[torch.Tensor]:
        """Device blocks ``bids`` -> host tensors [k, v(, ks, vs)], each
        block-major (n, L, ...): one gather and one transfer per tensor,
        not one per block."""
        ids = torch.tensor(list(bids), dtype=torch.long)
        return self._whole([
            t[:, ids.to(t.device)].transpose(0, 1).contiguous().cpu()
            for t in self._pool_tensors()])

    def _export_host_arrays(self, slot: int) -> List[torch.Tensor]:
        """A demoted node's block, straight from the host tier: no swap-
        in, no device traffic."""
        return self._whole([host[slot] for host in self._host])

    def export_chain(self, sources: Sequence,
                     trace: Optional[dict] = None) -> dict:
        """Serialize a block chain. Each source is a device block id or a
        ``_RadixNode`` (a demoted one exports from the host tier). Returns
        the wire dict; ``import_chain`` on any pool of the same geometry
        (either package's) reproduces the exact bytes. ``trace``: a
        trace-context header carried as an additive ``"trace"`` key
        (cross-lane trace stitching; the import checks ignore it); None
        keeps the wire dict unchanged."""
        resolved = []
        dev_ids: List[int] = []
        for src in sources:
            if isinstance(src, _RadixNode) and src.demoted:
                resolved.append(("host", src.host_slot))
            else:
                bid = src.block_id if isinstance(src, _RadixNode) \
                    else int(src)
                resolved.append(("dev", len(dev_ids)))
                dev_ids.append(bid)
        dev = self._export_device_arrays(dev_ids) if dev_ids else None
        blocks = []
        crc = 0
        for kind, idx in resolved:
            if kind == "host":
                arrays = self._export_host_arrays(idx)
            else:
                arrays = [a[idx] for a in dev]
            entry = {}
            for name, arr in zip(("k", "v", "ks", "vs"), arrays):
                # A bf16 block has no numpy dtype: its bytes go through a
                # uint8 view of the contiguous tensor.
                raw = arr.contiguous().view(torch.uint8).numpy().tobytes()
                crc = zlib.crc32(raw, crc)
                entry[name] = base64.b64encode(raw).decode("ascii")
            blocks.append(entry)
        out = {
            "version": 1,
            "dtype": self._dtype_name(),
            "quantized": self.quantized,
            "block_size": self.block_size,
            "n_layers": self.cfg.n_layers,
            "kv_heads": self.cfg.kv_heads,
            "d_head": self.cfg.d_head,
            "blocks": blocks,
            "checksum": crc,
            "generation": self.generation,
        }
        if self.tp > 1:
            # The shard-geometry stamp, absent at tp 1 (that wire is the
            # pre-TP one): a chain written under another partitioning
            # refuses by name (chain_compatible) and the caller replays.
            out["tp"] = self.tp
        if trace:
            out["trace"] = dict(trace)
        return out

    def chain_compatible(self, chain: dict) -> Optional[str]:
        """None when ``chain`` can be imported into this pool verbatim,
        else the reason, as the JAX pool words it: the family (absent =
        ``kv_paged``), the geometry and storage dtype (an import never
        requantizes), the shard degree (``tp``), and
        every block's structure (keys, exact decoded lengths), so a
        malformed chain is refused here and never reaches a device
        write. An additive ``trace`` key is ignored. A chain without a
        ``tp`` stamp reads as tp 1."""
        fam = chain.get("family")
        if fam not in (None, "kv_paged"):
            return (f"chain family={fam!r} does not match destination "
                    f"pool family 'kv_paged'")
        want = {"dtype": self._dtype_name(),
                "quantized": self.quantized,
                "block_size": self.block_size,
                "n_layers": self.cfg.n_layers,
                "kv_heads": self.cfg.kv_heads,
                "d_head": self.cfg.d_head}
        for key, val in want.items():
            if chain.get(key) != val:
                return (f"chain {key}={chain.get(key)!r} does not match "
                        f"destination pool {key}={val!r}")
        try:
            chain_tp = int(chain.get("tp", 1))
        except (TypeError, ValueError):
            return f"chain tp={chain.get('tp')!r} is not an integer"
        if chain_tp != self.tp:
            return (f"chain tp={chain_tp} does not match destination "
                    f"pool tp={self.tp} (tensor-parallel shard "
                    f"geometry)")
        slots = self.cfg.n_layers * self.block_size * self.cfg.kv_heads
        payload_len = slots * self.cfg.d_head * torch.empty(
            (), dtype=self.dtype).element_size()
        want_lens = {"k": payload_len, "v": payload_len}
        if self.quantized:
            want_lens.update({"ks": slots * 4, "vs": slots * 4})
        blocks = chain.get("blocks")
        if not isinstance(blocks, (list, tuple)):
            return "chain carries no block list"
        for i, entry in enumerate(blocks):
            if not isinstance(entry, dict):
                return f"chain block {i} is not an object"
            for name, want_len in want_lens.items():
                raw = entry.get(name)
                if not isinstance(raw, str):
                    return f"chain block {i} is missing {name!r}"
                try:
                    n = len(base64.b64decode(raw, validate=True))
                except Exception:
                    return f"chain block {i} {name!r} is not base64"
                if n != want_len:
                    return (f"chain block {i} {name!r} holds {n} bytes, "
                            f"expected {want_len}")
        return None

    @staticmethod
    def verify_chain(chain: dict) -> bool:
        """Recompute the chain checksum over the decoded payload bytes:
        the destination's first gate, before any block is allocated. A
        structurally garbage chain is False, never an exception."""
        crc = 0
        try:
            blocks = chain["blocks"]
            if not isinstance(blocks, (list, tuple)):
                return False
            for entry in blocks:
                if not isinstance(entry, dict):
                    return False
                for name in ("k", "v", "ks", "vs"):
                    if name in entry:
                        crc = zlib.crc32(
                            base64.b64decode(entry[name]), crc)
            return crc == int(chain["checksum"])
        except Exception:
            return False

    def _chain_block_arrays(self, chain: dict, entry: dict
                            ) -> List[torch.Tensor]:
        """One wire block -> host tensors [k, v(, ks, vs)] shaped (L, bs,
        H_kv, D) and (L, bs, H_kv)."""
        shape = (self.cfg.n_layers, self.block_size, self.cfg.kv_heads,
                 self.cfg.d_head)
        out = [torch.frombuffer(bytearray(base64.b64decode(entry[name])),
                                dtype=self.dtype).reshape(shape)
               for name in ("k", "v")]
        if self.quantized:
            out += [torch.frombuffer(
                bytearray(base64.b64decode(entry[name])),
                dtype=torch.float32).reshape(shape[:-1])
                for name in ("ks", "vs")]
        return out

    def import_chain(self, chain: dict, entries: Sequence[dict],
                     ids: Sequence[int]) -> None:
        """Write wire blocks ``entries`` into the already-allocated device
        blocks ``ids`` verbatim: one batched write per pool tensor. The
        caller holds the lock and has verified the checksum and
        compatibility."""
        if not ids:
            return
        per = [self._split(self._chain_block_arrays(chain, e))
               for e in entries]
        dst = torch.tensor(list(ids), dtype=torch.long)
        for i, t in enumerate(self._pool_tensors()):
            # (n, L, ...) -> (L, n, ...): the pool's block axis.
            t[:, dst.to(t.device)] = torch.stack(
                [p[i] for p in per], dim=1).to(t.device)

    def reset(self) -> None:
        """Recovery after a failed device step: the pool tensors may hold
        half-written blocks, so everything is rebuilt, and the host tier
        empties with the tree. Pins and page tables taken against the old
        generation are void."""
        self.generation += 1
        self.caches = self._init_device()
        self._ref[:] = 0
        self._ref[0] = 1
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self.radix = RadixTree(self)
        if self.host_blocks > 0:
            self._host_free = list(range(self.host_blocks - 1, -1, -1))

    def bytes_per_block(self) -> int:
        """Device bytes one block costs in this pool's layout: K+V payload
        at the storage dtype, plus (int8) the per-slot f32 scales."""
        if self.quantized:
            return quant_block_bytes(self.cfg, self.block_size)
        return dense_block_bytes(self.cfg, self.block_size, self.dtype)

    def dense_bytes_per_block(self) -> int:
        """What the same block would cost unquantized (at io_dtype)."""
        return dense_block_bytes(self.cfg, self.block_size, self.io_dtype)

    def _demoted_nodes(self) -> int:
        """Radix nodes holding a host slot: the pairing side of the host
        scale-slot leak check (caller holds the lock)."""
        n, stack = 0, [self.radix.root]
        while stack:
            node = stack.pop()
            for c in node.children.values():
                stack.append(c)
                n += int(c.demoted)
        return n

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
            if self.tp > 1:
                # Present only in tensor-parallel pools, as in the JAX
                # pool: the degree and one device's share of a block.
                out["tp"] = self.tp
                out["bytes_per_block_per_device"] = (
                    self.bytes_per_block() // self.tp)
            if self.quantized:
                # Present only in quantized pools, as in the JAX pool.
                bpb = self.bytes_per_block()
                dense = self.dense_bytes_per_block()
                out["quantized"] = "int8"
                out["bytes_per_block"] = bpb
                out["dense_bytes_per_block"] = dense
                out["capacity_multiplier"] = round(dense / bpb, 3)
            if self.host_blocks > 0:
                used = self.host_blocks - len(self._host_free)
                out["host"] = {
                    "blocks_total": self.host_blocks,
                    "blocks_used": used,
                    "demotions": self.demotions,
                    "swap_ins": self.swap_ins,
                    "swap_in_events": self.swap_in_events,
                    "swap_in_deferred": self.swap_in_deferred,
                    "host_evictions": self.host_evictions,
                    "swapped_in_tokens": self.swapped_in_tokens,
                }
                if self.quantized:
                    # Scale slots pair 1:1 with payload slots: a used slot
                    # no demoted node holds (or the reverse) is a leak.
                    out["host"]["scale_slots_used"] = used
                    out["host"]["scale_slots_leaked"] = (
                        used - self._demoted_nodes())
            return out


class StateSlabPool:
    """Fixed-size recurrent-state rows for the state_slab family
    (``models.ssd``; counterpart of the JAX package's ``StateSlabPool``):
    one ``(n_layers, state_dim)`` f32 row per live stream, constant in
    sequence length, in one ``slab`` tensor (L, num_rows, state_dim) on the
    pool's device, written in place.

    The ``BlockPool`` discipline: one lock over the free list and
    refcounts under which every slab-touching device write and read is
    issued (the ticks, admission writes, exports and imports), a reserved
    null row 0 that free scheduler slots point at (a window scan leaves a
    row with no valid slot untouched), and a generation stamp that voids
    row ids across ``reset``. No radix tree and no prefix sharing: a
    recurrent prefix is a dense state, not a block-addressable chain, and
    ``stats()`` says so.

    Chain wire format, byte for byte the JAX pool's: a row serializes as a
    one-pseudo-block chain ``{"k": base64 of slab[:, rid]'s raw f32
    bytes}`` with a crc32 checksum, ``"dtype": "float32"`` and the pool's
    generation, so ``BlockPool.verify_chain`` verifies it unchanged and a
    chain crosses between the two packages in both directions."""

    def __init__(self, n_layers: int, state_dim: int, num_rows: int,
                 dtype: torch.dtype = torch.float32, device=None):
        if num_rows < 2:
            raise ValueError("need >= 2 state rows (row 0 is the null row)")
        self.n_layers = int(n_layers)
        self.state_dim = int(state_dim)
        self.num_rows = int(num_rows)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.lock = threading.RLock()
        self.generation = 0
        self.slab = self._init_device()
        self._ref = np.zeros((self.num_rows,), np.int32)
        self._ref[0] = 1  # null row: permanently pinned, never allocated
        self._free: List[int] = list(range(self.num_rows - 1, 0, -1))
        # Counters of the state_pool stats block and tpu_engine_state_*.
        self.rows_admitted = 0
        self.rows_released = 0
        self.exports = 0
        self.imports = 0

    def _init_device(self) -> torch.Tensor:
        return torch.zeros((self.n_layers, self.num_rows, self.state_dim),
                           dtype=self.dtype, device=self.device)

    def _dtype_name(self) -> str:
        return str(self.dtype).replace("torch.", "")

    # -- bookkeeping (hold self.lock) -----------------------------------------

    @property
    def rows_free(self) -> int:
        return len(self._free)

    def refcount(self, row_id: int) -> int:
        return int(self._ref[row_id])

    def alloc_row(self) -> int:
        """One fresh state row (refcount 1). Raises PoolExhausted (state
        unchanged) when none is free: the scheduler defers the admission."""
        if not self._free:
            raise PoolExhausted(
                f"no free state rows ({self.num_rows - 1} total)")
        rid = self._free.pop()
        self._ref[rid] = 1
        self.rows_admitted += 1
        return rid

    def release_row(self, row_id: int) -> None:
        if row_id == 0:
            return  # null row: permanent
        self._ref[row_id] -= 1
        assert self._ref[row_id] >= 0, "double free of a state row"
        if self._ref[row_id] == 0:
            self._free.append(row_id)
            self.rows_released += 1

    def write_row(self, row_id: int, flat: Optional[torch.Tensor]) -> None:
        """Set row ``row_id`` to ``flat`` (L, state_dim), or to zeros for
        None (a fresh stream's state). Caller holds the lock."""
        if flat is None:
            self.slab[:, row_id] = 0.0
        else:
            self.slab[:, row_id] = flat.to(device=self.device,
                                           dtype=self.dtype)

    # -- chain export/import (one-pseudo-block wire format) -------------------

    def export_row_chain(self, row_id: int) -> dict:
        """Serialize one state row as a one-pseudo-block chain: its
        verbatim f32 bytes (the device read is issued after every write
        that produced them, in the lock's order), so an import on any
        same-geometry pool of either package is bit-exact."""
        raw = self.slab[:, row_id].contiguous().cpu().numpy().tobytes()
        self.exports += 1
        return {
            "version": 1,
            "family": "state_slab",
            "dtype": self._dtype_name(),
            "n_layers": self.n_layers,
            "state_dim": self.state_dim,
            "blocks": [{"k": base64.b64encode(raw).decode("ascii")}],
            "checksum": zlib.crc32(raw),
            "generation": self.generation,
        }

    def chain_compatible(self, chain: dict) -> Optional[str]:
        """None when ``chain`` can be imported into this pool verbatim, else
        the refusal: family, geometry and dtype must match, and the one
        pseudo-block's payload must hold exactly one row's bytes. Refused
        here, before any row is allocated."""
        want = {"family": "state_slab", "dtype": self._dtype_name(),
                "n_layers": self.n_layers, "state_dim": self.state_dim}
        for key, val in want.items():
            if chain.get(key) != val:
                return (f"chain {key}={chain.get(key)!r} does not match "
                        f"destination state pool {key}={val!r}")
        blocks = chain.get("blocks")
        if not isinstance(blocks, (list, tuple)) or len(blocks) != 1:
            return "state chain must carry exactly one pseudo-block"
        entry = blocks[0]
        if not isinstance(entry, dict) or not isinstance(entry.get("k"),
                                                         str):
            return "state chain block 0 is missing its payload"
        try:
            n = len(base64.b64decode(entry["k"], validate=True))
        except Exception:
            return "state chain block 0 payload is not base64"
        if n != self.bytes_per_row():
            return (f"state chain block 0 holds {n} bytes, expected "
                    f"{self.bytes_per_row()}")
        return None

    # The checksum gate does not depend on the payload's shape.
    verify_chain = staticmethod(BlockPool.verify_chain)

    def import_row_chain(self, chain: dict, row_id: int) -> None:
        """Write a verified chain's payload into an allocated row verbatim.
        The caller holds the lock and has run ``chain_compatible`` and
        ``verify_chain``."""
        raw = base64.b64decode(chain["blocks"][0]["k"])
        flat = torch.from_numpy(np.frombuffer(raw, dtype=np.float32).copy())
        self.slab[:, row_id] = flat.reshape(
            self.n_layers, self.state_dim).to(self.device)
        self.imports += 1

    def reset(self) -> None:
        """Recovery after a failed device step: the slab may hold
        half-written rows, so it is rebuilt, and every row id issued against
        the old generation is void."""
        self.generation += 1
        self.slab = self._init_device()
        self._ref[:] = 0
        self._ref[0] = 1
        self._free = list(range(self.num_rows - 1, 0, -1))

    def bytes_per_row(self) -> int:
        """Device bytes one stream's whole state costs, constant in
        sequence length."""
        return int(self.n_layers * self.state_dim
                   * torch.empty((), dtype=self.dtype).element_size())

    def stats(self) -> dict:
        with self.lock:
            return {
                "rows_total": self.num_rows - 1,  # null row excluded
                "rows_free": len(self._free),
                "state_dim": self.state_dim,
                "n_layers": self.n_layers,
                "bytes_per_row": self.bytes_per_row(),
                "rows_admitted": self.rows_admitted,
                "rows_released": self.rows_released,
                "exports": self.exports,
                "imports": self.imports,
                "prefix_sharing":
                    "unsupported: recurrent state is not "
                    "block-addressable",
            }


# -- device-side block movement (two-path admission) --------------------------

def _per_shard(fn, *args, ids, **kw):
    """``fn`` over each tensor-parallel shard (args that are lists hold one
    tensor per rank), ``ids`` on each shard's device; the results' fields
    regathered into one sharded KVCache (or None)."""
    outs = [fn(*[a[r] if isinstance(a, list) else a for a in args],
               ids=ids.to(args[0][r].device), **kw)
            for r in range(len(args[0]))]
    if outs[0] is None:
        return None
    return KVCache([o.k for o in outs], [o.v for o in outs])


def gather_blocks(pool_k, pool_v, ids) -> KVCache:
    """(L, NB, bs, H, D) pools + (nb,) block ids -> one row cache
    (L, 1, nb*bs, H, D): logical column j*bs+o reads pool[ids[j], o].
    Null-block entries give columns the position mask must exclude.
    Sharded pools (lists, one tensor per rank) give per-rank row
    caches."""
    if isinstance(pool_k, list):
        return _per_shard(gather_blocks, pool_k, pool_v, ids=ids)
    n_layers, _, bs, h, d = pool_k.shape
    nb = ids.shape[0]
    return KVCache(pool_k[:, ids].reshape(n_layers, 1, nb * bs, h, d),
                   pool_v[:, ids].reshape(n_layers, 1, nb * bs, h, d))


def scatter_blocks(caches: KVCache, row_k, row_v, ids) -> None:
    """Write a prefilled (L, 1, nb*bs, H, D) row cache into pool blocks
    ``ids``, in place. Radix-matched slots map to the null block 0, so a
    shared block is never rewritten; those duplicate indices make the
    write order into block 0 undefined, which is harmless because block 0
    is never attended. A sharded pool takes per-rank row caches."""
    if isinstance(caches.k, list):
        _per_shard(lambda k, v, rk, rv, ids: scatter_blocks(
            KVCache(k, v), rk, rv, ids), caches.k, caches.v, row_k, row_v,
            ids=ids)
        return
    n_layers, nb = caches.k.shape[0], ids.shape[0]
    shape = (n_layers, nb) + tuple(caches.k.shape[2:])
    caches.k[:, ids] = row_k.reshape(shape).to(caches.k.dtype)
    caches.v[:, ids] = row_v.reshape(shape).to(caches.v.dtype)


def gather_blocks_quant(pool_k, pool_v, k_scale, v_scale, ids, *,
                        dtype) -> KVCache:
    """``gather_blocks`` for the int8 pool: the gathered blocks dequantize
    (payload * per-slot scale) to ``dtype``; the pool is untouched."""
    if isinstance(pool_k, list):
        return _per_shard(gather_blocks_quant, pool_k, pool_v, k_scale,
                          v_scale, ids=ids, dtype=dtype)
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
    if isinstance(caches.k, list):
        _per_shard(lambda k, v, sk, sv, rk, rv, ids: scatter_blocks_quant(
            KVCache(k, v), KVCache(sk, sv), rk, rv, ids), caches.k,
            caches.v, scales.k, scales.v, row_k, row_v, ids=ids)
        return
    n_layers, nb = caches.k.shape[0], ids.shape[0]
    shape = (n_layers, nb) + tuple(caches.k.shape[2:])
    qk, sk = quantize_kv(row_k.reshape(shape))
    qv, sv = quantize_kv(row_v.reshape(shape))
    caches.k[:, ids] = qk
    caches.v[:, ids] = qv
    scales.k[:, ids] = sk
    scales.v[:, ids] = sv
