"""Continuous-batching scheduler (counterpart of ``ContinuousGenerator`` in
``tpu_engine/runtime/scheduler.py``) over the dense KV cache or the paged
one, in three modes:

- **Dense** (``kv_block_size`` 0, the worker's default lane). The batch is
  ``n_slots`` rows of one dense (L, n_slots, max_seq, H_kv, D) cache. The
  prefill thread runs each prompt's forward on the request's own
  left-padded row cache: one ``transformer_prefill`` (its attention is the
  flash kernel) when the prompt bucket is no wider than ``prefill_chunk``,
  else ``transformer_decode_window`` windows; a byte-budget LRU prefix
  cache (``prefix_cache_mb``) of (logits, row cache) skips the forward for
  an exact repeat of a (bucket, prompt). The decode thread copies the row
  cache into its row of the shared cache at admission (a cached entry is
  copied, never aliased) and runs decode chunks: ``step_chunk`` steps of
  ``transformer_decode_rows`` and sampling on the device, with one host
  sync per chunk. A row's prompt sits at columns [pb - L, pb), so ``start``
  = pb - L masks the padding and positions count from it.
- **Paged**: the batch is ``n_slots`` rows over one block pool
  (``runtime.kv_blocks.BlockPool``, bf16/f32 or int8 with
  ``kv_quantize="int8"``) with per-row block tables and a radix tree that
  maps shared prompt prefixes onto already-filled blocks.
- **Mixed stepping** (paged, ``mixed_step=True``). The prefill thread is pure
  batch formation: bucket pick, radix lookup (which pins the matched
  blocks) and penalty counts, no device work. The decode thread admits
  formed requests into free rows and, each tick, issues ONE forward
  (``transformer_step_rows_ragged``) over a ragged batch of decode rows
  (one token each) and admitting rows' prefill chunks (budgeted), then
  samples one token per row. The ``.cpu()`` of the sampled tokens is the
  tick's one host sync.
- **Two-path** (paged, ``mixed_step=False``). The prefill thread runs each
  prompt's forward: radix lookup, a gather of the matched prefix blocks
  into the request's own dense row cache (dequantized for the int8 pool),
  ``transformer_decode_window`` windows over the rest and the first
  token's sample. The decode thread scatters the row cache into fresh pool
  blocks at admission (quantizing there, once, for int8; matched slots
  scatter into the null block) and runs decode chunks: ``step_chunk``
  steps of ``transformer_decode_rows_paged`` and sampling on the device,
  with one host sync per chunk. Both threads issue device work on the one
  CUDA stream; the gather and every pool write are issued under the
  pool's lock, so they run in the lock's order.
- Invariants kept from the JAX scheduler: mixed ticks and dispatches are
  counted at separate sites and stay equal; a prompt's blocks enter the
  radix tree only once they are filled (a cancelled mid-prefill row never
  leaves half-written blocks indexed); every row-free path returns the
  row's blocks.

A request is cancelled by cancelling the Future ``submit`` returned: its
row frees between ticks (chunks) and its stream ends. A request submitted
with a ``Deadline`` is failed with ``DeadlineExceeded`` where the JAX
scheduler fails it: before its prefill, before its row admission, or
between ticks once the deadline passes mid-generation (the cancel path
above; tokens already streamed stand). The speculative, state-slab and
stateless modes, the host tier, migration, handoff, brownout and tensor
parallelism are not yet ported and refuse.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    init_caches,
    transformer_decode_rows,
    transformer_decode_rows_paged,
    transformer_decode_window,
    transformer_prefill,
    transformer_step_rows_ragged,
)
from tpu_engine_torch.runtime.generator import (
    _sample,
    apply_repetition_penalty,
    pick_bucket,
    right_pad_prompt,
    token_counts,
)
from tpu_engine_torch.runtime.kv_blocks import (
    BlockPool,
    PoolExhausted,
    gather_blocks,
    gather_blocks_quant,
    scatter_blocks,
    scatter_blocks_quant,
)
from tpu_engine_torch.utils.deadline import Deadline, DeadlineExceeded
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype
from tpu_engine_torch.utils.sampling import (
    MAX_STOP_TOKENS,
    clamp_top_k,
    expand_sampling_params,
    expand_stopping_params,
    truncate_at_stops,
)


@dataclass
class _Request:
    prompt: List[int]
    max_new: int
    eos_id: int
    temperature: float
    seed: int
    top_p: float
    top_k: int
    rep_penalty: float = 1.0
    stop_tokens: List[int] = field(default_factory=list)
    min_p: float = 0.0
    future: Future = field(default_factory=Future)
    # Streaming: fresh token lists are pushed as they decode; None ends
    # the stream (the future then holds the result or the error).
    stream: Optional["queue.Queue"] = None
    streamed: int = 0
    deadline: Optional[Deadline] = None


class _Formed(NamedTuple):
    """A request after the prefill thread: batch formation (mixed mode),
    or also the prompt's forward (dense and two-path modes: ``row_caches``
    and ``first_tok``)."""
    req: _Request
    pb: int                 # prompt bucket
    L: int                  # prompt length after truncation to pb
    row_counts: Optional[np.ndarray]  # context token counts (controls)
    matched: List[int]      # radix-matched block ids, pinned for this row
    prompt: List[int]
    gen: int                # pool generation the pins belong to
    row_caches: Optional[KVCache] = None  # (L, 1, pb, H_kv, D) row cache
    first_tok: int = 0


class _PrefixCache:
    """Byte-budget LRU of prefilled (logits, row cache) pairs keyed by the
    exact (prompt bucket, prompt length, left-padded tokens): a repeated
    prompt skips its forward at admission. Sampling parameters stay out of
    the key: the logits do not depend on them, and the first token is
    sampled per request from the cached logits, so a seeded stream is the
    same hit or miss. Touched only by the prefill thread; ``stats`` reads
    from other threads take plain ints. A budget of 0 disables it (no
    misses counted); an entry larger than the budget is never stored."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._items: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _nbytes(logits, caches) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in (logits, caches.k, caches.v)))

    def get(self, key):
        if self.budget <= 0:
            return None
        item = self._items.get(key)
        if item is None:
            self.misses += 1
            return None
        self._items.move_to_end(key)
        self.hits += 1
        return item[0], item[1]

    def put(self, key, logits, caches) -> None:
        if self.budget <= 0 or key in self._items:
            return
        nbytes = self._nbytes(logits, caches)
        if nbytes > self.budget:
            return  # one giant prompt must not flush the whole cache
        while self.bytes + nbytes > self.budget and self._items:
            _, (_, _, evicted) = self._items.popitem(last=False)
            self.bytes -= evicted
        self._items[key] = (logits, caches, nbytes)
        self.bytes += nbytes

    def stats(self) -> dict:
        return {"entries": len(self._items), "bytes": self.bytes,
                "hits": self.hits, "misses": self.misses}


class _StaleAdmission(RuntimeError):
    """A formed item's radix pins predate a pool rebuild (device
    recovery): that request fails, the scheduler keeps serving."""


def _refuse(what: str):
    raise NotImplementedError(f"{what} is not yet ported to "
                              f"tpu_engine_torch")


class ContinuousGenerator:
    def __init__(
        self,
        model: Union[str, ModelSpec],
        params=None,
        rng_seed: int = 0,
        dtype: str = "bfloat16",
        n_slots: int = 8,
        step_chunk: int = 8,
        max_seq: Optional[int] = None,
        device=None,
        prefix_cache_mb: int = 64,
        prefill_chunk: int = 256,
        kv_block_size: int = 0,
        kv_blocks: int = 0,
        kv_host_blocks: int = 0,
        kv_quantize: str = "",
        prefix_sharing: bool = True,
        mixed_step: bool = False,
        mixed_token_budget: int = 0,
        spec_k: int = 0,
        state_rows: int = 0,
        tp: int = 1,
    ):
        """Arguments keep the JAX scheduler's names and meanings; the ones
        of modes not yet ported refuse when set. ``kv_block_size`` 0 picks
        the dense mode, > 0 the paged one, where ``mixed_step`` picks
        mixed stepping over two-path; ``step_chunk`` is the dense and
        two-path decode chunk's steps; ``prefix_cache_mb`` the dense
        prefix cache's budget (0 disables it);
        ``kv_quantize`` "int8" stores the pool int8 with per-(layer, slot,
        kv-head) f32 scales in either mode. ``device`` defaults to the CUDA
        card; pass ``device="cpu"`` to run the plain PyTorch paths on the
        CPU."""
        if isinstance(model, str):
            model = create_model(model)
        if mixed_step and int(kv_block_size) <= 0:
            raise ValueError("mixed_step requires the paged KV cache "
                             "(set kv_block_size > 0)")
        if kv_quantize and int(kv_block_size) <= 0:
            raise ValueError("kv_quantize requires the paged KV cache "
                             "(set kv_block_size > 0)")
        if int(spec_k) > 0:
            _refuse("continuous speculative decoding (spec_k)")
        if int(kv_host_blocks) > 0:
            _refuse("the host KV tier (kv_host_blocks)")
        if int(state_rows) > 0:
            _refuse("the state_slab family (state_rows)")
        if int(tp) > 1:
            _refuse("tensor-parallel serving (tp)")
        cfg = model.config
        if not isinstance(cfg, TransformerConfig) or not cfg.causal:
            raise ValueError(f"model '{model.name}' is not a decoder "
                             f"transformer")
        self.spec = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.max_seq = min(max_seq or cfg.max_seq, cfg.max_seq)
        self.n_slots = int(n_slots)
        self._paged = int(kv_block_size) > 0
        self._mixed = bool(mixed_step)
        self._step_chunk = int(step_chunk)
        if not self._mixed and self._step_chunk < 1:
            raise ValueError(f"step_chunk must be >= 1, got {step_chunk}")
        # Columns past `pos` the next tick may write for a decode row: one
        # in mixed mode, a whole chunk in two-path mode. Block growth and
        # admission headroom reserve exactly that.
        self._decode_horizon = 1 if self._mixed else self._step_chunk
        b, buckets = 16, []
        while b < self.max_seq:
            buckets.append(b)
            b *= 2
        self._prompt_buckets = tuple(buckets) + (self.max_seq,)
        self.params = params if params is not None else model.init(
            rng_seed, device=self.device, dtype=self._dtype)
        # Every mode carries the prefix cache (idle in the paged modes, as
        # in the JAX scheduler), so stats() has one schema.
        self._prefix_cache = _PrefixCache(int(prefix_cache_mb) * (1 << 20))
        self._row_blocks: List[List[int]] = [[] for _ in
                                             range(self.n_slots)]
        # Admissions deferred on pool pressure, retried as rows free.
        self._pending: "collections.deque[_Formed]" = collections.deque()
        if self._paged:
            self._init_pool(cfg, int(kv_block_size), int(kv_blocks),
                            str(kv_quantize), bool(prefix_sharing))
        else:
            self._caches = init_caches(cfg, self.n_slots, self.max_seq,
                                       self._dtype, self.device)

        n = self.n_slots
        self._pos = np.zeros((n,), np.int32)      # next write column
        self._start = np.zeros((n,), np.int32)    # first valid column
        self._tok = np.zeros((n,), np.int32)      # last emitted token
        self._seeds = np.zeros((n,), np.int64)
        self._temps = np.zeros((n,), np.float32)
        self._topps = np.ones((n,), np.float32)
        self._topks = np.zeros((n,), np.int64)
        self._minps = np.zeros((n,), np.float32)
        self._pens = np.ones((n,), np.float32)
        self._stops = np.full((n, MAX_STOP_TOKENS), -1, np.int32)
        # Context-token counts (repetition-penalty state) on the device,
        # allocated when the first request with a penalty or stop list
        # arrives.
        self._counts: Optional[torch.Tensor] = None
        self._done = np.ones((n,), bool)
        self._row_req: List[Optional[_Request]] = [None] * n
        self._row_emitted: List[List[int]] = [[] for _ in range(n)]

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # Formed requests ready for row admission; bounded, since each
        # holds radix pins.
        self._ready: "queue.Queue[Optional[_Formed]]" = queue.Queue(
            maxsize=max(1, n))
        self._stats = {"admitted": 0, "completed": 0, "chunks": 0}
        self._stats_lock = threading.Lock()
        self._prefill_chunk = int(prefill_chunk)

        budget = int(mixed_token_budget) or (int(prefill_chunk)
                                             if int(prefill_chunk) > 0
                                             else 256)
        self._mixed_budget = max(1, budget)
        # Per-row chunk cap == the ragged batch's width: exactly two widths
        # occur (1 and the cap); a narrower final chunk pads.
        self._chunk_cap = max(1, min(
            int(prefill_chunk) if int(prefill_chunk) > 0 else budget,
            budget))
        self._prefilling = [False] * n
        self._row_prompt: List[Optional[np.ndarray]] = [None] * n
        self._row_prompt_toks: List[Optional[List[int]]] = [None] * n
        self._row_L = [0] * n
        self._row_w0 = [0] * n
        if self._mixed:
            self._stats["mixed"] = {
                "ticks": 0, "dispatches": 0, "prefill_tokens": 0,
                "decode_tokens": 0, "coscheduled_ticks": 0,
                "token_budget": self._mixed_budget,
                "chunk_cap": self._chunk_cap,
            }
        # Liveness: stamped at the top of every decode-loop iteration; the
        # prefill thread reports a busy-age while it forms a request.
        self._last_tick = time.monotonic()
        self._prefill_busy_since = None
        self._running = True
        self._prefill_thread = threading.Thread(
            target=self._prefill_loop, name="continuous-prefill", daemon=True)
        self._prefill_thread.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="continuous-decode", daemon=True)
        self._thread.start()

    def _init_pool(self, cfg: TransformerConfig, bs: int, kv_blocks: int,
                   kv_quantize: str, prefix_sharing: bool) -> None:
        """The paged modes' block pool, block tables and radix sharing."""
        if cfg.sliding_window is not None:
            raise ValueError("paged KV cache does not support "
                             "sliding_window models yet")
        bad = [b for b in self._prompt_buckets if b % bs]
        if bad:
            raise ValueError(
                f"kv_block_size={bs} must divide every prompt bucket "
                f"(violates {bad}); pick a power of two <= "
                f"{self._prompt_buckets[0]}")
        width = -(-self.max_seq // bs)  # blocks per full-length row
        nb = kv_blocks or self.n_slots * width + 1
        if nb < width + 1:
            raise ValueError(
                f"kv_blocks={nb} cannot hold even one max_seq row "
                f"({width} blocks + the null block)")
        self._pool = BlockPool(cfg, nb, bs, self._dtype, self.device,
                               quantize=kv_quantize)
        self._tables = np.zeros((self.n_slots, width), np.int32)
        self._prefix_sharing = prefix_sharing

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_id: int = -1, temperature: float = 0.0, seed: int = 0,
               top_p: float = 1.0, top_k: int = 0,
               repetition_penalty: float = 1.0, stop_tokens=None,
               min_p: float = 0.0, stream=None,
               deadline: Optional[Deadline] = None) -> Future:
        """Enqueue one request; the Future resolves to its generated token
        list. ``stream``: optional queue.Queue that receives fresh token
        lists as they decode, then a None sentinel. Cancelling the Future
        cancels the request. ``deadline``: the request fails with
        ``DeadlineExceeded`` once it passes (between ticks)."""
        if not self._running:
            raise RuntimeError("scheduler stopped")
        pens, stops = expand_stopping_params(1, repetition_penalty,
                                             [list(stop_tokens)]
                                             if stop_tokens else None)
        if not 0.0 <= float(min_p) <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        # Deterministic capacity clamp: the budget rule, not the
        # out-of-cache backstop, ends a row that would outgrow max_seq.
        max_new_tokens = min(int(max_new_tokens),
                             max(0, self.max_seq - 1 - len(prompt)))
        req = _Request(list(prompt), int(max_new_tokens), int(eos_id),
                       float(temperature), int(seed), float(top_p),
                       clamp_top_k(top_k), rep_penalty=pens[0],
                       stop_tokens=stops[0], min_p=float(min_p),
                       stream=stream, deadline=deadline)
        self._queue.put(req)
        return req.future

    def generate(self, prompts, max_new_tokens: int = 32, eos_id: int = -1,
                 temperature=0.0, seed=0, top_p=1.0, top_k=0,
                 repetition_penalty=1.0, stop_tokens=None,
                 min_p=0.0) -> List[List[int]]:
        """Blocking convenience over submit()."""
        n = len(prompts)
        temps, seeds, topps, topks, minps = expand_sampling_params(
            n, temperature, seed, top_p, top_k, min_p)
        pens, stops = expand_stopping_params(n, repetition_penalty,
                                             stop_tokens)
        futs = [self.submit(p, max_new_tokens, eos_id, temps[i], seeds[i],
                            topps[i], topks[i], pens[i], stops[i],
                            minps[i])
                for i, p in enumerate(prompts)]
        return [f.result(timeout=600) for f in futs]

    def stats(self) -> dict:
        now = time.monotonic()
        busy = self._prefill_busy_since
        age = max(now - self._last_tick,
                  (now - busy) if busy is not None else 0.0)
        with self._stats_lock:
            out = dict(self._stats)
            if self._mixed:
                out["mixed"] = dict(self._stats["mixed"])
        out.update(n_slots=self.n_slots,
                   active=int(sum(r is not None for r in self._row_req)),
                   last_tick_age_s=round(age, 3),
                   prefix_cache=self._prefix_cache.stats())
        if self._paged:
            out["kv_pool"] = self._pool.stats()
            out["kv_pool"]["pending_admissions"] = len(self._pending)
        return out

    def stop(self) -> None:
        self._running = False
        self._queue.put(None)  # wakes prefill; forwarded to decode via _ready
        self._prefill_thread.join(timeout=10)
        self._thread.join(timeout=10)
        while True:  # a formed item whose put landed after the decode exit
            try:
                item = self._ready.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._discard_item(item)
                self._fail_request(item.req,
                                   RuntimeError("scheduler stopped"))

    # -- helpers ---------------------------------------------------------------

    @staticmethod
    def _fail_request(req: _Request, exc: BaseException) -> None:
        """Resolve a request with an error AND end its stream."""
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass  # already resolved or cancelled
        if req.stream is not None:
            req.stream.put(None)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] = self._stats.get(key, 0) + n

    def _blocks_needed(self, pb: int, L: int) -> int:
        """Blocks an admission holds (radix-matched ones included): the
        prompt bucket's, and those of every column up to the first decode
        write plus the decode horizon."""
        bs = self._pool.block_size
        cols = min(min(L, self.max_seq - 1) + self._decode_horizon + 1,
                   self.max_seq)
        return max(pb // bs, (cols - 1) // bs + 1)

    def _free_rows(self) -> List[int]:
        return [r for r in range(self.n_slots) if self._row_req[r] is None]

    def _ensure_counts(self) -> torch.Tensor:
        if self._counts is None:
            self._counts = torch.zeros((self.n_slots, self.cfg.vocab),
                                       dtype=torch.int32, device=self.device)
        return self._counts

    def _discard_item(self, item: _Formed) -> None:
        """Release a formed-but-never-admitted item's radix pins; pins of
        a reset-away pool generation are void, not released."""
        if item.matched:
            with self._pool.lock:
                if item.gen == self._pool.generation:
                    self._pool.release_many(item.matched)

    def _release_row_blocks(self, row: int) -> None:
        """Return a freed row's block references to the pool (blocks the
        radix tree also references survive). Every row-free path
        (completion, cancel, shutdown) funnels here."""
        if not self._row_blocks[row]:
            return
        with self._pool.lock:
            self._pool.release_many(self._row_blocks[row])
        self._row_blocks[row] = []
        self._tables[row, :] = 0

    def _clear_mixed_row(self, row: int) -> None:
        self._prefilling[row] = False
        self._row_prompt[row] = None
        self._row_prompt_toks[row] = None
        self._row_L[row] = 0
        self._row_w0[row] = 0

    def _free_row(self, row: int) -> None:
        self._row_req[row] = None
        self._row_emitted[row] = []
        self._done[row] = True
        self._release_row_blocks(row)
        self._clear_mixed_row(row)

    def _visible_tokens(self, row: int, req: _Request) -> List[int]:
        """Client-visible tokens so far: budget-capped and cut at the
        first EOS or stop token — one definition for the result and the
        stream deltas."""
        return truncate_at_stops(self._row_emitted[row][:req.max_new],
                                 req.eos_id, req.stop_tokens)

    def _push_stream(self, row: int, req: _Request) -> None:
        if req.stream is None:
            return
        vis = self._visible_tokens(row, req)
        if len(vis) > req.streamed:
            req.stream.put(vis[req.streamed:])
            req.streamed = len(vis)

    def _eos_and_controls(self):
        """The rows' EOS ids ((B,), -1 for none and for free rows) and
        whether any live row has a repetition penalty or stop tokens."""
        eos_vec = np.full((self.n_slots,), -1, np.int64)
        controls = False
        for r, req in enumerate(self._row_req):
            if req is None:
                continue
            if req.eos_id >= 0:
                eos_vec[r] = req.eos_id
            if req.rep_penalty != 1.0 or req.stop_tokens:
                controls = True
        return eos_vec, controls

    def _maybe_complete(self, row: int) -> None:
        req = self._row_req[row]
        if req is None:
            return
        emitted = self._row_emitted[row]
        hit_eos = req.eos_id >= 0 and req.eos_id in emitted
        budget = len(emitted) >= req.max_new
        out_of_cache = int(self._pos[row]) >= self.max_seq - 1
        if hit_eos or budget or out_of_cache or self._done[row]:
            toks = self._visible_tokens(row, req)
            self._push_stream(row, req)
            try:
                req.future.set_result(toks)
            except InvalidStateError:
                pass  # cancelled by the client meanwhile
            if req.stream is not None:
                req.stream.put(None)
            self._free_row(row)
            self._stats["completed"] += 1

    def _cancel_rows(self) -> None:
        """Free the rows whose Future the client cancelled, or whose
        deadline passed, between ticks: their blocks return and their
        streams end (an expired row's future fails with
        DeadlineExceeded)."""
        for r, req in enumerate(self._row_req):
            if req is None:
                continue
            if req.future.cancelled():
                if req.stream is not None:
                    req.stream.put(None)
                self._free_row(r)
                self._bump("cancelled")
            elif self._expired(req, "deadline exceeded mid-generation "
                               f"({len(self._row_emitted[r])} tokens "
                               f"emitted)"):
                self._free_row(r)

    def _expired(self, req: _Request, message: str) -> bool:
        """Fail ``req`` with DeadlineExceeded if its deadline has passed
        (counted as ``deadline_cancelled``, as the JAX scheduler does)."""
        if req.deadline is None or not req.deadline.expired():
            return False
        self._bump("deadline_cancelled")
        self._fail_request(req, DeadlineExceeded(message))
        return True

    # -- prefill thread: batch formation -----------------------------------------

    def _count_admission_dispatch(self, n: int = 1) -> None:
        """Device dispatches issued by the admission side of the dense and
        two-path modes (prompt forwards and windows, prefix gathers, row
        splices and scatters), as the JAX scheduler counts them; both
        threads increment."""
        self._bump("admission_dispatches", n)

    def _prefill_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while self._running:
            req = self._queue.get()
            if req is None:
                break
            if req.future.cancelled():
                if req.stream is not None:
                    req.stream.put(None)
                self._bump("cancelled")
                continue
            if self._expired(req, "deadline expired before prefill"):
                continue
            self._prefill_busy_since = time.monotonic()
            try:
                try:
                    if not self._paged:
                        item = self._run_prefill_dense(req)
                    elif self._mixed:
                        item = self._run_prefill_mixed(req)
                    else:
                        item = self._run_prefill_paged(req)
                except Exception as exc:
                    self._fail_request(req, exc)
                    continue
                placed = False
                while self._running:
                    try:
                        self._ready.put(item, timeout=0.1)
                        placed = True
                        break
                    except queue.Full:
                        continue
                if not placed:
                    self._discard_item(item)
                    self._fail_request(req,
                                       RuntimeError("scheduler stopped"))
            finally:
                self._prefill_busy_since = None
        while True:  # shutdown: fail whatever was never formed
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                self._fail_request(req, RuntimeError("scheduler stopped"))
        try:
            self._ready.put_nowait(None)  # propagate shutdown to decode loop
        except queue.Full:
            pass

    def _run_prefill_mixed(self, req: _Request) -> _Formed:
        """Pick the bucket, take the radix pins, precompute the penalty
        counts. No device work: the prompt's forward runs inside the
        decode thread's ragged ticks."""
        pool = self._pool
        pb = pick_bucket(self._prompt_buckets, len(req.prompt))
        prompt = req.prompt[-pb:]
        matched: List[int] = []
        with pool.lock:
            gen = pool.generation
            if self._prefix_sharing:
                matched = pool.radix.lookup(prompt)  # pins for this row
        row_counts = None
        if req.rep_penalty != 1.0 or req.stop_tokens:
            # Prompt-token counts only; the first sampled token joins in
            # the tick that samples it.
            row_counts = token_counts([prompt], 1, self.cfg.vocab)
        return _Formed(req, pb, len(prompt), row_counts, matched, prompt,
                       gen)

    def _first_token(self, req: _Request, logits, prompt, L: int):
        """Sample the request's first token from its prefill logits (V,) at
        logical position L, penalized by the prompt's token counts.
        Returns (first_tok, row_counts or None; the counts include the
        first token)."""
        row_counts = None
        first_logits = logits[None, :]
        if req.rep_penalty != 1.0 or req.stop_tokens:
            row_counts = token_counts([prompt], 1, self.cfg.vocab)
            if req.rep_penalty != 1.0:
                first_logits = apply_repetition_penalty(
                    first_logits,
                    torch.from_numpy(row_counts).to(self.device),
                    torch.tensor([req.rep_penalty], dtype=torch.float32,
                                 device=self.device))
        first = _sample(first_logits, [int(req.seed) & 0x7FFFFFFF], [L],
                        [req.temperature], [req.top_p], [req.top_k],
                        [req.min_p])
        first_tok = int(first[0])
        if row_counts is not None:
            row_counts[0, first_tok] += 1  # the first token joins the context
        return first_tok, row_counts

    def _run_prefill_dense(self, req: _Request) -> _Formed:
        """Dense admission prefill (prefill thread): the prompt LEFT-padded
        to its bucket, so it ends at column pb - 1 and positions count from
        its first token at column pb - L. An exact repeat of (bucket,
        prompt) takes the prefix cache's logits and row cache; otherwise
        the forward runs on the request's own (L, 1, pb, H_kv, D) row
        cache: windows of ``prefill_chunk`` when that is narrower than the
        bucket (interior windows skip the LM head), else one
        ``transformer_prefill``. Then the first token."""
        pb = pick_bucket(self._prompt_buckets, len(req.prompt))
        prompt = req.prompt[-pb:]
        L = len(prompt)
        tokens = np.zeros((1, pb), np.int32)
        attn = np.zeros((1, pb), np.int32)
        pos_ids = np.zeros((1, pb), np.int32)
        tokens[0, pb - L:] = prompt
        attn[0, pb - L:] = 1
        pos_ids[0, pb - L:] = np.arange(L)
        # L is part of the key: token id 0 is a real token, so [5] and
        # [0, 5] pad to the same bytes at one bucket. Take the cache object
        # once, as the JAX scheduler does.
        prefix_cache = self._prefix_cache
        cached = None
        if prefix_cache.budget > 0:
            key = (pb, L, tokens.tobytes())
            cached = prefix_cache.get(key)
        if cached is not None:
            logits, row_caches = cached
        else:
            dev = self.device
            tok_t = torch.from_numpy(tokens).to(dev)
            row_caches = init_caches(self.cfg, 1, pb, self._dtype, dev)
            w = self._prefill_chunk
            if 0 < w < pb:
                start_vec = torch.tensor([pb - L], dtype=torch.int32,
                                         device=dev)
                starts = list(range(0, pb, w))
                for w0 in starts:
                    wlog, row_caches = transformer_decode_window(
                        self.params, tok_t[:, w0:w0 + w], row_caches,
                        torch.tensor([w0], dtype=torch.int32, device=dev),
                        self.cfg, dtype=self._dtype, start_vec=start_vec,
                        head="last" if w0 == starts[-1] else "none")
                self._count_admission_dispatch(len(starts))
                logits = wlog[0, -1]
            else:
                logits, row_caches = transformer_prefill(
                    self.params, tok_t, row_caches, self.cfg,
                    dtype=self._dtype,
                    attn_mask=torch.from_numpy(attn).to(dev),
                    pos_ids=torch.from_numpy(pos_ids).to(dev))
                logits = logits[0]
                self._count_admission_dispatch()
            if prefix_cache.budget > 0:
                prefix_cache.put(key, logits, row_caches)
        first_tok, row_counts = self._first_token(req, logits, prompt, L)
        return _Formed(req, pb, L, row_counts, [], prompt, 0, row_caches,
                       first_tok)

    def _run_prefill_paged(self, req: _Request) -> _Formed:
        """Two-path admission prefill (prefill thread): radix
        longest-prefix match, a gather of the matched blocks into the
        request's own 0-aligned (L, 1, pb, H_kv, D) row cache (dequantized
        to the compute dtype for the int8 pool; the fresh prompt K/V stays
        in that dtype through the windows), prefill windows resumed at the
        block boundary at or below the match, and the first token. The
        radix lookup and the gather run under the pool lock: the gather is
        issued in the lock's order with the decode thread's pool writes."""
        pool = self._pool
        bs = pool.block_size
        pb = pick_bucket(self._prompt_buckets, len(req.prompt))
        prompt = req.prompt[-pb:]
        L = len(prompt)
        Leff = max(L, 1)  # empty prompts sample from the zero-token column
        tokens = torch.from_numpy(right_pad_prompt(prompt, pb)).to(
            self.device)
        matched: List[int] = []
        with pool.lock:
            gen = pool.generation
            if self._prefix_sharing:
                matched = pool.radix.lookup(prompt)  # pins for this row
        try:
            if matched:
                # The gather is the row cache on a hit: matched columns
                # carry the shared prefix, the rest null-block values the
                # windows overwrite or the position mask hides.
                ids = np.zeros((pb // bs,), np.int64)
                ids[:len(matched)] = matched
                ids_t = torch.from_numpy(ids).to(self.device)
                with pool.lock:
                    if pool.quantized:
                        row_caches = gather_blocks_quant(
                            pool.caches.k, pool.caches.v, pool.scales.k,
                            pool.scales.v, ids_t, dtype=self._dtype)
                    else:
                        row_caches = gather_blocks(pool.caches.k,
                                                   pool.caches.v, ids_t)
                self._count_admission_dispatch()
            else:
                row_caches = init_caches(self.cfg, 1, pb, self._dtype,
                                         self.device)
            # Resume at the block boundary at/below the match; the window
            # holding position L-1 always runs, so the first sample's
            # logits come from this request's own forward.
            w = self._prefill_chunk if 0 < self._prefill_chunk < pb else pb
            p0 = (min(len(matched) * bs, Leff - 1) // bs) * bs
            zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
            logits = None
            w0 = p0
            while w0 <= Leff - 1:
                width = min(w, pb - w0)
                head = "all" if w0 <= Leff - 1 < w0 + width else "none"
                wlog, row_caches = transformer_decode_window(
                    self.params, tokens[:, w0:w0 + width], row_caches,
                    zero + w0, self.cfg, dtype=self._dtype, start_vec=zero,
                    head=head)
                self._count_admission_dispatch()
                if head == "all":
                    logits = wlog[0, Leff - 1 - w0]
                w0 += width
            with pool.lock:
                pool.prefix_hit_tokens += p0
                pool.prefilled_tokens += Leff - p0
            first_tok, row_counts = self._first_token(req, logits, prompt, L)
        except BaseException:
            if matched:
                with pool.lock:
                    if pool.generation == gen:  # void after a pool reset
                        pool.release_many(matched)
            raise
        return _Formed(req, pb, L, row_counts, matched, prompt, gen,
                       row_caches, first_tok)

    # -- decode thread -----------------------------------------------------------

    def _admit(self, item: _Formed, row: int) -> None:
        if not self._paged:
            self._admit_dense(item, row)
        elif self._mixed:
            self._admit_mixed(item, row)
        else:
            self._admit_paged(item, row)

    def _set_row_params(self, req: _Request, row: int, pos: int,
                        start: int = 0) -> None:
        """Per-row sampling and stopping state, shared by every admission.
        ``start``: the row's first valid cache column (dense rows)."""
        self._pos[row] = pos
        self._start[row] = start
        self._seeds[row] = int(req.seed) & 0x7FFFFFFF
        self._temps[row] = req.temperature
        self._topps[row] = req.top_p
        self._topks[row] = req.top_k
        self._minps[row] = req.min_p
        self._pens[row] = req.rep_penalty
        self._stops[row] = -1
        self._stops[row, :len(req.stop_tokens)] = req.stop_tokens
        self._row_req[row] = req
        self._stats["admitted"] += 1

    def _set_row_table(self, row: int, table: List[int],
                       row_counts) -> None:
        self._tables[row, :] = 0
        self._tables[row, :len(table)] = table
        self._row_blocks[row] = table
        if row_counts is not None:
            self._ensure_counts()[row] = torch.as_tensor(
                row_counts[0], device=self.device)

    def _emit_first_token(self, item: _Formed, row: int) -> None:
        """A prefilled row's first token, at admission: emitted, streamed,
        and the row completes at once if it ends there."""
        req, first_tok = item.req, item.first_tok
        self._tok[row] = first_tok
        self._row_emitted[row] = [first_tok]
        self._done[row] = ((req.eos_id >= 0 and first_tok == req.eos_id)
                           or first_tok in req.stop_tokens)
        self._push_stream(row, req)  # the first token flushes at admission
        self._maybe_complete(row)

    def _admit_dense(self, item: _Formed, row: int) -> None:
        """Dense admission (decode thread): copy the row cache into columns
        [0, pb) of the row in the shared cache (a copy, so a prefix-cache
        entry is never the tensor a later write lands in), with the row's
        token counts when it has controls; the row decodes from column pb
        with start pb - L."""
        req, pb, L, row_counts = item[:4]
        rc = item.row_caches
        self._caches.k[:, row, :pb] = rc.k[:, 0]
        self._caches.v[:, row, :pb] = rc.v[:, 0]
        if row_counts is not None:
            self._ensure_counts()[row] = torch.as_tensor(
                row_counts[0], device=self.device)
        self._count_admission_dispatch()
        self._set_row_params(req, row, pb, start=pb - L)
        self._emit_first_token(item, row)

    def _admit_paged(self, item: _Formed, row: int) -> None:
        """Two-path admission (decode thread): allocate the bucket's fresh
        blocks and the first chunk's (radix-matched prefix blocks enter the
        table pinned), make the append block private, scatter the row
        cache into the fresh blocks (quantizing it there for the int8
        pool; matched slots scatter into the null block, so shared bytes
        are never rewritten), index the prompt's full blocks in the radix
        tree and emit the first token. Raises PoolExhausted (nothing
        consumed) to defer under pool pressure."""
        req, pb, L, row_counts, matched = item[:5]
        pool = self._pool
        bs = pool.block_size
        nb_bucket = pb // bs
        m = len(matched)
        first_col = min(L, self.max_seq - 1)  # first decode write column
        with pool.lock:
            if item.gen != pool.generation:
                raise _StaleAdmission(
                    "kv pool was rebuilt during this request's admission")
            # PoolExhausted -> the admission defers
            fresh = pool.alloc(self._blocks_needed(pb, L) - m)
            ids = np.zeros((nb_bucket,), np.int64)
            ids[m:] = fresh[:nb_bucket - m]  # matched slots -> null block
            table = list(matched) + fresh
            try:
                wid, copied = pool.ensure_writable(table[first_col // bs])
            except PoolExhausted:
                pool.release_many(fresh)
                raise
            if copied:
                table[first_col // bs] = wid
            ids_t = torch.from_numpy(ids).to(self.device)
            rc = item.row_caches
            if pool.quantized:
                scatter_blocks_quant(pool.caches, pool.scales, rc.k, rc.v,
                                     ids_t)
            else:
                scatter_blocks(pool.caches, rc.k, rc.v, ids_t)
            if self._prefix_sharing:
                pool.radix.insert(item.prompt, table)
        self._count_admission_dispatch()
        self._set_row_table(row, table, row_counts)
        self._set_row_params(req, row, first_col)
        self._emit_first_token(item, row)

    def _admit_mixed(self, item: _Formed, row: int) -> None:
        """Allocate the bucket's blocks up front (radix-matched prefix
        blocks enter the table pinned), make the two write targets
        private, and mark the row PREFILLING: the prompt's forward runs
        chunk by chunk in the following ticks. Raises PoolExhausted
        (nothing consumed) to defer under pool pressure."""
        req, pb, L, row_counts, matched = item[:5]
        pool = self._pool
        bs = pool.block_size
        m = len(matched)
        Leff = max(L, 1)
        first_col = min(L, self.max_seq - 1)  # first decode write column
        # Resume at the block boundary at/below the radix match; the last
        # prompt block always recomputes, so the first sample's logits come
        # from this row's own forward.
        p0 = (min(m * bs, Leff - 1) // bs) * bs
        with pool.lock:
            if item.gen != pool.generation:
                raise _StaleAdmission(
                    "kv pool was rebuilt during this request's admission")
            # PoolExhausted -> the admission defers
            fresh = pool.alloc(self._blocks_needed(pb, L) - m)
            table = list(matched) + fresh
            # Blocks this row will WRITE must be private: the resumed
            # window's first block (shared only on a whole-prompt match)
            # and the decode append block.
            try:
                for bi in sorted({p0 // bs, first_col // bs}):
                    wid, copied = pool.ensure_writable(table[bi])
                    if copied:
                        table[bi] = wid
            except PoolExhausted:
                pool.release_many(fresh)
                raise
            pool.prefix_hit_tokens += p0
            pool.prefilled_tokens += Leff - p0
        self._set_row_table(row, table, row_counts)
        self._set_row_params(req, row, first_col)
        self._prefilling[row] = True
        self._row_prompt[row] = right_pad_prompt(item.prompt, pb)[0]
        self._row_prompt_toks[row] = item.prompt
        self._row_L[row] = L
        self._row_w0[row] = p0
        self._row_emitted[row] = []
        self._done[row] = False

    def _ensure_capacity_paged(self) -> None:
        """Block growth before a tick or chunk: every live decode row must
        own the blocks of the columns it may write next (its decode
        horizon). A row the pool cannot grow, even after radix eviction,
        completes early with the tokens it has (counted
        ``pool_starved``)."""
        pool = self._pool
        bs = pool.block_size
        for r, req in enumerate(self._row_req):
            if req is None or self._done[r] or self._prefilling[r]:
                continue
            last_col = min(int(self._pos[r]) + self._decode_horizon,
                           self.max_seq - 1)
            need = last_col // bs + 1
            have = len(self._row_blocks[r])
            if need <= have:
                continue
            try:
                with pool.lock:
                    fresh = pool.alloc(need - have)
            except PoolExhausted:
                self._bump("pool_starved")
                self._done[r] = True
                self._maybe_complete(r)
                continue
            self._tables[r, have:need] = fresh
            self._row_blocks[r].extend(fresh)

    def _complete_prefill_row(self, r: int, req: _Request, first_tok: int,
                              done: bool) -> None:
        """Prompt consumed: index the filled prompt blocks in the radix
        tree (at completion, never earlier), then emit the first token."""
        self._prefilling[r] = False
        if self._prefix_sharing:
            with self._pool.lock:
                self._pool.radix.insert(self._row_prompt_toks[r],
                                        self._row_blocks[r])
        self._tok[r] = first_tok
        self._done[r] = done
        self._row_emitted[r] = [first_tok]
        self._push_stream(r, req)
        self._maybe_complete(r)

    def _tick_mixed(self) -> None:
        """One mixed tick: form the ragged batch (decode rows x 1 token +
        admitting rows x a budgeted prefill chunk), issue exactly ONE
        forward, sample, and apply the results host-side. Decode rows are
        always included; the remaining budget splits over prefilling rows
        in row order, and the first prefilling row always gets at least
        one token, so admission never deadlocks behind a full batch."""
        pool = self._pool
        B = self.n_slots
        eos_vec, controls = self._eos_and_controls()
        n_decode = 0
        prefill_rows: List[int] = []
        for r, req in enumerate(self._row_req):
            if req is None:
                continue
            if self._prefilling[r]:
                prefill_rows.append(r)
            else:
                n_decode += 1
        budget_left = max(1, self._mixed_budget - n_decode)
        chunk = np.zeros((B,), np.int32)
        for r in prefill_rows:
            remaining = max(self._row_L[r], 1) - self._row_w0[r]
            c = min(remaining, self._chunk_cap, budget_left)
            chunk[r] = max(0, c)
            budget_left -= chunk[r]
        width = self._chunk_cap if prefill_rows and chunk.max() > 0 else 1

        tokens = np.zeros((B, width), np.int32)
        pos0 = np.zeros((B,), np.int32)
        qlen = np.zeros((B,), np.int32)
        sample_slot = np.zeros((B,), np.int32)
        fold_pos = np.zeros((B,), np.int64)
        active = np.zeros((B,), bool)
        completing = [False] * B
        prefill_tokens = 0
        for r, req in enumerate(self._row_req):
            if req is None:
                continue  # free rows: qlen 0, inactive, null-block writes
            if self._prefilling[r]:
                w0 = self._row_w0[r]
                c = int(chunk[r])
                Leff = max(self._row_L[r], 1)
                pos0[r] = w0
                qlen[r] = c
                prefill_tokens += c
                if c > 0:
                    tokens[r, :c] = self._row_prompt[r][w0:w0 + c]
                    if w0 <= Leff - 1 < w0 + c:
                        # The chunk reaches the prompt's last token: sample
                        # the FIRST token from slot Leff-1-w0 at logical
                        # position L.
                        completing[r] = True
                        active[r] = True
                        sample_slot[r] = Leff - 1 - w0
                        fold_pos[r] = self._row_L[r]
            else:
                pos0[r] = self._pos[r]
                qlen[r] = 1
                tokens[r, 0] = self._tok[r]
                fold_pos[r] = int(self._pos[r]) + 1
                active[r] = not self._done[r]

        # ONE forward. The pool lock is not held: in mixed mode only this
        # thread touches the pool tensors (the prefill thread's radix
        # lookups are host bookkeeping).
        dev = self.device
        logits = transformer_step_rows_ragged(
            self.params, torch.from_numpy(tokens).to(dev), pool.caches,
            torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(qlen).to(dev),
            self.cfg, dtype=self._dtype,
            sample_slot=torch.from_numpy(sample_slot).to(dev),
            scales=pool.scales)[0]
        if controls:
            logits = apply_repetition_penalty(
                logits, self._ensure_counts(),
                torch.from_numpy(self._pens).to(dev))
        nxt = _sample(logits, self._seeds, fold_pos, self._temps,
                      self._topps, self._topks, self._minps)
        nxt = nxt.cpu().numpy()  # the tick's host sync
        live = active & ~self._done
        nxt = np.where(live, nxt, eos_vec)
        if controls and live.any():
            rows = np.nonzero(live)[0]
            self._counts.index_put_(
                (torch.from_numpy(rows).to(dev),
                 torch.from_numpy(nxt[rows]).to(dev)),
                torch.ones(len(rows), dtype=torch.int32, device=dev),
                accumulate=True)
        done_new = self._done | (live & (nxt == eos_vec))
        if controls:
            done_new |= live & np.any(nxt[:, None] == self._stops, axis=1)
        # Dispatch counted past the host sync (a failed step surfaces
        # there and must leave dispatches == ticks); a separate site from
        # the tick counter below.
        with self._stats_lock:
            self._stats["mixed"]["dispatches"] += 1

        with self._stats_lock:
            m = self._stats["mixed"]
            m["ticks"] += 1
            m["prefill_tokens"] += prefill_tokens
            m["decode_tokens"] += n_decode
            if prefill_tokens and n_decode:
                m["coscheduled_ticks"] += 1

        for r in range(B):
            req = self._row_req[r]
            if req is None:
                continue
            if self._prefilling[r]:
                self._row_w0[r] += int(chunk[r])
                if completing[r]:
                    self._complete_prefill_row(r, req, int(nxt[r]),
                                               bool(done_new[r]))
                continue
            tok_r = int(nxt[r])
            self._tok[r] = tok_r
            self._done[r] = bool(done_new[r])
            if not self._done[r]:
                self._pos[r] = min(int(self._pos[r]) + 1, self.max_seq - 1)
            if req.max_new - len(self._row_emitted[r]) > 0:
                self._row_emitted[r].append(tok_r)
            self._push_stream(r, req)
            self._maybe_complete(r)

    def _decode_step_fn(self):
        """One decode step of every row, (tok, pos, start) -> logits: over
        the dense cache (``transformer_decode_rows``), or over the block
        pool (``transformer_decode_rows_paged``, rows 0-aligned) with the
        step's pool writes issued under the pool lock, so a prefix gather
        the prefill thread issues runs between two steps, never across
        one; taking the lock per step, not per chunk, lets the prefill
        thread's lookups and gathers in between."""
        if not self._paged:
            def step(tok, pos, start):
                return transformer_decode_rows(
                    self.params, tok, self._caches, pos, self.cfg,
                    dtype=self._dtype, start_vec=start)[0]
            return step
        pool = self._pool
        tables = torch.from_numpy(self._tables).to(self.device)

        def step(tok, pos, start):
            with pool.lock:
                return transformer_decode_rows_paged(
                    self.params, tok, pool.caches, tables, pos, self.cfg,
                    dtype=self._dtype, scales=pool.scales)[0]
        return step

    def _decode_chunk(self) -> None:
        """One decode chunk (dense and two-path modes): ``step_chunk``
        steps over every row, each sampled on the device at logical
        position pos + 1 - start (positions stay there), then ONE host sync
        for the chunk's tokens. Done and free rows ride along masked: their
        sampled tokens become their EOS id (or -1), their position stays,
        and their writes land in their own next column (dense; a column
        past the cache is dropped) or the null block (paged). Only live
        rows advance, never past the last cache column."""
        dev = self.device
        eos_vec, controls = self._eos_and_controls()
        max_col = self.max_seq - 1
        step = self._decode_step_fn()
        tok = torch.from_numpy(self._tok.astype(np.int64)).to(dev)
        pos = torch.from_numpy(self._pos.copy()).to(dev)
        start = torch.from_numpy(self._start.copy()).to(dev)
        done = torch.from_numpy(self._done.copy()).to(dev)
        seeds = torch.from_numpy(self._seeds).to(dev)
        eos = torch.from_numpy(eos_vec).to(dev)
        if controls:
            counts = self._ensure_counts()
            pens = torch.from_numpy(self._pens).to(dev)
            stops = torch.from_numpy(self._stops.astype(np.int64)).to(dev)
            rows = torch.arange(self.n_slots, device=dev)
        toks = []
        for _ in range(self._step_chunk):
            logits = step(tok, pos, start)
            if controls:
                logits = apply_repetition_penalty(logits, counts, pens)
            nxt = _sample(logits, seeds, pos + 1 - start, self._temps,
                          self._topps, self._topks, self._minps)
            nxt = torch.where(done, eos, nxt)
            if controls:
                counts.index_put_((rows, nxt), (~done).to(torch.int32),
                                  accumulate=True)
            done = done | (nxt == eos)
            if controls:
                done = done | (nxt[:, None] == stops).any(dim=1)
            pos = torch.where(done, pos, torch.clamp(pos + 1, max=max_col))
            tok = nxt
            toks.append(nxt)
        host = torch.cat([pos.long(), done.long(),
                          torch.stack(toks, 1).flatten()]).cpu().numpy()
        n = self.n_slots  # the chunk's host sync, above
        self._pos = host[:n].astype(np.int32)
        self._done = host[n:2 * n].astype(bool)
        toks_host = host[2 * n:].reshape(n, self._step_chunk)
        self._tok = toks_host[:, -1].astype(np.int32)
        self._stats["chunks"] += 1
        for r, req in enumerate(self._row_req):
            if req is None:
                continue
            need = req.max_new - len(self._row_emitted[r])
            if need > 0:
                self._row_emitted[r].extend(
                    int(t) for t in toks_host[r, :need])
            self._push_stream(r, req)  # fresh tokens flush per chunk
            self._maybe_complete(r)

    def _recover(self, exc: BaseException) -> None:
        """Device-step failure: the cache or pool may hold half-written
        columns, so every in-flight row fails with a RETRYABLE error
        carrying ``tokens_emitted`` (a client can resume elsewhere from
        that prefix), the dense cache or the pool is rebuilt, and the loop
        keeps serving."""
        for r, req in enumerate(self._row_req):
            if req is not None:
                n_emitted = len(self._visible_tokens(r, req))
                row_exc = RuntimeError(
                    f"row {r} lost to a device-step failure after "
                    f"{n_emitted} emitted tokens: {exc}")
                row_exc.retryable = True
                row_exc.tokens_emitted = n_emitted
                row_exc.__cause__ = exc
                self._fail_request(req, row_exc)
            self._row_req[r] = None
            self._row_emitted[r] = []
            self._clear_mixed_row(r)
        self._pos[:] = 0
        self._start[:] = 0
        self._tok[:] = 0
        self._done[:] = True
        self._bump("failures")
        self._counts = None
        if not self._paged:
            self._caches = init_caches(self.cfg, self.n_slots, self.max_seq,
                                       self._dtype, self.device)
            return
        with self._pool.lock:
            self._pool.reset()
            pool = self._pool
            violations = []
            if len(pool._free) != pool.num_blocks - 1:
                violations.append(f"free list {len(pool._free)} != "
                                  f"{pool.num_blocks - 1}")
            if pool.radix.nodes != 0:
                violations.append(
                    f"radix not empty ({pool.radix.nodes} nodes)")
            if int(np.sum(pool._ref[1:])) != 0:
                violations.append("nonzero refcounts after reset")
        self._tables[:, :] = 0
        for r in range(self.n_slots):
            self._row_blocks[r] = []
        if violations:
            self._bump("recover_invariant_violations", len(violations))
            print(f"[scheduler] POST-RECOVER INVARIANT VIOLATED: "
                  f"{'; '.join(violations)}", flush=True)

    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._loop_body()
        finally:
            # Mark the scheduler dead FIRST (submit fails fast, the
            # prefill thread's bounded put stops retrying), then fail every
            # in-flight row and every formed item still queued.
            self._running = False
            exc = RuntimeError("scheduler stopped")
            for r, req in enumerate(self._row_req):
                if req is not None:
                    self._fail_request(req, exc)
                self._free_row(r)
            while self._pending:
                item = self._pending.popleft()
                self._discard_item(item)
                self._fail_request(item.req, exc)
            while True:
                try:
                    item = self._ready.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._discard_item(item)
                    self._fail_request(item.req, exc)

    def _loop_body(self) -> None:
        while self._running:
            self._last_tick = time.monotonic()  # liveness heartbeat
            self._cancel_rows()
            # Live rows' block growth outranks new admissions.
            if self._paged:
                self._ensure_capacity_paged()
            free = self._free_rows()
            admitted_any = False
            while free:
                from_pending = bool(self._pending)
                if from_pending:
                    item = self._pending[0]
                else:
                    try:
                        item = self._ready.get(
                            timeout=0.02 if not admitted_any
                            and len(free) == self.n_slots else 0.0)
                    except queue.Empty:
                        break
                if item is None:
                    return
                req = item.req
                if req.future.cancelled():
                    if from_pending:
                        self._pending.popleft()
                    self._discard_item(item)
                    if req.stream is not None:
                        req.stream.put(None)
                    self._bump("cancelled")
                    continue
                if self._expired(req, "deadline expired before row "
                                 "admission"):
                    if from_pending:
                        self._pending.popleft()
                    self._discard_item(item)
                    continue
                try:
                    self._admit(item, free[0])
                    free.pop(0)
                    if from_pending:
                        self._pending.popleft()
                    admitted_any = True
                except PoolExhausted:
                    # A request larger than the whole pool can never
                    # admit: fail it; otherwise park it until completions
                    # free blocks.
                    nb_need = self._blocks_needed(item.pb, item.L)
                    if nb_need > self._pool.num_blocks - 1:
                        if from_pending:
                            self._pending.popleft()
                        self._discard_item(item)
                        self._fail_request(req, ValueError(
                            f"prompt needs {nb_need} KV blocks but the "
                            f"pool holds {self._pool.num_blocks - 1}"))
                        continue
                    if not from_pending:
                        # Park WITHOUT the radix pins: pinned parked items
                        # could starve each other forever. A two-path item
                        # already holds the gathered prefix in its row
                        # cache; a mixed one re-prefills from position 0.
                        self._discard_item(item)
                        self._pending.append(item._replace(matched=[]))
                    if all(r is None for r in self._row_req):
                        time.sleep(0.005)
                    break
                except _StaleAdmission as exc:
                    if from_pending:
                        self._pending.popleft()
                    self._fail_request(req, exc)
                    continue
                except Exception as exc:
                    # A failed admission may have half-copied a COW block:
                    # treat it as a device-state loss.
                    if from_pending:
                        self._pending.popleft()
                    self._fail_request(req, exc)
                    self._recover(exc)
                    break
            if all(r is None for r in self._row_req):
                continue
            try:
                if self._mixed:
                    self._tick_mixed()
                else:
                    self._decode_chunk()
            except Exception as exc:
                self._recover(exc)
