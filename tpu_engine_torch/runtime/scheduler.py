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
  blocks, and with a host tier swaps demoted ones back in) and penalty
  counts, no forward. The decode thread admits
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
- **Continuous speculation** (paged, ``spec_k`` > 0, in either mode).
  Each tick a drafter (``runtime.speculative``: n-gram prompt lookup, or a
  draft model) proposes up to ``spec_k`` tokens per eligible decode row,
  and ONE ragged forward (``transformer_step_rows_ragged`` with
  ``sample_width`` spec_k + 1) scores every row's verify window: decode
  rows carry [last token, proposals] (q_len = proposals + 1) beside the
  mixed mode's prefill chunks. An S-slot accept/emit loop on the device
  re-derives each token with the plain tick's ``_sample(fold_in(seed,
  position))`` rule (penalty counts and stop lists evolving slot by
  slot) and chains while the draft matches; drafted rows at temperature
  > 0 without filters or controls take the rejection rule instead. Rows
  advance 1..spec_k + 1 tokens a tick with one host copy of (tokens,
  emitted, accepted, done). Greedy streams are the plain lane's for any
  draft. A rejected tail's K/V stays past ``pos``, hidden by the position
  mask and overwritten before it is read; blocks past a row's reachable
  horizon return to the pool (``_trim_row_tail``). In two-path mode the
  prefill thread still admits prompts; spec ticks replace the decode
  chunks.
- Invariants kept from the JAX scheduler: mixed (and spec) ticks and
  dispatches are counted at separate sites and stay equal; a prompt's
  blocks enter the radix tree only once they are filled (a cancelled
  mid-prefill row never leaves half-written blocks indexed); every
  row-free path returns the row's blocks.

A request is cancelled by cancelling the Future ``submit`` returned: its
row frees between ticks (chunks) and its stream ends. A request submitted
with a ``Deadline`` is failed with ``DeadlineExceeded`` where the JAX
scheduler fails it: before its prefill, before its row admission, or
between ticks once the deadline passes mid-generation (the cancel path
above; tokens already streamed stand).

One-shot rows (``submit_infer``, ``submit_score``) ride the same loop as
single-tick rows: each iteration, before the generative step, drains up to
``n_slots`` pending one-shot requests, drops those whose deadline passed,
and runs one grouped dispatch per kind (the engine's batched forward, the
scorer's teacher-forced forward); a failed dispatch fails its group only.
A stateless-family model (mlp, resnet) builds a lane whose rows are all
one-shot.

Paged lanes also carry the JAX scheduler's host KV tier
(``kv_host_blocks``: cold radix blocks demote to host memory, and a radix
lookup swaps them back in while the live-row reserve allows) and live-row
migration: ``export_row`` quiesces a row between ticks and snapshots its
stream state and KV chain (``kv_blocks`` wire format), ending the local
stream with ``StreamMigratedAway``; ``submit_import`` adopts such a
snapshot on another lane with zero re-prefilled tokens, or fails with a
retryable ``ImportRefused``. The disaggregated handoff: a request
submitted with ``handoff`` parks after prefill (first token emitted, the
row riding every tick inactive) until ``export_row(wait_prefill=True)``
ships it, ``export_row(cancel=True)`` releases it, or its park window
passes and it decodes locally. The fleet prefix tier: ``export_prefix``
serves a peer the longest radix chain of a token prefix,
``prefix_fingerprints`` summarises the deepest chains for the gateway's
directory, and a miss carrying a ``prefix_hint`` fetches the hinted
peer's chain (the ``prefix_fetch`` callable the worker installs) and
splices it past the local match before prefilling the rest
(``_fetch_prefix_splice``; every failure prefills locally).

Tensor-parallel serving (``tp`` > 1, paged only, the kv_paged family):
the model is sharded by the registry's rule over ``tp`` ranks
(``models.registry.tp_rank_trees``; one rank per entry of ``tp_devices``,
by default the first ``tp`` CUDA devices) and the pool shards its H_kv
axis (``BlockPool(tp_devices=...)``). The lane is still one scheduler: a
tick is one forward, counted as one dispatch, in which each rank runs the
attention kernel on its own heads and pool shard, per layer
(``models.transformer.TPParams``), so a tick launches tp x layers
kernels. Prefill windows, gathers, scatters, the host tier and the chain
wire work per shard; sampling runs on the gathered logits on rank 0's
device, where the drafter's model also lives. ``stats()`` carries the
topology label under ``tp``.

The state_slab family (``models.ssd``: mamba2, ssd-small-test) runs the
same loop over a ``StateSlabPool`` instead of a KV cache: one fixed-size
f32 state row per stream, allocated at admission, freed on every row-free
path, the null row 0 under free slots. Two-path: the prefill thread runs
the prompt through ``ssd_window_scan_rows`` in ``prefill_chunk`` windows
from a zero state of its own, the admission writes it into the row, and
decode chunks take one-slot window scans over the slab. Mixed: admission
zeroes the row, and each tick's ONE window scan advances decode rows one
slot and admitting rows their budgeted chunk, in place. A done or parked
row rides every scan with qlen 0, its state frozen. Each window scan is
one ``ops.ssd.ssd_scan`` per layer (the kernel on the card). Rows defer
under row exhaustion; a row exports as a one-pseudo-block chain
(``state_export``) and imports verbatim (``state_import``), with zero
re-prefilled tokens, for migration and the disaggregated handoff. The
family refuses the KV knobs, speculation and tensor parallelism with the
JAX scheduler's messages.

Brownout (``set_brownout``, driven by the worker's overload control
loop) degrades the work's shape, never a stream's content: the mixed
tick's token budget and the one-shot rows a tick drains scale by
``budget_frac`` (floored at 1; the ragged batch's width, the chunk cap,
is untouched), ``suspend_spec`` stops the drafter (every decode row rides
the verify tick at q_len 1, so greedy streams are unchanged), and
``defer_swap_in`` makes radix lookups stop at the resident prefix
instead of promoting demoted blocks (counted as ``swap_in_deferred``).
``stats()["brownout"]`` is present only while a degradation is engaged.

Observability, as in the JAX scheduler. A request submitted with a
``utils.tracing.TraceSink`` gets stage spans: ``queue_wait`` (submit to
formation; one-shot rows: to their tick), ``prefill`` (dense and two-path:
the formation forward; mixed: admission to prompt completion),
``swap_in`` and ``radix_lookup`` (paged formation), ``kv_alloc`` or
``kv_import`` (paged admission), ``decode`` (admission or prompt
completion to completion), and on one-shot rows ``batch_form`` and
``device_compute``. With ``tracer`` set, each mixed tick records a
``mixed_step`` span and each speculative tick a ``spec_verify`` span (and
a ``mixed_step`` in mixed mode), so those spans equal the ticks in
``stats()``. ``ttft_hist`` and ``itl_hist`` take each row's first token
and the gap between its deliveries. Every span closes after the host
sync its tick or chunk already makes. ``configure_flight_recorder`` arms
a ring of per-tick records (``flight_timeline``, ``flight_dump``; a
burst of four deadline misses in 10 s or a ``_recover`` dumps it), and
``start_profile`` runs a ``torch.profiler`` capture over the next N
decode-loop iterations (or until ``stop_profile``), opened and closed on
the decode thread, so the trace holds its CPU ops and the card's
kernels. With
``trace_stitch`` an export snapshot carries the stream's ``traceparent``
and its chain a ``trace`` header.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from tpu_engine_torch.models.registry import (
    ModelSpec,
    create_model,
    tp_rank_trees,
    tp_unshardable_reason,
)
from tpu_engine_torch.models.ssd import (
    SSDConfig,
    ssd_state_dim,
    ssd_window_scan_rows,
)
from tpu_engine_torch.models.transformer import (
    KVCache,
    TPParams,
    TransformerConfig,
    init_caches,
    tp_init_caches,
    transformer_decode_rows,
    transformer_decode_rows_paged,
    transformer_decode_window,
    transformer_prefill,
    transformer_step_rows_ragged,
)
from tpu_engine_torch.parallel.mesh import (
    TPGroup,
    tp_devices as resolve_tp_devices,
    tp_topology_label,
)
from tpu_engine_torch.runtime.generator import (
    _sample,
    apply_repetition_penalty,
    pick_bucket,
    power_of_two_buckets,
    right_pad_prompt,
    token_counts,
)
from tpu_engine_torch.runtime.kv_blocks import (
    BlockPool,
    PoolExhausted,
    StateSlabPool,
    gather_blocks,
    gather_blocks_quant,
    scatter_blocks,
    scatter_blocks_quant,
)
from tpu_engine_torch.runtime.speculative import (
    _TAG_ACCEPT,
    _TAG_RESID,
    make_drafter,
    tagged_categorical,
    tagged_uniform,
)
from tpu_engine_torch.utils.deadline import Deadline, DeadlineExceeded
from tpu_engine_torch.utils import tracing
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype
from tpu_engine_torch.utils.metrics import LatencyHistogram
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
    # A one-shot row: ("infer", input_data, shape) or ("score", prompt,
    # completion); None for a generation request.
    oneshot: Optional[tuple] = None
    # The caller's name for the row (the worker's request_id): what
    # export_row finds it by.
    tag: Optional[str] = None
    # A migration import's snapshot (submit_import); None otherwise.
    migrate: Optional[dict] = None
    # The fleet prefix tier: the gateway's hint naming the lane whose
    # radix tree holds the deepest known chain of this prompt; a miss
    # with a hint fetches that chain before prefilling (prefix_fetch).
    prefix_hint: Optional[dict] = None
    # Disaggregated serving: a handoff row parks after prefill (first
    # token emitted, decode ticks skipped) until the export command ships
    # it, or park_s passes and it decodes locally; park_until is stamped
    # when it parks.
    handoff: bool = False
    park_s: float = 5.0
    park_until: float = 0.0
    # Stage spans (utils.tracing.TraceSink) and their clocks: submit, and
    # the start of the current admission-to-completion stage.
    sink: Optional[object] = None
    t_submit: float = 0.0
    t_admit: float = 0.0


# Put on the ready queue by submit_infer/submit_score: wakes a decode loop
# that waits for admissions, so one-shot work dispatches at once.
_WAKE = object()


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
    # The two-path forward's result: the (L, 1, pb, H_kv, D) row cache, or
    # on a slab lane the prompt's (L, state_dim) state.
    row_caches: Optional[Union[KVCache, torch.Tensor]] = None
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


class StreamMigratedAway(RuntimeError):
    """A live row was exported to another lane (``export_row``): its local
    stream ends here and this resolves its future. Retryable, ``migrated``
    marked: the continuation runs on the importing lane, or a client
    resumes from ``tokens_emitted``."""

    def __init__(self, message: str, tokens_emitted: int):
        super().__init__(message)
        self.retryable = True
        self.migrated = True
        self.tokens_emitted = int(tokens_emitted)


class ImportRefused(RuntimeError):
    """A migration import this lane could not honour: a checksum
    mismatch, an incompatible pool, or a pool that cannot hold the chain
    while keeping the live-row reserve free. Retryable (a replay resume
    needs nothing from this lane); ``import_refused`` rides the terminal
    stream event."""

    retryable = True
    import_refused = True


def spec_accept_emit(logits, tokens, sample_slot, fold0, n_draft, stoch,
                     active, done, seeds, temps, topps, topks, minps, eos,
                     counts=None, pens=None, stops=None):
    """The speculative tick's S-slot accept/emit loop on tensors, over the
    ragged forward's (B, S, V) logits: slot j's logits are conditioned on
    the draft prefix, which is the true stream while the chain holds, so

    - deterministic rows re-derive each token by the plain tick's
      ``_sample(fold_in(seed, position))`` rule, the penalty ``counts``
      (updated in place) and ``stops`` evolving slot by slot, and chain
      while the draft equals it;
    - drafted rows at temperature > 0 (``stoch``, a (B,) host array) take
      the rejection rule against the point-mass proposal: accept d with
      probability p(d), else draw from p without d's mass, by the tagged
      draws of ``runtime.speculative``;
    - completing prefill rows (no draft) take the j = 0 sample only.

    ``tokens`` (B, W) the window's tokens; ``sample_slot``, ``fold0`` (the
    logical position of slot 0's token), ``n_draft``, ``active``, ``done``
    and ``eos`` (B,) tensors; ``seeds`` and the filters (B,) host arrays.
    Returns tensors (emitted (B, S), n_emit, n_acc, done). ``n_acc`` is
    counted here: a row that stops ON an accepted draft token has no
    corrected slot, so emitted - 1 would undercount it."""
    b, S = logits.shape[0], logits.shape[1]
    dev = logits.device
    w = tokens.shape[1]
    rows = torch.arange(b, device=dev)
    tok_l, slot_l = tokens.long(), sample_slot.long()
    seeds_t = torch.as_tensor(seeds, device=dev)
    stochastic = bool(np.asarray(stoch).any())
    use_sto = torch.as_tensor(stoch, device=dev) & (n_draft > 0)
    # A drafted sampled row's token comes from the rejection rule, so its
    # plain sample is never read: it is taken greedy, without the Gumbel
    # noise that would cost the host a threefry pass over V per slot.
    det_temps = (np.where(np.asarray(stoch), 0.0, temps).astype(np.float32)
                 if stochastic else temps)
    t_safe = torch.clamp(torch.as_tensor(temps, device=dev), min=1e-6)
    controls = counts is not None
    alive = active & ~done
    new_done = done.clone()
    n_emit = torch.zeros((b,), dtype=torch.int32, device=dev)
    n_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
    emitted = []
    for j in range(S):
        lg = logits[:, j]
        lg_p = apply_repetition_penalty(lg, counts, pens) if controls else lg
        fold = fold0 + j
        det = _sample(lg_p, seeds_t, fold, det_temps, topps, topks, minps)
        # The draft token this slot must reproduce for the chain to go on
        # (decode rows: window slot j + 1).
        d_next = tok_l[rows, torch.clamp(slot_l + j + 1, max=w - 1)]
        has_draft = n_draft > j
        det_chain = has_draft & (d_next == det)
        if stochastic:
            p = torch.softmax(lg / t_safe[:, None], dim=-1)
            u = tagged_uniform(seeds_t, fold, _TAG_ACCEPT)
            acc = has_draft & (u < p[rows, d_next])
            resid = p.index_put((rows, d_next), torch.zeros((b,),
                                                            device=dev))
            resid = torch.where(has_draft[:, None], resid, p)
            tot = resid.sum(dim=-1, keepdim=True)
            dist = torch.where(tot > 0, resid / torch.clamp(tot, min=1e-30),
                               p)
            corr = tagged_categorical(seeds_t, fold, _TAG_RESID,
                                      torch.log(torch.clamp(dist,
                                                            min=1e-30)))
            tok_j = torch.where(use_sto, torch.where(acc, d_next, corr), det)
            chain = torch.where(use_sto, acc, det_chain)
        else:
            tok_j, chain = det, det_chain
        tok_j = torch.where(alive, tok_j, eos)
        if controls:
            # Rows past their chain add 0 (at token 0: their eos may be -1).
            counts.index_put_((rows, torch.where(alive, tok_j, 0)),
                              alive.to(torch.int32), accumulate=True)
        emitted.append(tok_j)
        n_emit += alive.to(torch.int32)
        n_acc += (alive & chain).to(torch.int32)
        stop_j = alive & (tok_j == eos)
        if controls:
            stop_j |= alive & (tok_j[:, None] == stops).any(dim=1)
        new_done |= stop_j
        alive = alive & ~stop_j & chain
    return torch.stack(emitted, 1), n_emit, n_acc, new_done


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
        spec_draft: str = "ngram",
        spec_draft_model=None,
        spec_draft_params=None,
        state_rows: int = 0,
        tp: int = 1,
        tp_devices=None,
        infer_engine=None,
        score_provider=None,
    ):
        """Arguments keep the JAX scheduler's names and meanings.
        ``kv_block_size`` 0 picks
        the dense mode, > 0 the paged one, where ``mixed_step`` picks
        mixed stepping over two-path; ``step_chunk`` is the dense and
        two-path decode chunk's steps; ``prefix_cache_mb`` the dense
        prefix cache's budget (0 disables it);
        ``kv_quantize`` "int8" stores the pool int8 with per-(layer, slot,
        kv-head) f32 scales in either mode; ``kv_host_blocks`` > 0 (paged,
        with ``prefix_sharing``) adds that many host blocks under the
        pool for demoted radix prefixes. ``spec_k`` > 0 (paged only,
        either mode) turns on continuous speculation with the
        ``spec_draft`` drafter ("ngram", or "model": ``spec_draft_model``
        with ``spec_draft_params``, its own seeded init when None).
        ``device`` defaults to the CUDA card; pass ``device="cpu"`` to run
        the plain PyTorch paths on the CPU. ``tp`` > 1 serves the model
        tensor-parallel over ``tp_devices`` (entries may repeat, e.g.
        ``["cpu"] * tp``; default the first ``tp`` CUDA devices), with the
        JAX scheduler's fences: the paged cache only, ``device``
        exclusive, unshardable families and too few devices refused.

        One-shot rows: ``infer_engine`` (a ``runtime.engine.
        InferenceEngine``) enables ``submit_infer``, ``score_provider`` (a
        callable returning a ``runtime.generator.Scorer``) enables
        ``submit_score``, on a generative lane beside its decode rows. A
        model of the stateless family (no decoder config) builds a lane
        whose rows are all one-shot."""
        if isinstance(model, str):
            model = create_model(model)
        # The model's declared state family selects the autoregressive
        # state machinery: "kv_paged" (dense cache or block pool),
        # "state_slab" (one StateSlabPool row per stream) or "stateless"
        # (one-shot rows only).
        self._stateless = model.state_family == "stateless"
        self._slab = model.state_family == "state_slab"
        self._tp = int(tp)
        if self._stateless:
            self._fence_stateless(kv_block_size, kv_blocks, kv_host_blocks,
                                  kv_quantize, spec_k, mixed_step,
                                  state_rows)
        elif self._slab:
            self._fence_slab(model, kv_block_size, kv_blocks,
                             kv_host_blocks, kv_quantize, spec_k, tp)
        elif int(state_rows) > 0:
            raise ValueError(
                "state_rows applies to the state_slab family; model "
                f"'{model.name}' serves the {model.state_family} family")
        if mixed_step and int(kv_block_size) <= 0 and not self._slab:
            raise ValueError("mixed_step requires the paged KV cache "
                             "(set kv_block_size > 0)")
        if kv_quantize and int(kv_block_size) <= 0:
            raise ValueError("kv_quantize requires the paged KV cache "
                             "(set kv_block_size > 0)")
        if int(spec_k) > 0 and int(kv_block_size) <= 0:
            raise ValueError("speculative decoding (spec_k > 0) requires "
                             "the paged KV cache (set kv_block_size > 0)")
        if int(kv_host_blocks) > 0 and int(kv_block_size) <= 0:
            raise ValueError("kv_host_blocks requires the paged KV cache "
                             "(set kv_block_size > 0)")
        self._tp_group = None
        if self._tp > 1:
            # After the family fences: a slab model refuses tp by its
            # pinned rule whatever else is set.
            if device is not None:
                raise ValueError(
                    "tp > 1 builds its own device mesh; `device` is "
                    "mutually exclusive with tensor-parallel serving")
            if int(kv_block_size) <= 0:
                raise ValueError(
                    "tp > 1 requires the paged KV cache "
                    "(set kv_block_size > 0): the dense per-slot cache "
                    "has no sharded pool layout")
            reason = tp_unshardable_reason(model)
            if reason is not None:
                raise RuntimeError(
                    f"model '{model.name}' cannot serve "
                    f"tensor-parallel (tp={self._tp}): {reason}")
            self._tp_group = TPGroup(resolve_tp_devices(self._tp,
                                                        tp_devices))
        cfg = model.config
        if not (self._stateless or self._slab) and (
                not isinstance(cfg, TransformerConfig) or not cfg.causal):
            raise ValueError(f"model '{model.name}' is not a decoder "
                             f"transformer")
        self.spec = model
        self.cfg = cfg
        # Rank 0's device under tp: the home of the replicated tensors
        # (tokens, tables, logits, sampling state) and of the drafter.
        self.device = (self._tp_group.home if self._tp_group is not None
                       else resolve_device(device))
        self._dtype = resolve_dtype(dtype)
        if self._stateless:
            # One-shot rows have no sequence axis: max_seq only bounds the
            # (never used) prompt buckets.
            self.max_seq = int(max_seq) if max_seq else 16
        else:
            self.max_seq = min(max_seq or cfg.max_seq, cfg.max_seq)
        self.n_slots = int(n_slots)
        self._paged = int(kv_block_size) > 0
        self._mixed = bool(mixed_step)
        self._step_chunk = int(step_chunk)
        if not self._mixed and self._step_chunk < 1:
            raise ValueError(f"step_chunk must be >= 1, got {step_chunk}")
        self._spec_k = int(spec_k)
        self._spec = self._spec_k > 0
        # Columns past `pos` the next tick may write for a decode row: one
        # in mixed mode, a whole chunk in two-path mode, a verify window
        # under speculation. Block growth and admission headroom reserve
        # exactly that.
        if self._spec:
            self._decode_horizon = self._spec_k + 1
        else:
            self._decode_horizon = 1 if self._mixed else self._step_chunk
        self._prompt_buckets = power_of_two_buckets(self.max_seq)
        if self._stateless:
            self.params = params  # the engine's; no generative forward
        else:
            self.params = params if params is not None else model.init(
                rng_seed, device=self.device, dtype=self._dtype)
            if self._tp_group is not None:
                self.params = self._shard(self.params)
        # Every mode carries the prefix cache (idle in the paged modes, as
        # in the JAX scheduler), so stats() has one schema.
        self._prefix_cache = _PrefixCache(int(prefix_cache_mb) * (1 << 20))
        self._row_blocks: List[List[int]] = [[] for _ in
                                             range(self.n_slots)]
        # Admissions deferred on pool pressure, retried as rows free.
        self._pending: "collections.deque[_Formed]" = collections.deque()
        if self._slab:
            # One fixed-size f32 row per live stream, constant in sequence
            # length: the family's capacity is rows, not blocks. No radix
            # tree (a recurrent prefix is not block-addressable).
            self._spool = StateSlabPool(
                cfg.n_layers, ssd_state_dim(cfg),
                int(state_rows) or self.n_slots + 1, device=self.device)
            self._slab_rows: List[int] = [-1] * self.n_slots  # -1: none
            self._prefix_sharing = False
        elif self._paged:
            self._init_pool(cfg, int(kv_block_size), int(kv_blocks),
                            int(kv_host_blocks), str(kv_quantize),
                            bool(prefix_sharing))
        elif not self._stateless:
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
        # Rows parked for a disaggregated handoff: excluded from decode
        # work until exported, cancelled or their park window passes.
        # Decode-thread-owned.
        self._held: List[bool] = [False] * n

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # Export commands (tag, Future, opts) from export_row, served by
        # the decode loop between ticks, where the row is quiescent; those
        # waiting on a row's prefill (wait_prefill) are re-checked at each
        # tick boundary; cancels that arrive before their row parked are
        # remembered (bounded). Decode-thread-owned.
        self._migrate_q: "queue.Queue[tuple]" = queue.Queue()
        self._export_waiting: List[tuple] = []
        self._hold_cancel_tags: "collections.deque" = collections.deque(
            maxlen=64)
        # Formed requests ready for row admission; bounded, since each
        # holds radix pins.
        self._ready: "queue.Queue[Optional[_Formed]]" = queue.Queue(
            maxsize=max(1, n))
        self._stats = {"admitted": 0, "completed": 0, "chunks": 0}
        self._stats_lock = threading.Lock()
        self._draining_flag = False
        # Brownout degradations (set_brownout), off at construction.
        self._bo_budget_frac = 1.0
        self._bo_spec_off = False
        self._bo_defer_swap = False
        self._infer_engine = infer_engine
        self._score_provider = score_provider
        # The stateless block exists iff one-shot rows can: a generative
        # lane without them keeps its stats schema.
        self._oneshot = (self._stateless or infer_engine is not None
                         or score_provider is not None)
        if self._oneshot:
            self._stats["stateless"] = {
                "admitted": 0, "completed": 0, "failed": 0,
                "ticks": 0, "dispatches": 0, "infer_rows": 0,
                "score_rows": 0, "full_dispatches": 0,
                "deadline_dropped": 0,
            }
        # One-shot requests wait here (unbounded), not in the slot-bounded
        # ready queue: they are members of the next tick's grouped
        # dispatch and free their rows within it, so they never queue
        # behind generative admissions that hold a row for a stream's
        # life.
        self._oneshot_ready: "queue.Queue[_Request]" = queue.Queue()
        self._idle_wait = False  # the decode loop waits for admissions
        self._drafter = None
        if self._spec:
            if self._spec_k > self.max_seq - 2:
                raise ValueError(f"spec_k={self._spec_k} cannot fit a "
                                 f"verify window in max_seq={self.max_seq}")
            self._drafter = make_drafter(
                spec_draft, self._spec_k, draft_model=spec_draft_model,
                draft_params=spec_draft_params, dtype=self._dtype,
                device=self.device)
            dcfg = getattr(self._drafter, "cfg", None)
            if dcfg is not None and dcfg.vocab != self.cfg.vocab:
                raise ValueError(f"draft vocab {dcfg.vocab} != target "
                                 f"vocab {self.cfg.vocab}")
            self._stats["spec"] = {
                "k": self._spec_k, "draft": self._drafter.name,
                "ticks": 0, "dispatches": 0, "proposed_tokens": 0,
                "accepted_tokens": 0, "emitted_tokens": 0,
                # (row, tick) pairs that emitted: emitted / row_ticks is
                # the mean advance of a row per dispatch (1.0 without
                # speculation).
                "row_ticks": 0,
                "draft_dispatches": 0, "tail_blocks_released": 0,
            }
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
        # TTFT (submit to first token) and ITL (the gap between a row's
        # deliveries), in every mode.
        self.ttft_hist = LatencyHistogram()
        self.itl_hist = LatencyHistogram()
        self._row_last_emit = [0.0] * n
        # Set by the worker: the ring the tick spans land in, its node
        # name, and cross-lane trace stitching of exports.
        self.tracer = None
        self.trace_node = "scheduler"
        self.trace_stitch = False
        # The fleet prefix tier's fetch callable, set by the worker with
        # prefix fetch on: (hint, tokens, max_blocks) -> dict or None. The
        # worker owns the transport, timeout and in-flight cap; the
        # scheduler verifies and splices. None leaves every hint inert.
        self.prefix_fetch = None
        # The per-tick flight recorder (configure_flight_recorder):
        # capacity 0 is off and costs nothing a tick. The decode thread
        # writes the ring, scrapes read it under _flight_lock.
        self._flight_capacity = 0
        self._flight_ring: "collections.deque" = collections.deque(maxlen=1)
        self._flight_lock = threading.Lock()
        self._flight_dump_dir = None
        self._flight_last_dump = None
        self._flight_dumps = 0
        self._flight_last_dump_ts = 0.0
        # Decode-thread-owned: the previous counter readings (per-tick
        # deltas) and a rolling 10 s window of deadline misses.
        self._flight_prev: dict = {}
        self._flight_miss_window: "collections.deque" = collections.deque()
        # The torch.profiler capture, opened and closed on the decode
        # thread: a pending start ((log_dir, ticks), Future), a pending
        # stop (Future), whether one is open, the iterations left (0: until
        # stopped).
        self._profile_start_req = None
        self._profile_stop_req: Optional[Future] = None
        self._profile_open = False
        self._profile_ticks_left = 0
        self._profile_result = None
        self._running = True
        self._prefill_thread = threading.Thread(
            target=self._prefill_loop, name="continuous-prefill", daemon=True)
        self._prefill_thread.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="continuous-decode", daemon=True)
        self._thread.start()

    @staticmethod
    def _fence_stateless(kv_block_size, kv_blocks, kv_host_blocks,
                         kv_quantize, spec_k, mixed_step, state_rows) -> None:
        """One-shot rows hold no generative state: every generative-state
        knob refuses (the JAX scheduler's messages)."""
        if int(kv_block_size) > 0 or int(kv_blocks) > 0:
            raise ValueError(
                "the stateless family has no KV cache: "
                "kv_block_size/kv_blocks apply to kv_paged models")
        if int(kv_host_blocks) > 0:
            raise ValueError(
                "kv_host_blocks applies to the kv_paged family's block "
                "pool; the stateless family holds no KV blocks")
        if kv_quantize:
            raise ValueError(
                "kv_quantize applies to the kv_paged family's block pool; "
                "the stateless family holds no KV blocks")
        if int(spec_k) > 0:
            raise ValueError(
                "speculative decoding (spec_k > 0) requires the kv_paged "
                "family: one-shot rows have no decode loop to speculate")
        if mixed_step:
            raise ValueError(
                "mixed_step merges prefill and decode dispatches; the "
                "stateless family has neither (one-shot rows already ride "
                "one grouped dispatch per tick)")
        if int(state_rows) > 0:
            raise ValueError(
                "state_rows applies to the state_slab family; the "
                "stateless family has no recurrent state")

    @staticmethod
    def _fence_slab(model, kv_block_size, kv_blocks, kv_host_blocks,
                    kv_quantize, spec_k, tp) -> None:
        """The state_slab family has no KV blocks and no verify window:
        those knobs refuse (the JAX scheduler's messages), and so does
        tensor parallelism, by the config's pinned rule."""
        if not isinstance(model.config, SSDConfig):
            raise ValueError(
                f"model '{model.name}' declares state family "
                f"'state_slab' but its config is not an SSDConfig "
                f"(the slab step functions are models.ssd's)")
        if int(tp) > 1:
            reason = (tp_unshardable_reason(model)
                      or "the state_slab family declares no shardable "
                         "heads axis")
            raise RuntimeError(f"model '{model.name}' cannot serve "
                               f"tensor-parallel (tp={int(tp)}): {reason}")
        if int(kv_block_size) > 0 or int(kv_blocks) > 0:
            raise ValueError(
                "the state_slab family has no paged KV cache: "
                "kv_block_size/kv_blocks apply to kv_paged models "
                "(state capacity is state_rows)")
        if int(kv_host_blocks) > 0:
            raise ValueError(
                "kv_host_blocks applies to the kv_paged family's block "
                "pool; the state_slab family has no demotable KV blocks")
        if kv_quantize:
            raise ValueError(
                "kv_quantize applies to the kv_paged family's block pool; "
                "the state_slab family's slab stays full precision")
        if int(spec_k) > 0:
            raise ValueError(
                "speculative decoding (spec_k > 0) requires the kv_paged "
                "family: the state_slab recurrence has no KV verify window")

    def _init_pool(self, cfg: TransformerConfig, bs: int, kv_blocks: int,
                   host_blocks: int, kv_quantize: str,
                   prefix_sharing: bool) -> None:
        """The paged modes' block pool (with its host tier), block tables
        and radix sharing."""
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
        if host_blocks > 0 and not prefix_sharing:
            raise ValueError("kv_host_blocks requires prefix_sharing "
                             "(the host tier holds radix entries)")
        group = self._tp_group
        self._pool = BlockPool(cfg, nb, bs, self._dtype,
                               None if group else self.device,
                               host_blocks=host_blocks,
                               quantize=kv_quantize,
                               tp_devices=group.devices if group else None)
        self._tables = np.zeros((self.n_slots, width), np.int32)
        self._prefix_sharing = prefix_sharing

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_id: int = -1, temperature: float = 0.0, seed: int = 0,
               top_p: float = 1.0, top_k: int = 0,
               repetition_penalty: float = 1.0, stop_tokens=None,
               min_p: float = 0.0, stream=None,
               deadline: Optional[Deadline] = None,
               tag: Optional[str] = None, sink=None,
               handoff: bool = False, handoff_park_s: float = 5.0,
               prefix_hint: Optional[dict] = None) -> Future:
        """Enqueue one request; the Future resolves to its generated token
        list. ``stream``: optional queue.Queue that receives fresh token
        lists as they decode, then a None sentinel. Cancelling the Future
        cancels the request. ``deadline``: the request fails with
        ``DeadlineExceeded`` once it passes (between ticks). ``tag``:
        the name ``export_row`` finds the row by. ``sink``: a
        ``utils.tracing.TraceSink`` for the request's stage spans.
        ``handoff`` (paged and slab lanes): park the row after prefill,
        first token emitted and decode ticks skipped, for up to
        ``handoff_park_s`` seconds (clamped to [0.1, 300]) awaiting
        ``export_row(wait_prefill=True)``; past the window it decodes
        locally. ``prefix_hint``: the gateway's ``{"lane", "addr",
        "fingerprint", "blocks"}`` of the peer holding this prompt's
        chain, inert without a ``prefix_fetch`` callable."""
        if self._stateless:
            raise RuntimeError(
                f"model '{self.spec.name}' serves the stateless family: no "
                f"generation lane (the one-shot surfaces are "
                f"submit_infer/submit_score)")
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
                       stream=stream, deadline=deadline,
                       tag=str(tag) if tag is not None else None,
                       sink=sink, t_submit=time.perf_counter(),
                       prefix_hint=dict(prefix_hint)
                       if isinstance(prefix_hint, dict) else None,
                       handoff=bool(handoff) and (self._paged
                                                  or self._slab),
                       park_s=min(300.0, max(0.1, float(handoff_park_s))))
        self._queue.put(req)
        return req.future

    # -- live-row migration ---------------------------------------------------

    def export_row(self, tag: str, timeout_s: float = 10.0,
                   wait_prefill: bool = False,
                   cancel: bool = False) -> dict:
        """Quiesce and export ONE live row by its ``submit`` tag: its
        stream state (prompt, emitted tokens, position, pending token,
        sampling and stopping parameters, remaining budget) and its KV
        block chain (``BlockPool.export_chain``). The command runs on the
        decode thread between ticks; on success the local stream ends with
        ``StreamMigratedAway`` and the row's blocks return to the pool.
        Thread-safe; returns ``{"ok": True, ...snapshot...}`` or
        ``{"ok": False, "reason": ...}`` (a dense lane, an unknown tag, a
        row mid-prefill or finishing).

        ``wait_prefill`` (the disaggregated handoff): a row not yet
        admitted or still prefilling is not refused; the command waits on
        the decode loop and exports at the first tick boundary past the
        row's prefill, refusing only at ``timeout_s``. ``cancel``: release
        the row's handoff hold instead of exporting (``cancelled`` says
        whether a hold existed or was pre-empted): it decodes on at the
        next tick."""
        if not (self._paged or self._slab):
            return {"ok": False,
                    "reason": "migration requires the paged KV cache"}
        if not self._running:
            return {"ok": False, "reason": "scheduler stopped"}
        fut: Future = Future()
        opts: dict = {}
        if cancel:
            opts["cancel"] = True
        elif wait_prefill:
            opts["wait_until"] = time.monotonic() + max(0.1,
                                                        float(timeout_s))
        self._migrate_q.put((str(tag), fut, opts))
        try:
            return fut.result(timeout=timeout_s + 1.0)
        except Exception as exc:
            return {"ok": False, "reason": f"export failed: {exc}"}

    def submit_import(self, snapshot: dict, stream=None,
                      deadline: Optional[Deadline] = None,
                      tag: Optional[str] = None, sink=None) -> Future:
        """Adopt an exported row mid-stream: the chain's bytes enter free
        blocks verbatim (a prompt prefix this lane already caches is
        re-adopted from its radix tree) and decoding resumes at the
        exported position, with zero re-prefilled tokens; the stream
        pushes only the tokens after those the source delivered. Raises
        ValueError on a malformed snapshot (before any stream commits);
        a checksum, geometry or pool-pressure refusal resolves the future
        with ``ImportRefused``."""
        if not self._running:
            raise RuntimeError("scheduler stopped")
        if not (self._paged or self._slab):
            raise ValueError("migration import requires the paged KV "
                             "cache (kv_block_size > 0)")
        if not isinstance(snapshot, dict):
            raise ValueError("migration snapshot must be an object")
        missing = [k for k in ("prompt", "emitted", "pos", "tok",
                               "max_new", "chain") if k not in snapshot]
        if missing:
            raise ValueError(f"migration snapshot missing {missing}")
        stop_list = [int(t) for t in snapshot.get("stop_tokens", ())]
        pens, stops = expand_stopping_params(
            1, float(snapshot.get("repetition_penalty", 1.0)),
            [stop_list] if stop_list else None)
        emitted = [int(t) for t in snapshot["emitted"]]
        req = _Request(
            [int(t) for t in snapshot["prompt"]],
            int(snapshot["max_new"]), int(snapshot.get("eos_id", -1)),
            float(snapshot.get("temperature", 0.0)),
            int(snapshot.get("seed", 0)),
            float(snapshot.get("top_p", 1.0)),
            clamp_top_k(snapshot.get("top_k", 0)),
            rep_penalty=pens[0], stop_tokens=stops[0],
            min_p=float(snapshot.get("min_p", 0.0)),
            stream=stream, deadline=deadline,
            tag=str(tag) if tag is not None else None, migrate=snapshot,
            sink=sink, t_submit=time.perf_counter())
        # Tokens the source already delivered: the continuation pushes
        # only what comes after them.
        req.streamed = min(int(snapshot.get("streamed", len(emitted))),
                           len(emitted))
        self._queue.put(req)
        return req.future

    # -- the fleet prefix tier -------------------------------------------------

    def export_prefix(self, tokens: Sequence[int],
                      max_blocks: Optional[int] = None) -> dict:
        """A peer's prefix fetch (/admin/export_prefix): the longest radix
        chain matching ``tokens`` (at most ``max_blocks`` blocks),
        serialized under one pool-lock pass (``chain_nodes`` +
        ``export_chain``: device-resident and host-demoted blocks alike;
        eviction runs only inside alloc under the same lock, so nothing
        needs a pin). No stream state: a cache read, not a migration.
        Refusals answer ``{"ok": False, "reason"}`` and never raise."""
        if not self._paged or not self._prefix_sharing:
            return {"ok": False,
                    "reason": "prefix export requires the paged KV "
                              "cache with prefix sharing on"}
        if not self._running:
            return {"ok": False, "reason": "scheduler stopped"}
        toks = [int(t) for t in tokens]
        pool = self._pool
        with pool.lock:
            nodes = pool.radix.chain_nodes(toks)
            if max_blocks is not None:
                nodes = nodes[:max(0, int(max_blocks))]
            if not nodes:
                return {"ok": False, "reason": "no matching prefix chain"}
            chain = pool.export_chain(nodes)
        return {"ok": True, "blocks": len(nodes), "chain": chain}

    def prefix_fingerprints(self, top_k: int = 8,
                            max_tokens: int = 256) -> List[dict]:
        """The radix tree's ``top_k`` deepest chains as ``{"tokens",
        "blocks"}`` summaries (``RadixTree.top_chains``): the gateway
        prober's directory seed. Empty off the paged sharing layouts."""
        if not self._paged or not self._prefix_sharing:
            return []
        pool = self._pool
        with pool.lock:
            return pool.radix.top_chains(top_k=top_k, max_tokens=max_tokens)

    def _prefix_fetch_stats(self) -> dict:
        """The ``prefix_fetch`` stats block, created at the first fetch
        attempt (a lane that never fetched shows none). Callers hold
        _stats_lock."""
        p = self._stats.get("prefix_fetch")
        if p is None:
            p = self._stats["prefix_fetch"] = {
                "attempted": 0, "spliced": 0, "blocks_spliced": 0,
                "prefill_tokens_skipped_remote": 0,
                "peer_unreachable": 0, "peer_refused": 0, "timeout": 0,
                "inflight_capped": 0, "checksum_failed": 0,
                "geometry_mismatch": 0, "stale_generation": 0,
                "pool_full": 0, "no_gain": 0,
            }
        return p

    def _fetch_prefix_splice(self, req: _Request, prompt: List[int],
                             matched: List[int], gen: int,
                             pb: int) -> List[int]:
        """The fleet prefix tier's fetch (prefill thread): pull the hinted
        peer's radix chain of this prompt and splice it past the local
        match, so only the unmatched tail prefills (counted
        ``prefill_tokens_skipped_remote``). Geometry and checksum are
        verified before any allocation; the splice holds the pool lock
        once (generation check, live-row reserve, alloc, verbatim import,
        radix insert). Every failure rung returns the local match
        unchanged: the stream prefills locally. One ``prefix_fetch``
        stage span per attempt, so ``attempted`` equals the spans."""
        hint = req.prefix_hint
        if not self._prefix_sharing or not isinstance(hint, dict):
            return matched
        pool = self._pool
        bs = pool.block_size
        Leff = max(len(prompt), 1)
        # The last prompt block always recomputes (its logits seed the
        # first sample), and the row table holds at most pb // bs blocks.
        max_useful = min((Leff - 1) // bs, pb // bs)
        m = len(matched)
        promised = int(hint.get("blocks") or 0)
        if max_useful <= m or (promised and promised <= m):
            return matched  # nothing a fetch could add: no attempt
        t0 = time.perf_counter()
        outcome = "spliced"
        spliced = 0
        chain = None
        try:
            res = self.prefix_fetch(hint, prompt, max_useful)
        except Exception:  # the transport never kills the prefill thread
            res = {"ok": False, "rung": "peer_unreachable"}
        if res is None:
            return matched  # a self-hint: the request is on the owner
        if not res.get("ok"):
            rung = str(res.get("rung") or "peer_refused")
            outcome = rung if rung in ("peer_unreachable", "peer_refused",
                                       "timeout", "inflight_capped") \
                else "peer_refused"
        else:
            chain = res.get("chain")
            if not isinstance(chain, dict) or "blocks" not in chain:
                outcome = "geometry_mismatch"
            elif pool.chain_compatible(chain) is not None:
                outcome = "geometry_mismatch"
            elif not pool.verify_chain(chain):
                outcome = "checksum_failed"
        if outcome == "spliced":
            n_fetch = min(len(chain["blocks"]), max_useful)
            if n_fetch <= m:
                outcome = "no_gain"
            else:
                with pool.lock:
                    if pool.generation != gen:
                        outcome = "stale_generation"
                    elif not pool.can_alloc(n_fetch - m
                                            + self._promote_reserve()):
                        outcome = "pool_full"
                    else:
                        fresh = pool.alloc(n_fetch - m)
                        pool.import_chain(chain,
                                          chain["blocks"][m:n_fetch], fresh)
                        # The spliced tail joins the tree (the tree's own
                        # reference); the row keeps the alloc reference,
                        # the shape of a lookup's pins.
                        pool.radix.insert(prompt[:n_fetch * bs],
                                          list(matched) + fresh)
                        matched = list(matched) + fresh
                        spliced = n_fetch - m
        with self._stats_lock:
            p = self._prefix_fetch_stats()
            p["attempted"] += 1
            if spliced:
                p["spliced"] += 1
                p["blocks_spliced"] += spliced
                p["prefill_tokens_skipped_remote"] += spliced * bs
            else:
                p[outcome] += 1
        self._stage(req, "prefix_fetch", t0, outcome=outcome,
                    blocks=spliced, peer=str(hint.get("lane") or ""))
        return matched

    # -- disaggregated handoff holds --------------------------------------------

    def _bump_handoff(self, key: str, n: int = 1) -> None:
        """The ``handoff`` stats block (created at the first hold: a lane
        that never parked shows none)."""
        with self._stats_lock:
            h = self._stats.get("handoff")
            if h is None:
                h = self._stats["handoff"] = {
                    "holds": 0, "park_expired": 0, "hold_cancelled": 0}
            h[key] += n

    def _maybe_hold(self, row: int, req: _Request) -> None:
        """Park a handoff row that just finished prefill (decode thread):
        it keeps its first token and KV chain and skips decode ticks until
        the export command arrives or the park window passes. A row that
        already completed has nothing to hand off."""
        if not req.handoff or self._row_req[row] is not req:
            return
        if req.tag is not None and req.tag in self._hold_cancel_tags:
            # Cancelled while queued or prefilling: no park at all.
            self._hold_cancel_tags.remove(req.tag)
            self._bump_handoff("hold_cancelled")
            return
        self._held[row] = True
        req.park_until = time.monotonic() + req.park_s
        self._bump_handoff("holds")

    def _unpark_expired(self) -> None:
        """A held row whose park window passed decodes on (the colocated
        fallback when the export never came); its stream continues from
        this lane unchanged."""
        now = time.monotonic()
        for r, req in enumerate(self._row_req):
            if req is not None and self._held[r] and now >= req.park_until:
                self._held[r] = False
                self._bump_handoff("park_expired")

    def _cancel_hold(self, tag: str) -> dict:
        """Release a handoff hold (no destination is coming): the row
        decodes on at the next tick. A row not parked yet (queued,
        prefilling) skips its park instead. ``ok`` is False (there is no
        snapshot); ``cancelled`` says whether a hold existed or was
        pre-empted."""
        row = next((r for r, req in enumerate(self._row_req)
                    if req is not None and req.oneshot is None
                    and req.tag == tag), None)
        if row is not None:
            req = self._row_req[row]
            was_held = self._held[row]
            self._held[row] = False
            cancelled = was_held or req.handoff
            req.handoff = False  # mid-prefill: skip the park too
            if cancelled:
                self._bump_handoff("hold_cancelled")
            return {"ok": False, "cancelled": cancelled,
                    "reason": "handoff hold cancelled" if cancelled
                    else "no held row with this tag"}
        if tag not in self._hold_cancel_tags:
            self._hold_cancel_tags.append(tag)
        return {"ok": False, "cancelled": False,
                "reason": "no live row with this tag; park pre-cancelled"}

    def _migration_stats(self) -> dict:
        """The ``migration`` stats block, created at its first count (a
        lane that never migrated shows none). Callers hold _stats_lock."""
        m = self._stats.get("migration")
        if m is None:
            m = self._stats["migration"] = {
                "exported_rows": 0, "exported_tokens": 0,
                "imported_rows": 0, "imported_tokens": 0,
                "imported_chain_tokens": 0, "import_rejected": 0,
                "export_refused": 0,
            }
        return m

    def _bump_migration(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._migration_stats()[key] += n

    @property
    def accepts_oneshot(self) -> bool:
        """True when the scheduler serves one-shot /infer rows (it has an
        infer_engine)."""
        return self._infer_engine is not None

    @property
    def accepts_score(self) -> bool:
        """True when the scheduler serves one-shot /score rows (it has a
        score_provider)."""
        return self._score_provider is not None

    def submit_infer(self, input_data, shape=None,
                     deadline: Optional[Deadline] = None,
                     sink=None) -> Future:
        """Enqueue one stateless forward as a single-tick row: the next
        tick's grouped dispatch runs it with the other pending /infer rows
        through the engine's batched forward. Resolves to (output row,
        per-request time in us); the row equals ``batch_predict``'s row
        for the same co-batched inputs."""
        if self._infer_engine is None:
            raise RuntimeError(
                "submit_infer requires an infer_engine: construct the "
                "scheduler with infer_engine=<InferenceEngine>")
        return self._submit_oneshot(("infer", input_data,
                                     tuple(int(d) for d in shape)
                                     if shape is not None else None),
                                    deadline, sink)

    def submit_score(self, prompt_tokens, completion_tokens,
                     deadline: Optional[Deadline] = None,
                     sink=None) -> Future:
        """Enqueue one teacher-forced scoring request as a single-tick row
        (per-token log P(completion | prompt), one forward per tick's
        group). Resolves to (logprobs, per-request time in us)."""
        if self._score_provider is None:
            raise RuntimeError(
                "submit_score requires a score_provider: construct the "
                "scheduler with score_provider=<callable returning a "
                "scoring Generator>")
        return self._submit_oneshot(("score",
                                     [int(t) for t in prompt_tokens],
                                     [int(t) for t in completion_tokens]),
                                    deadline, sink)

    def _submit_oneshot(self, oneshot: tuple, deadline: Optional[Deadline],
                        sink=None) -> Future:
        if not self._running:
            raise RuntimeError("scheduler stopped")
        req = _Request([], 0, -1, 0.0, 0, 1.0, 0, deadline=deadline,
                       oneshot=oneshot, sink=sink,
                       t_submit=time.perf_counter())
        self._oneshot_ready.put(req)
        if self._idle_wait:
            try:  # wake the loop from its wait for admissions
                self._ready.put_nowait(_WAKE)
            except queue.Full:
                pass  # the loop is admitting anyway
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
            if self._spec:
                spec = dict(self._stats["spec"])
        if self._spec:
            spec["accept_ratio"] = (
                round(spec["accepted_tokens"]
                      / max(1, spec["proposed_tokens"]), 4)
                if spec["proposed_tokens"] else None)
            spec["tokens_per_dispatch"] = (
                round(spec["emitted_tokens"] / spec["dispatches"], 3)
                if spec["dispatches"] else None)
            spec["tokens_per_row_dispatch"] = (
                round(spec["emitted_tokens"] / spec["row_ticks"], 3)
                if spec["row_ticks"] else None)
            out["spec"] = spec
        if self._oneshot:
            with self._stats_lock:
                out["stateless"] = dict(self._stats["stateless"])
        if "migration" in out:
            with self._stats_lock:
                out["migration"] = dict(self._stats["migration"])
        if "handoff" in out:
            with self._stats_lock:
                ho = dict(self._stats["handoff"])
            ho["held_rows"] = int(sum(1 for h in self._held if h))
            out["handoff"] = ho
        if "prefix_fetch" in out:
            with self._stats_lock:
                out["prefix_fetch"] = dict(self._stats["prefix_fetch"])
        out.update(n_slots=self.n_slots,
                   active=int(sum(r is not None for r in self._row_req)),
                   last_tick_age_s=round(age, 3),
                   prefix_cache=self._prefix_cache.stats())
        if self._tp > 1:
            # Present only on tensor-parallel lanes: the mesh-shape label
            # the topology-aware gateway ring reads from /health.
            out["tp"] = tp_topology_label(self._tp)
        if self._paged:
            out["kv_pool"] = self._pool.stats()
            out["kv_pool"]["pending_admissions"] = len(self._pending)
        if self._slab:
            # The slab lanes' block, beside which no kv_pool appears.
            out["state_pool"] = self._spool.stats()
            out["state_pool"]["pending_admissions"] = len(self._pending)
        if self._draining_flag:
            # Live rows over slots of a draining lane (0.0: emptied).
            out["drain_pressure"] = round(out["active"] / max(1, self.n_slots),
                                          4)
        if (self._bo_budget_frac < 1.0 or self._bo_spec_off
                or self._bo_defer_swap):
            out["brownout"] = {"budget_frac": self._bo_budget_frac,
                               "spec_suspended": self._bo_spec_off,
                               "swap_in_deferred": self._bo_defer_swap}
        if self._flight_capacity:
            # Only while the recorder is armed.
            with self._flight_lock:
                ticks_recorded = len(self._flight_ring)
            fl = {"capacity": self._flight_capacity,
                  "ticks_recorded": ticks_recorded,
                  "dumps": self._flight_dumps}
            last = self._flight_last_dump
            if last is not None:
                fl["last_anomaly"] = last["anomaly"]
            out["flight"] = fl
        return out

    # -- flight recorder and tick-bounded profiling -----------------------------

    def configure_flight_recorder(self, capacity: int,
                                  dump_dir: Optional[str] = None) -> None:
        """Arm the per-tick flight recorder (before traffic): a ring of
        ``capacity`` tick records, 0 = off (no per-tick work, no stats
        block); anomaly dumps are written into ``dump_dir`` when set."""
        capacity = max(0, int(capacity))
        with self._flight_lock:
            self._flight_capacity = capacity
            self._flight_ring = collections.deque(maxlen=max(1, capacity))
            self._flight_dump_dir = dump_dir

    def _flight_sample(self, tick_wall_s: float) -> None:
        """One record per decode-loop iteration (decode thread): the
        iteration's wall time, rows, queues, counter deltas and pool
        occupancy. A fourth deadline miss within 10 s dumps the ring
        (``deadline_miss_burst``)."""
        st = self._stats
        cur = {"chunks": st.get("chunks", 0),
               "admitted": st.get("admitted", 0),
               "completed": st.get("completed", 0),
               "deadline_cancelled": st.get("deadline_cancelled", 0)}
        mixed = st.get("mixed")
        if mixed:
            cur["prefill_tokens"] = mixed["prefill_tokens"]
            cur["decode_tokens"] = mixed["decode_tokens"]
        prev, self._flight_prev = self._flight_prev, cur
        rows = self._row_req
        rec = {"ts": round(time.time(), 6),
               "tick_wall_ms": round(tick_wall_s * 1e3, 3),
               "active": int(sum(r is not None for r in rows)),
               "held": int(sum(1 for h in self._held if h)),
               "queued": self._queue.qsize(),
               "ready": self._ready.qsize()}
        for k, v in cur.items():
            rec[k] = v - prev.get(k, 0)
        if self._paged or self._slab:
            rec["parked"] = len(self._pending)
        if self._mixed:
            rec["prefilling"] = int(sum(1 for p in self._prefilling if p))
        if self._paged:
            ps = self._pool.stats()
            pool = {"blocks_free": ps["blocks_free"],
                    "blocks_total": ps["blocks_total"]}
            host = ps.get("host")
            if host:
                pool["host_blocks_used"] = host["blocks_used"]
            rec["pool"] = pool
        elif self._slab:
            ss = self._spool.stats()
            rec["pool"] = {"rows_free": ss["rows_free"],
                           "rows_total": ss["rows_total"]}
        if self._draining_flag:
            rec["draining"] = True
        if self._bo_budget_frac < 1.0 or self._bo_spec_off:
            rec["brownout_budget_frac"] = self._bo_budget_frac
        with self._flight_lock:
            self._flight_ring.append(rec)
        dmiss = rec.get("deadline_cancelled", 0)
        if dmiss:
            now_m = time.monotonic()
            self._flight_miss_window.append((now_m, dmiss))
            while (self._flight_miss_window
                   and self._flight_miss_window[0][0] < now_m - 10.0):
                self._flight_miss_window.popleft()
            if sum(k for _, k in self._flight_miss_window) >= 4:
                self._flight_miss_window.clear()
                self._flight_anomaly("deadline_miss_burst")

    def flight_dump(self, reason: str) -> Optional[dict]:
        """Dump the ring now (an operator, a gateway resume); the dump's
        descriptor, or None with the recorder off."""
        return self._flight_anomaly(str(reason), force=True)

    def _flight_anomaly(self, reason: str,
                        force: bool = False) -> Optional[dict]:
        """Write the ring as a postmortem dump named for the anomaly, at
        most one per 10 s unless forced; the descriptor (its path None
        without a dump directory or when the write failed)."""
        if not self._flight_capacity:
            return None
        now_m = time.monotonic()
        with self._flight_lock:
            if not force and now_m - self._flight_last_dump_ts < 10.0:
                return None
            self._flight_last_dump_ts = now_m
            ring = list(self._flight_ring)
        scalars = {k: v for k, v in dict(self._stats).items()
                   if not isinstance(v, dict)}
        dump = {"anomaly": reason, "ts": time.time(),
                "node": self.trace_node, "ticks": len(ring),
                "stats": scalars, "timeline": ring}
        path = None
        if self._flight_dump_dir:
            try:
                os.makedirs(self._flight_dump_dir, exist_ok=True)
                path = os.path.join(
                    self._flight_dump_dir,
                    f"flight_{self.trace_node}_"
                    f"{int(dump['ts'] * 1e3)}_{reason}.json")
                with open(path, "w") as f:
                    json.dump(dump, f)
            except OSError:
                path = None  # a failed dump never fails serving
        last = {"anomaly": reason, "ts": dump["ts"],
                "ticks": len(ring), "path": path}
        with self._flight_lock:
            self._flight_dumps += 1
            self._flight_last_dump = last
        return last

    def flight_timeline(self, n: Optional[int] = None) -> dict:
        """The /admin/timeline payload: the ring (newest last, the last
        ``n`` with n) and the dump bookkeeping."""
        with self._flight_lock:
            ring = list(self._flight_ring)
        if n:
            ring = ring[-int(n):]
        return {"enabled": bool(self._flight_capacity),
                "capacity": self._flight_capacity,
                "ticks": len(ring),
                "dumps": self._flight_dumps,
                "last_dump": self._flight_last_dump,
                "timeline": ring}

    def start_profile(self, log_dir: str, ticks: int,
                      timeout_s: float = 120.0) -> dict:
        """A ``torch.profiler`` capture of the next ``ticks`` decode-loop
        iterations into ``log_dir`` (``ticks`` 0: until ``stop_profile``):
        the decode thread opens it at the top of its next iteration and
        closes it ``ticks`` iterations later (``profile_status`` then holds
        the trace file and its count of device events). Returns the
        start's result. The first session in a process initialises the
        card's activity tracing, which can take seconds, hence the long
        bound; a request the decode thread has not taken by then is
        withdrawn, so no capture opens unseen."""
        if not self._running:
            return {"error": "scheduler stopped"}
        fut: Future = Future()
        self._profile_start_req = ((log_dir, max(0, int(ticks))), fut)
        try:
            return fut.result(timeout=timeout_s)
        except FutureTimeout:
            if fut.cancel():
                return {"error": "profile start failed: the decode loop "
                                 f"took no request in {timeout_s} s"}
        try:  # the decode thread is opening the profiler: wait it out
            return fut.result(timeout=timeout_s)
        except FutureTimeout:
            return {"error": "profile start failed: the profiler did not "
                             f"open in {2 * timeout_s} s"}

    def stop_profile(self, timeout_s: float = 30.0) -> dict:
        """Stop a running capture now (on the decode thread)."""
        if not self._running:
            return {"error": "profiler not running"}
        fut: Future = Future()
        self._profile_stop_req = fut
        try:
            return fut.result(timeout=timeout_s)
        except Exception as exc:
            return {"error": f"profile stop failed: {exc}"}

    def profile_status(self) -> dict:
        return {"ticks_left": self._profile_ticks_left,
                "last_result": self._profile_result}

    def _profile_close(self) -> dict:
        self._profile_open = False
        self._profile_ticks_left = 0
        try:
            res = tracing.profiler_stop()
        except Exception as exc:  # a failed capture never stops serving
            res = {"error": f"profiler failed to stop: {exc}"}
        self._profile_result = res
        return res

    def _profile_tick(self) -> None:
        """Decode thread, top of every iteration: count a bounded capture
        down (closing it at zero), then serve a pending stop or start."""
        if self._profile_ticks_left > 0:
            self._profile_ticks_left -= 1
            if self._profile_ticks_left == 0:
                self._profile_close()
        stop, self._profile_stop_req = self._profile_stop_req, None
        if stop is not None:
            stop.set_result(self._profile_close() if self._profile_open
                            else {"error": "profiler not running"})
        start, self._profile_start_req = self._profile_start_req, None
        if start is not None and start[1].set_running_or_notify_cancel():
            (log_dir, ticks), fut = start
            try:
                res = tracing.profiler_start(log_dir, on_caller=True)
            except Exception as exc:  # a failed capture never stops serving
                res = {"error": f"profiler failed to start: {exc}"}
            if res.get("ok"):
                self._profile_open = True
                self._profile_result = None
                self._profile_ticks_left = ticks
                if ticks:
                    res["ticks"] = ticks
            fut.set_result(res)

    def set_brownout(self, budget_frac: float = 1.0,
                     suspend_spec: bool = False,
                     defer_swap_in: bool = False) -> None:
        """Apply one brownout stage's degradations (idempotent; the
        defaults restore): ``budget_frac`` (clamped to [0.05, 1]) scales
        the mixed tick's token budget and the one-shot rows a tick
        drains, ``suspend_spec`` stops drafting, ``defer_swap_in`` stops
        host-tier promotions at lookup. Plain attribute writes, read once
        a tick: a tick-stale read only moves when a stage takes hold."""
        self._bo_budget_frac = min(1.0, max(0.05, float(budget_frac)))
        self._bo_spec_off = bool(suspend_spec)
        self._bo_defer_swap = bool(defer_swap_in)

    def _effective_mixed_budget(self) -> int:
        """The per-tick token budget in force: the configured one scaled
        by the brownout fraction, floored at 1 (admission always
        progresses)."""
        f = self._bo_budget_frac
        if f >= 1.0:
            return self._mixed_budget
        return max(1, int(self._mixed_budget * f))

    def set_draining(self, draining: bool) -> None:
        """Mark the lane draining (the worker's drain and undrain): while
        set, stats() carries ``drain_pressure``. Admission is the worker's
        job; the scheduler only reports."""
        self._draining_flag = bool(draining)

    def set_params(self, params) -> None:
        """Hot weight swap (the worker's reload). The prefix cache and the
        radix tree hold KV computed under the old weights, so both empty
        with the swap (blocks still pinned by live rows free as those rows
        finish). A live row finishes its current tick or chunk on the
        parameters that tick captured and runs its next on the new ones;
        stop the lane first for a hard cut. A tensor-parallel lane shards
        the new tree by the registry's rule."""
        self.params = (self._shard(params) if self._tp_group is not None
                       else params)
        self._prefix_cache = _PrefixCache(self._prefix_cache.budget)
        if self._paged:
            with self._pool.lock:
                self._pool.radix.clear()

    def _shard(self, params) -> TPParams:
        """A whole parameter tree cut into the tp ranks' trees."""
        group = self._tp_group
        return TPParams(tp_rank_trees(self.spec, params, group.devices),
                        group)

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
            if item is not None and item is not _WAKE:
                self._discard_item(item)
                self._fail_request(item.req,
                                   RuntimeError("scheduler stopped"))

    def release(self) -> bool:
        """Drop the stopped lane's device state: the block pool's and the
        slab's tensors, the dense caches, the penalty counts, the drafter
        and the prefix cache's entries (the weights are the caller's).
        Done only once both loop threads have ended, so no tick reads a
        freed block; True if it was done. ``stats()`` still answers."""
        if self._running or self._thread.is_alive() \
                or self._prefill_thread.is_alive():
            return False
        if self._paged:
            with self._pool.lock:
                self._pool.caches = None
                self._pool.scales = None
                self._pool._host = []
        if self._slab:
            with self._spool.lock:
                self._spool.slab = None
        self._caches = None
        self._counts = None
        self._drafter = None
        self._prefix_cache = _PrefixCache(self._prefix_cache.budget)
        return True

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

    @staticmethod
    def _stage(req: _Request, op: str, t0: float, **attrs) -> None:
        """A stage span of ``req`` from ``t0`` (perf_counter) to now."""
        if req.sink is not None:
            dur_us = (time.perf_counter() - t0) * 1e6
            req.sink.stage(op, dur_us, start_ts=time.time() - dur_us / 1e6,
                           **attrs)

    def _first_token_metrics(self, req: _Request, row: int) -> None:
        """The TTFT sample, taken when the row's first token exists."""
        now = time.perf_counter()
        self.ttft_hist.observe(max(0.0, now - req.t_submit))
        self._row_last_emit[row] = now

    def _itl_sample(self, row: int) -> None:
        """An ITL sample: the gap since the row's previous delivery."""
        now = time.perf_counter()
        if self._row_last_emit[row] > 0:
            self.itl_hist.observe(max(0.0, now - self._row_last_emit[row]))
        self._row_last_emit[row] = now

    def _tick_span(self, op: str, t0: float, start_ts: float,
                   **attrs) -> None:
        if self.tracer is not None:
            self.tracer.record("tick", op, self.trace_node,
                               (time.perf_counter() - t0) * 1e6,
                               start_ts=start_ts, attrs=attrs)

    def _blocks_needed(self, pb: int, L: int) -> int:
        """Blocks an admission holds (radix-matched ones included): the
        prompt bucket's, and those of every column up to the first decode
        write plus the decode horizon."""
        bs = self._pool.block_size
        cols = min(min(L, self.max_seq - 1) + self._decode_horizon + 1,
                   self.max_seq)
        return max(pb // bs, (cols - 1) // bs + 1)

    def _promote_reserve(self) -> int:
        """Free blocks a host-tier promotion (or a migration import) must
        leave behind: one per live row, so swapping a cold prefix in never
        starves the next tick's live-row block growth. Read without the
        pool lock: a reserve one row stale only shifts when a promotion
        defers."""
        return sum(1 for r in self._row_req if r is not None)

    def _swap_reserve(self) -> int:
        """The ``promote_reserve`` a radix lookup passes: the live-row
        reserve, or under brownout swap-in deferral the whole pool, which
        no promotion can leave free, so a demoted hit stops at the
        resident prefix and counts ``swap_in_deferred``."""
        if self._bo_defer_swap:
            return self._pool.num_blocks
        return self._promote_reserve()

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
        (completion, cancel, shutdown) funnels here; a slab row frees its
        one state row the same way."""
        if self._slab:
            rid = self._slab_rows[row]
            if rid >= 0:
                with self._spool.lock:
                    self._spool.release_row(rid)
                self._slab_rows[row] = -1
            return
        if not self._row_blocks[row]:
            return
        with self._pool.lock:
            self._pool.release_many(self._row_blocks[row])
        self._row_blocks[row] = []
        self._tables[row, :] = 0

    def _clear_mixed_row(self, row: int) -> None:
        """Drop a freed row's prefill, speculative and handoff state (a
        freed slot never stays parked)."""
        self._held[row] = False
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
            if req.t_admit:
                # The row's whole residence after admission (or after its
                # prompt completed, in mixed mode).
                self._stage(req, "decode", req.t_admit, tokens=len(toks))
            # Row freed and counted before the client sees the result, so
            # stats() read after it never shows a half-finished request.
            self._free_row(row)
            self._bump("completed")
            try:
                req.future.set_result(toks)
            except InvalidStateError:
                pass  # cancelled by the client meanwhile
            if req.stream is not None:
                req.stream.put(None)

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
            t0 = time.perf_counter()
            self._stage(req, "queue_wait", req.t_submit)
            try:
                try:
                    if self._slab:
                        item = self._run_prefill_slab(req)
                    elif not self._paged:
                        item = self._run_prefill_dense(req)
                    elif req.migrate is not None:
                        item = self._run_prefill_import(req)
                    elif self._mixed:
                        item = self._run_prefill_mixed(req)
                    else:
                        item = self._run_prefill_paged(req)
                except Exception as exc:
                    self._fail_request(req, exc)
                    continue
                if not self._mixed:
                    # Mixed mode's prefill runs in the ticks: its span
                    # closes at prompt completion.
                    self._stage(req, "prefill", t0,
                                prompt_len=len(req.prompt))
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
        """Pick the bucket, take the radix pins (promoting the host-tier
        matches the live-row reserve allows), precompute the penalty
        counts. No forward: the prompt's runs inside the decode thread's
        ragged ticks."""
        pool = self._pool
        pb = pick_bucket(self._prompt_buckets, len(req.prompt))
        prompt = req.prompt[-pb:]
        matched: List[int] = []
        swapped = 0
        t0 = time.perf_counter()
        with pool.lock:
            gen = pool.generation
            if self._prefix_sharing:
                si0 = pool.swap_ins
                matched = pool.radix.lookup(          # pins for this row
                    prompt, promote_reserve=self._swap_reserve())
                swapped = pool.swap_ins - si0
        self._record_swap_in(req, swapped, t0)
        self._stage(req, "radix_lookup", t0,
                    matched_tokens=len(matched) * pool.block_size)
        if self.prefix_fetch is not None and req.prefix_hint is not None:
            # The fleet prefix tier: the splice extends the match before
            # formation, so the ragged ticks resume past it as past a
            # deeper local hit.
            matched = self._fetch_prefix_splice(req, prompt, matched, gen,
                                                pb)
        row_counts = None
        if req.rep_penalty != 1.0 or req.stop_tokens:
            # Prompt-token counts only; the first sampled token joins in
            # the tick that samples it.
            row_counts = token_counts([prompt], 1, self.cfg.vocab)
        return _Formed(req, pb, len(prompt), row_counts, matched, prompt,
                       gen)

    def _run_prefill_import(self, req: _Request) -> _Formed:
        """Import-side formation (prefill thread): the chain, checksum,
        geometry and ``max_seq`` gates run here, before any block is
        allocated (a refusal is ``ImportRefused``), then a radix lookup
        re-adopts a prompt prefix this lane already caches (demoted
        matches swap in), so only the rest of the chain ships bytes at
        admission. No prefill runs. The item's ``pb`` is the chain's
        columns."""
        pool = self._pool
        snap = req.migrate
        chain = snap.get("chain")
        reason = None
        if not isinstance(chain, dict) or "blocks" not in chain:
            reason = "snapshot carries no block chain"
        if reason is None:
            reason = pool.chain_compatible(chain)
        if reason is None and not pool.verify_chain(chain):
            reason = "chain checksum mismatch"
        prompt = req.prompt
        bs = pool.block_size
        pos = int(snap["pos"])
        n_chain = (pos - 1) // bs + 1 if pos > 0 else 0
        if reason is None and pos > self.max_seq - 1:
            reason = (f"row position {pos} exceeds this lane's max_seq "
                      f"{self.max_seq}")
        if reason is None and len(chain["blocks"]) < n_chain:
            reason = (f"chain holds {len(chain['blocks'])} blocks but "
                      f"the row spans {n_chain}")
        if reason is not None:
            self._bump_migration("import_rejected")
            raise ImportRefused(f"migration import rejected: {reason}")
        matched: List[int] = []
        swapped = 0
        t0 = time.perf_counter()
        with pool.lock:
            gen = pool.generation
            if self._prefix_sharing:
                si0 = pool.swap_ins
                matched = pool.radix.lookup(
                    prompt, promote_reserve=self._swap_reserve())
                swapped = pool.swap_ins - si0
                # The tree indexes full prompt blocks only, so a match
                # never passes the chain; clamp as a backstop.
                if len(matched) > n_chain:
                    pool.release_many(matched[n_chain:])
                    matched = matched[:n_chain]
        self._record_swap_in(req, swapped, t0)
        row_counts = None
        if req.rep_penalty != 1.0 or req.stop_tokens:
            # The penalty counts replay from the whole context, prompt and
            # every emitted token, as the source's counts held them.
            ctx = prompt + [int(t) for t in snap["emitted"]]
            row_counts = token_counts([ctx], 1, self.cfg.vocab)
        return _Formed(req, n_chain * bs, len(prompt), row_counts, matched,
                       prompt, gen)

    # -- the state_slab family's formation -----------------------------------

    def _run_prefill_slab(self, req: _Request) -> _Formed:
        """Formation on a slab lane (prefill thread). A migration import
        checks its chain; mixed mode forms the request with no device work
        (the prompt's recurrence runs in the ticks, in the row's slab row);
        two-path mode consumes the prompt through the recurrence in
        windows of ``prefill_chunk`` tokens from a zero state of its own
        (no slab row is read: a recurrent prefix is not shared), one
        ``ssd_window_scan_rows`` per window, and samples the first token.
        The prompt is not cut to a bucket; ``pb`` is its length."""
        if req.migrate is not None:
            return self._run_prefill_import_slab(req)
        spool = self._spool
        prompt = list(req.prompt)
        L = len(prompt)
        with spool.lock:
            gen = spool.generation
        if self._mixed:
            row_counts = None
            if req.rep_penalty != 1.0 or req.stop_tokens:
                row_counts = token_counts([prompt], 1, self.cfg.vocab)
            return _Formed(req, L, L, row_counts, [], prompt, gen)
        Leff = max(L, 1)  # an empty prompt consumes one pad-token step
        W = self._prefill_chunk if self._prefill_chunk > 0 else 64
        W = max(1, min(W, self.max_seq))
        dev = self.device
        state = torch.zeros((self.cfg.n_layers, 1, ssd_state_dim(self.cfg)),
                            dtype=torch.float32, device=dev)
        row0 = torch.zeros((1,), dtype=torch.int32, device=dev)
        tokens = np.zeros((1, W), np.int32)
        logits = None
        for w0 in range(0, Leff, W):
            n_valid = min(W, Leff - w0)
            tokens[:] = 0
            if L:
                tokens[0, :n_valid] = prompt[w0:w0 + n_valid]
            logits = ssd_window_scan_rows(
                self.params, torch.from_numpy(tokens).to(dev), state, row0,
                torch.tensor([n_valid], dtype=torch.int32, device=dev),
                torch.tensor([n_valid - 1], device=dev), self.cfg)
            self._count_admission_dispatch()
        first_tok, row_counts = self._first_token(req, logits[0], prompt, L)
        return _Formed(req, L, L, row_counts, [], prompt, gen, state[:, 0],
                       first_tok)

    def _run_prefill_import_slab(self, req: _Request) -> _Formed:
        """A slab import's gates (prefill thread), before any row is
        allocated: the one-pseudo-block chain's geometry and checksum and
        the position against ``max_seq`` (a refusal is ``ImportRefused``).
        No prefill runs: the whole state arrives in the chain."""
        spool = self._spool
        snap = req.migrate
        chain = snap.get("chain")
        reason = None
        if not isinstance(chain, dict) or "blocks" not in chain:
            reason = "snapshot carries no state chain"
        if reason is None:
            reason = spool.chain_compatible(chain)
        if reason is None and not spool.verify_chain(chain):
            reason = "chain checksum mismatch"
        pos = int(snap["pos"])
        if reason is None and pos > self.max_seq - 1:
            reason = (f"row position {pos} exceeds this lane's max_seq "
                      f"{self.max_seq}")
        if reason is not None:
            self._bump_migration("import_rejected")
            raise ImportRefused(f"migration import rejected: {reason}")
        prompt = [int(t) for t in snap["prompt"]]
        row_counts = None
        if req.rep_penalty != 1.0 or req.stop_tokens:
            ctx = prompt + [int(t) for t in snap["emitted"]]
            row_counts = token_counts([ctx], 1, self.cfg.vocab)
        with spool.lock:
            gen = spool.generation
        return _Formed(req, len(prompt), len(prompt), row_counts, [], prompt,
                       gen)

    def _record_swap_in(self, req: _Request, swapped: int,
                        t0: float) -> None:
        """A ``swap_in`` span for a lookup that promoted demoted blocks:
        the radix hit was served from the host tier."""
        if swapped:
            self._stage(req, "swap_in", t0, blocks=swapped)

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
        swapped = 0
        t0 = time.perf_counter()
        with pool.lock:
            gen = pool.generation
            if self._prefix_sharing:
                si0 = pool.swap_ins
                matched = pool.radix.lookup(          # pins for this row
                    prompt, promote_reserve=self._swap_reserve())
                swapped = pool.swap_ins - si0
        m_tok = len(matched) * bs
        self._record_swap_in(req, swapped, t0)
        if self.prefix_fetch is not None and req.prefix_hint is not None:
            # The fleet prefix tier: a hinted (partial) miss pulls the
            # peer's deeper chain before the gather; spliced blocks ride
            # the row cache as local radix hits do. The radix_lookup span
            # keeps the local match.
            matched = self._fetch_prefix_splice(req, prompt, matched, gen,
                                                pb)
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
            elif self._tp_group is not None:
                row_caches = tp_init_caches(self.cfg, self._tp_group, 1,
                                            pb, self._dtype)
            else:
                row_caches = init_caches(self.cfg, 1, pb, self._dtype,
                                         self.device)
            self._stage(req, "radix_lookup", t0, matched_tokens=m_tok)
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
        if self._slab:
            self._admit_slab(item, row)
        elif not self._paged:
            self._admit_dense(item, row)
        elif item.req.migrate is not None:
            self._admit_import(item, row)
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
        self._first_token_metrics(req, row)
        self._push_stream(row, req)  # the first token flushes at admission
        self._maybe_complete(row)

    def _admit_dense(self, item: _Formed, row: int) -> None:
        """Dense admission (decode thread): copy the row cache into columns
        [0, pb) of the row in the shared cache (a copy, so a prefix-cache
        entry is never the tensor a later write lands in), with the row's
        token counts when it has controls; the row decodes from column pb
        with start pb - L."""
        req, pb, L, row_counts = item[:4]
        req.t_admit = time.perf_counter()
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
        t0 = time.perf_counter()
        req.t_admit = t0
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
        self._stage(req, "kv_alloc", t0, blocks=len(table), shared_blocks=m)
        self._set_row_table(row, table, row_counts)
        if self._spec:
            # The drafter's lookup corpus: prompt + emitted so far.
            self._row_prompt_toks[row] = item.prompt
        self._set_row_params(req, row, first_col)
        self._emit_first_token(item, row)
        self._maybe_hold(row, req)

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
        t0 = time.perf_counter()
        req.t_admit = t0
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
        self._stage(req, "kv_alloc", t0, blocks=len(table), shared_blocks=m)
        self._set_row_table(row, table, row_counts)
        self._set_row_params(req, row, first_col)
        self._prefilling[row] = True
        self._row_prompt[row] = right_pad_prompt(item.prompt, pb)[0]
        self._row_prompt_toks[row] = item.prompt
        self._row_L[row] = L
        self._row_w0[row] = p0
        self._row_emitted[row] = []
        self._done[row] = False

    def _admit_import(self, item: _Formed, row: int) -> None:
        """Decode-thread half of a migration import: allocate blocks for
        the chain and the decode horizon (re-adopted prefix blocks enter
        pinned), make the append block private, write the unmatched chain
        tail verbatim into the fresh blocks, index the prompt in the radix
        tree, and restore the row's host state: pos, pending token,
        sampling parameters, emitted list and penalty counts. Raises
        PoolExhausted (nothing consumed) when the pool cannot hold the
        chain and keep the live-row reserve free; the loop then fails the
        import with ImportRefused (imports never park)."""
        req, _pb, L, row_counts, matched, prompt, gen = item[:7]
        pool = self._pool
        bs = pool.block_size
        snap = req.migrate
        chain = snap["chain"]
        emitted = [int(t) for t in snap["emitted"]]
        pos = min(int(snap["pos"]), self.max_seq - 1)
        n_chain = (pos - 1) // bs + 1 if pos > 0 else 0
        m = len(matched)
        t0 = time.perf_counter()
        req.t_admit = t0
        with pool.lock:
            if gen != pool.generation:
                raise _StaleAdmission(
                    "kv pool was rebuilt during this import")
            cols = min(pos + self._decode_horizon + 1, self.max_seq)
            need = max(n_chain, (cols - 1) // bs + 1)
            reserve = self._promote_reserve()
            if not pool.can_alloc(need - m + reserve):
                raise PoolExhausted(
                    f"import needs {need - m} blocks + {reserve} "
                    f"reserve; {pool.free_blocks} free of "
                    f"{pool.num_blocks - 1}")
            fresh = pool.alloc(need - m)
            table = list(matched) + fresh
            try:
                wid, copied = pool.ensure_writable(table[pos // bs])
            except PoolExhausted:
                pool.release_many(fresh)
                raise
            if copied:
                table[pos // bs] = wid
            pool.import_chain(chain, chain["blocks"][m:n_chain],
                              fresh[:n_chain - m])
            if self._prefix_sharing:
                pool.radix.insert(prompt, table)
            pool.prefix_hit_tokens += m * bs
        self._count_admission_dispatch()
        self._stage(req, "kv_import", t0, blocks=len(table), shared_blocks=m,
                    imported_blocks=n_chain - m)
        self._set_row_table(row, table, row_counts)
        self._set_row_params(req, row, pos)
        self._tok[row] = int(snap["tok"])
        self._done[row] = False
        self._row_emitted[row] = emitted
        if self._mixed:
            self._prefilling[row] = False
            self._row_prompt[row] = None
            self._row_L[row] = L
            self._row_w0[row] = 0
        if self._mixed or self._spec:
            self._row_prompt_toks[row] = prompt
        # No TTFT sample (the first token came from the source lane); ITL
        # resumes from here.
        self._row_last_emit[row] = time.perf_counter()
        with self._stats_lock:
            mig = self._migration_stats()
            mig["imported_rows"] += 1
            mig["imported_tokens"] += len(emitted)
            mig["imported_chain_tokens"] += (n_chain - m) * bs
        self._push_stream(row, req)
        self._maybe_complete(row)

    def _alloc_slab_row(self, item: _Formed, row: int, state,
                        what: str) -> int:
        """Allocate the row's one slab row and write its state (``state``:
        (L, state_dim), None for zeros, or a chain dict to import), under
        the pool lock. Raises PoolExhausted (nothing consumed) when no row
        is free, _StaleAdmission across a pool rebuild."""
        spool = self._spool
        with spool.lock:
            if item.gen != spool.generation:
                raise _StaleAdmission(
                    f"state slab pool was rebuilt during this {what}")
            rid = spool.alloc_row()
            if isinstance(state, dict):
                spool.import_row_chain(state, rid)
            else:
                spool.write_row(rid, state)
        self._slab_rows[row] = rid
        if item.row_counts is not None:
            self._ensure_counts()[row] = torch.as_tensor(
                item.row_counts[0], device=self.device)
        return rid

    def _admit_slab(self, item: _Formed, row: int) -> None:
        """Slab admission (decode thread): ONE slab row for the stream's
        whole life. Two-path: the prefill thread's state lands in it and
        the first token is emitted. Mixed: the row is zeroed (the prompt's
        recurrence accumulates in it across ticks; a previous occupant's
        bytes never leak into a fresh state) and marked PREFILLING. An
        import writes the chain's bytes verbatim and restores the stream's
        host state: zero re-prefilled tokens. Raises PoolExhausted (nothing
        consumed) when no row is free."""
        req, _pb, L, _counts, _m, prompt = item[:6]
        t0 = time.perf_counter()
        req.t_admit = t0
        if req.migrate is not None:
            snap = req.migrate
            rid = self._alloc_slab_row(item, row, snap["chain"], "import")
            self._count_admission_dispatch()
            self._stage(req, "state_import", t0, state_row=rid,
                        state_bytes=self._spool.bytes_per_row())
            emitted = [int(t) for t in snap["emitted"]]
            self._set_row_params(req, row, min(int(snap["pos"]),
                                               self.max_seq - 1))
            self._tok[row] = int(snap["tok"])
            self._done[row] = False
            self._row_emitted[row] = emitted
            if self._mixed:
                self._prefilling[row] = False
                self._row_prompt[row] = None
                self._row_prompt_toks[row] = prompt
                self._row_L[row] = L
                self._row_w0[row] = 0
            # No TTFT sample (the first token came from the source lane).
            self._row_last_emit[row] = time.perf_counter()
            with self._stats_lock:
                mig = self._migration_stats()
                mig["imported_rows"] += 1
                mig["imported_tokens"] += len(emitted)
            self._push_stream(row, req)
            self._maybe_complete(row)
            return
        first_col = min(L, self.max_seq - 1)
        if not self._mixed:
            rid = self._alloc_slab_row(item, row, item.row_caches,
                                       "request's admission")
            self._count_admission_dispatch()
            self._stage(req, "state_alloc", t0, state_row=rid)
            self._set_row_params(req, row, first_col)
            self._emit_first_token(item, row)
            self._maybe_hold(row, req)
            return
        rid = self._alloc_slab_row(item, row, None, "request's admission")
        self._stage(req, "state_alloc", t0, state_row=rid)
        self._set_row_params(req, row, first_col)
        self._prefilling[row] = True
        self._row_prompt[row] = right_pad_prompt(prompt, max(L, 1))[0]
        self._row_prompt_toks[row] = prompt
        self._row_L[row] = L
        self._row_w0[row] = 0  # no prefix resume: the prompt runs whole
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
            if (req is None or self._done[r] or self._prefilling[r]
                    or self._held[r]):
                continue  # parked handoff rows decode nothing this tick
            last_col = min(int(self._pos[r]) + self._row_horizon(r, req),
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

    def _row_horizon(self, r: int, req: _Request) -> int:
        """Columns past `pos` the next tick may write for row r: the
        static ``_decode_horizon``, except under speculation, where a row
        near its token budget writes only its remaining tokens (the draft
        cap shrinks the same way, so growth and the trim agree)."""
        if not self._spec:
            return self._decode_horizon
        return min(self._decode_horizon,
                   max(1, req.max_new - len(self._row_emitted[r])))

    def _trim_row_tail(self, r: int, req: _Request) -> None:
        """Return blocks past a row's reachable horizon: a verify window
        that crossed a block edge may have grown a block the row, after
        rejections and near its budget, can no longer write. Stale draft
        K/V in the blocks it keeps stays hidden by the position mask.
        Radix-shared prefix blocks lie below `pos` and are never touched;
        the freed table entries are zeroed."""
        bs = self._pool.block_size
        last_col = min(int(self._pos[r]) + self._row_horizon(r, req),
                       self.max_seq - 1)
        need = last_col // bs + 1
        blocks = self._row_blocks[r]
        if len(blocks) <= need:
            return
        with self._pool.lock:
            freed = self._pool.release_tail(blocks, need)
        if freed:
            self._tables[r, need:need + freed] = 0
            with self._stats_lock:
                self._stats["spec"]["tail_blocks_released"] += freed

    @staticmethod
    def _spec_eligible(req: _Request) -> bool:
        """Rows the drafter may propose for: every greedy row (the verify
        loop re-derives each token by the plain rule, controls included),
        and rows at temperature > 0 only without filters, penalty or stop
        list, none of which composes with the rejection residual (those
        rows ride at q_len 1, as in the plain lane)."""
        if req.temperature == 0.0:
            return True
        return (req.top_p >= 1.0 and req.top_k == 0 and req.min_p == 0.0
                and req.rep_penalty == 1.0 and not req.stop_tokens)

    def _complete_prefill_row(self, r: int, req: _Request, first_tok: int,
                              done: bool) -> None:
        """Prompt consumed: index the filled prompt blocks in the radix
        tree (at completion, never earlier), then emit the first token."""
        self._prefilling[r] = False
        if self._prefix_sharing:
            with self._pool.lock:
                self._pool.radix.insert(self._row_prompt_toks[r],
                                        self._row_blocks[r])
        if req.sink is not None:
            self._stage(req, "prefill", req.t_admit,
                        prompt_len=self._row_L[r])
            req.t_admit = time.perf_counter()  # the decode span's start
        self._tok[r] = first_tok
        self._done[r] = done
        self._row_emitted[r] = [first_tok]
        self._first_token_metrics(req, r)
        self._push_stream(r, req)
        self._maybe_complete(r)
        self._maybe_hold(r, req)

    def _prefill_chunks(self, prefill_rows: List[int],
                        n_decode: int) -> np.ndarray:
        """(B,) prefill tokens each admitting row takes this tick: the
        token budget less one per decode row, split over the admitting
        rows in row order, at most the chunk cap each; the first always
        gets at least one token, so admission never deadlocks."""
        chunk = np.zeros((self.n_slots,), np.int32)
        budget_left = max(1, self._effective_mixed_budget() - n_decode)
        for r in prefill_rows:
            remaining = max(self._row_L[r], 1) - self._row_w0[r]
            c = min(remaining, self._chunk_cap, budget_left)
            chunk[r] = max(0, c)
            budget_left -= chunk[r]
        return chunk

    def _tick_mixed(self) -> None:
        """One mixed tick: form the ragged batch (decode rows x 1 token +
        admitting rows x a budgeted prefill chunk), issue exactly ONE
        forward, sample, and apply the results host-side. Decode rows are
        always included; the remaining budget splits over prefilling rows
        in row order, and the first prefilling row always gets at least
        one token, so admission never deadlocks behind a full batch."""
        t0 = time.perf_counter()
        start_ts = time.time()
        pool = None if self._slab else self._pool
        B = self.n_slots
        eos_vec, controls = self._eos_and_controls()
        n_decode = 0
        prefill_rows: List[int] = []
        for r, req in enumerate(self._row_req):
            if req is None:
                continue
            if self._held[r]:
                continue  # parked handoff rows: no budget, no decode slot
            if self._prefilling[r]:
                prefill_rows.append(r)
            else:
                n_decode += 1
        chunk = self._prefill_chunks(prefill_rows, n_decode)
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
                # Parked handoff rows ride inactive, as done rows do: the
                # write stays in the not-yet-valid column `pos`, the
                # sample is discarded, the host state untouched below.
                active[r] = not self._done[r] and not self._held[r]

        # ONE forward. The pool lock is not held: in mixed mode the prefill
        # thread's only pool copies are a lookup's host-tier promotions
        # into free blocks and demotions of tree-only blocks, which no row
        # of this tick reads or writes, issued on the same stream.
        dev = self.device
        if self._slab:
            # The window scan over the slab rows: decode rows take one
            # step, admitting rows their chunk; a done or parked row rides
            # with qlen 0, its state frozen.
            step_ok = np.array([self._prefilling[r] or active[r]
                                for r in range(B)])
            logits = self._slab_forward(tokens, np.where(step_ok, qlen, 0),
                                        sample_slot)
        else:
            logits = transformer_step_rows_ragged(
                self.params, torch.from_numpy(tokens).to(dev), pool.caches,
                torch.from_numpy(self._tables).to(dev),
                torch.from_numpy(pos0).to(dev),
                torch.from_numpy(qlen).to(dev), self.cfg, dtype=self._dtype,
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
            if req is None or self._held[r]:
                continue  # parked: nothing was dispatched for this row
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
                self._itl_sample(r)
            self._push_stream(r, req)
            self._maybe_complete(r)
        self._tick_span("mixed_step", t0, start_ts,
                        prefill_tokens=int(prefill_tokens),
                        decode_rows=int(n_decode), width=int(width))

    def _tick_spec(self) -> None:
        """One speculative tick, in place of the mixed tick (mixed mode)
        or the decode chunk (two-path mode): ask the drafter for up to
        ``spec_k`` proposals per eligible decode row, form ONE ragged
        batch (decode rows: verify windows of q_len proposals + 1; mixed
        mode's admitting rows: their budgeted prefill chunk), issue one
        forward and the accept/emit loop (``_spec_step``), and
        advance each row by its accepted prefix plus the corrected or
        bonus token."""
        t0 = time.perf_counter()
        start_ts = time.time()
        B = self.n_slots
        S = self._spec_k + 1
        eos_vec, controls = self._eos_and_controls()
        n_decode = 0
        prefill_rows: List[int] = []
        for r, req in enumerate(self._row_req):
            if req is None:
                continue
            if self._held[r]:
                continue  # parked handoff rows: no budget, no proposals
            if self._prefilling[r]:  # mixed mode's admitting rows only
                prefill_rows.append(r)
            else:
                n_decode += 1
        # A decode row counts 1 against the budget: its window re-derives
        # tokens, it does not widen the stream.
        chunk = self._prefill_chunks(prefill_rows, n_decode)

        # Drafting, on the host. The cap keeps a window inside the row's
        # token budget and inside the cache (window columns < max_seq).
        drafts: List[List[int]] = [[] for _ in range(B)]
        proposed = 0
        scan = getattr(self._drafter, "max_scan", 0)
        for r, req in enumerate(self._row_req):
            if (req is None or self._done[r] or self._prefilling[r]
                    or self._held[r] or self._bo_spec_off):
                # Brownout spec suspension: no proposals, every decode
                # row rides q_len 1 through the same dispatch.
                continue
            kcap = min(self._spec_k,
                       req.max_new - len(self._row_emitted[r]) - 1,
                       self.max_seq - 2 - int(self._pos[r]))
            if kcap <= 0 or not self._spec_eligible(req):
                continue
            em = self._row_emitted[r]
            pp = self._row_prompt_toks[r] or []
            if scan:
                # Slice the tails before concatenating: a long prompt
                # costs O(max_scan) per drafted row per tick, not O(L).
                need = scan - len(em)
                ctx = (pp[-need:] if need > 0 else []) + em[-scan:]
            else:
                ctx = pp + em
            d = self._drafter.propose(ctx, kcap)[:kcap]
            if d:
                drafts[r] = [int(t) for t in d]
                proposed += len(drafts[r])

        # Two ragged widths: S (decode-only ticks) and max(chunk cap, S)
        # (mixed ticks that carry a prefill chunk).
        width = S
        if prefill_rows and chunk.max() > 0:
            width = max(self._chunk_cap, S)
        tokens = np.zeros((B, width), np.int32)
        pos0 = np.zeros((B,), np.int32)
        qlen = np.zeros((B,), np.int32)
        sample_slot = np.zeros((B,), np.int32)
        fold0 = np.zeros((B,), np.int64)
        n_draft = np.zeros((B,), np.int32)
        stoch = np.zeros((B,), bool)
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
                        completing[r] = True
                        active[r] = True
                        sample_slot[r] = Leff - 1 - w0
                        fold0[r] = self._row_L[r]
            else:
                nd = len(drafts[r])
                pos0[r] = self._pos[r]
                qlen[r] = 1 + nd
                tokens[r, 0] = self._tok[r]
                if nd:
                    tokens[r, 1:1 + nd] = drafts[r]
                fold0[r] = int(self._pos[r]) + 1
                n_draft[r] = nd
                # Only drafted rows at temperature > 0 take the rejection
                # rule; an all-greedy tick skips its draws entirely.
                stoch[r] = req.temperature > 0 and nd > 0
                active[r] = not self._done[r] and not self._held[r]

        emitted_h, n_emit_h, n_acc_h, done_new = self._spec_step(
            tokens, pos0, qlen, sample_slot, fold0, n_draft, stoch, active,
            eos_vec, controls)
        # Dispatch counted past the host sync (a failed step surfaces
        # there and must leave dispatches == ticks); a separate site from
        # the tick counters below.
        with self._stats_lock:
            self._stats["spec"]["dispatches"] += 1
            if self._mixed:
                self._stats["mixed"]["dispatches"] += 1

        with self._stats_lock:
            sp = self._stats["spec"]
            sp["ticks"] += 1
            sp["proposed_tokens"] += proposed
            sp["draft_dispatches"] = getattr(self._drafter, "dispatches", 0)
            if self._mixed:
                m = self._stats["mixed"]
                m["ticks"] += 1
                m["prefill_tokens"] += prefill_tokens
                if prefill_tokens and n_decode:
                    m["coscheduled_ticks"] += 1

        accepted = decode_emitted = row_ticks = 0
        for r in range(B):
            req = self._row_req[r]
            if req is None or self._held[r]:
                continue  # parked: nothing was dispatched for this row
            if self._prefilling[r]:
                self._row_w0[r] += int(chunk[r])
                if completing[r]:
                    self._complete_prefill_row(r, req, int(emitted_h[r, 0]),
                                               bool(done_new[r]))
                continue
            ne = int(n_emit_h[r])
            toks = [int(t) for t in emitted_h[r, :ne]]
            accepted += int(n_acc_h[r])
            decode_emitted += ne
            row_ticks += ne > 0
            self._done[r] = bool(done_new[r])
            if ne:
                self._tok[r] = toks[-1]
                # The token that ends the row (EOS or stop) is never
                # written to the cache: the plain lane's position freeze.
                adv = ne - 1 if self._done[r] else ne
                self._pos[r] = min(int(self._pos[r]) + adv, self.max_seq - 1)
                need = req.max_new - len(self._row_emitted[r])
                if need > 0:
                    self._row_emitted[r].extend(toks[:need])
                    self._itl_sample(r)
            self._push_stream(r, req)
            self._maybe_complete(r)
            if self._row_req[r] is not None and not self._done[r]:
                self._trim_row_tail(r, req)
        with self._stats_lock:
            sp = self._stats["spec"]
            sp["accepted_tokens"] += accepted
            sp["emitted_tokens"] += decode_emitted
            sp["row_ticks"] += row_ticks
            if self._mixed:
                self._stats["mixed"]["decode_tokens"] += decode_emitted
        self._tick_span("spec_verify", t0, start_ts,
                        decode_rows=int(n_decode), proposed=int(proposed),
                        accepted=int(accepted), width=int(width))
        if self._mixed:
            self._tick_span("mixed_step", t0, start_ts,
                            prefill_tokens=int(prefill_tokens),
                            decode_rows=int(n_decode), width=int(width))

    def _spec_step(self, tokens, pos0, qlen, sample_slot, fold0, n_draft,
                   stoch, active, eos_vec, controls: bool):
        """ONE ragged forward scoring every row's window at S = spec_k + 1
        slots from its ``sample_slot``, the S-slot accept/emit loop
        (``spec_accept_emit``) and one host copy of its results: host
        arrays (emitted (B, S), n_emit (B,), n_acc (B,), done (B,))."""
        dev = self.device
        pool = self._pool

        def on(a):
            return torch.from_numpy(a).to(dev)

        tokens_t = on(tokens)
        # Two-path mode: the prefill thread gathers from the pool under its
        # lock, so the pool writes are issued under it too (mixed mode: the
        # prefill thread copies only blocks no row holds, as in
        # _tick_mixed).
        lock = contextlib.nullcontext() if self._mixed else pool.lock
        with lock:
            logits = transformer_step_rows_ragged(
                self.params, tokens_t, pool.caches, on(self._tables),
                on(pos0), on(qlen), self.cfg, dtype=self._dtype,
                sample_slot=on(sample_slot), sample_width=self._spec_k + 1,
                scales=pool.scales)[0]                     # (B, S, V)
        ctl = {}
        if controls:
            ctl = dict(counts=self._ensure_counts(), pens=on(self._pens),
                       stops=on(self._stops.astype(np.int64)))
        emitted, n_emit, n_acc, done = spec_accept_emit(
            logits, tokens_t, on(sample_slot), on(fold0), on(n_draft),
            stoch, on(active), on(self._done.copy()), self._seeds,
            self._temps, self._topps, self._topks, self._minps, on(eos_vec),
            **ctl)
        b, S = emitted.shape
        host = torch.cat([emitted.flatten(), n_emit.long(), n_acc.long(),
                          done.long()]).cpu().numpy()
        n = b * S  # the tick's one host sync, above
        return (host[:n].reshape(b, S), host[n:n + b], host[n + b:n + 2 * b],
                host[n + 2 * b:].astype(bool))

    def _slab_row_ids(self) -> np.ndarray:
        """(n_slots,) int32 slab row of each slot, the null row 0 for a
        slot that holds none."""
        return np.asarray([rid if rid >= 0 else 0
                           for rid in self._slab_rows], np.int32)

    def _slab_forward(self, tokens, qlen, sample_slot, row_ids=None):
        """ONE window scan over the slab rows (``ssd_window_scan_rows``,
        the kernel on the card) under the pool lock: tokens (B, W), qlen
        and sample_slot (B,) host arrays or device tensors. Returns the
        (B, vocab) logits."""
        dev = self.device

        def on(a):
            return a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.asarray(a)).to(dev)

        if row_ids is None:
            row_ids = on(self._slab_row_ids())
        spool = self._spool
        with spool.lock:
            return ssd_window_scan_rows(
                self.params, on(tokens), spool.slab, row_ids,
                on(qlen).to(torch.int32), on(sample_slot), self.cfg)

    def _decode_step_fn(self):
        """One decode step of every row, (tok, pos, start, done) ->
        logits: over the dense cache (``transformer_decode_rows``), over
        the block pool (``transformer_decode_rows_paged``, rows 0-aligned)
        with the step's pool writes issued under the pool lock, so a
        prefix gather the prefill thread issues runs between two steps,
        never across one (taking the lock per step, not per chunk, lets the
        prefill thread's lookups and gathers in between), or over the slab
        (one-slot window scans; done rows ride with qlen 0, their state
        frozen)."""
        if self._slab:
            dev = self.device
            row_ids = torch.from_numpy(self._slab_row_ids()).to(dev)
            zero = torch.zeros((self.n_slots,), dtype=torch.long, device=dev)

            def step(tok, pos, start, done):
                return self._slab_forward(tok[:, None], ~done, zero,
                                          row_ids=row_ids)
            return step
        if not self._paged:
            def step(tok, pos, start, done):
                return transformer_decode_rows(
                    self.params, tok, self._caches, pos, self.cfg,
                    dtype=self._dtype, start_vec=start)[0]
            return step
        pool = self._pool
        tables = torch.from_numpy(self._tables).to(self.device)

        def step(tok, pos, start, done):
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
        # Parked handoff rows ride the chunk as done rows (position
        # frozen, samples discarded, writes in the not-yet-valid column
        # `pos`) and get their host state back after it.
        held_rows = [r for r in range(self.n_slots)
                     if self._row_req[r] is not None and self._held[r]]
        saved = [(r, int(self._tok[r]), int(self._pos[r]))
                 for r in held_rows]
        done_in = self._done.copy()
        done_in[held_rows] = True
        done = torch.from_numpy(done_in).to(dev)
        seeds = torch.from_numpy(self._seeds).to(dev)
        eos = torch.from_numpy(eos_vec).to(dev)
        if controls:
            counts = self._ensure_counts()
            pens = torch.from_numpy(self._pens).to(dev)
            stops = torch.from_numpy(self._stops.astype(np.int64)).to(dev)
            rows = torch.arange(self.n_slots, device=dev)
        toks = []
        for _ in range(self._step_chunk):
            logits = step(tok, pos, start, done)
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
        for r, tok_r, pos_r in saved:
            self._tok[r] = tok_r
            self._pos[r] = pos_r
            self._done[r] = False
        self._stats["chunks"] += 1
        for r, req in enumerate(self._row_req):
            if req is None or self._held[r]:
                continue
            need = req.max_new - len(self._row_emitted[r])
            if need > 0:
                self._row_emitted[r].extend(
                    int(t) for t in toks_host[r, :need])
                self._itl_sample(r)
            self._push_stream(r, req)  # fresh tokens flush per chunk
            self._maybe_complete(r)

    def _serve_exports(self) -> None:
        """Answer the pending export commands: called by the decode loop
        at the top of every iteration, the tick boundary. A command whose
        row has not finished prefill yet (wait_prefill) waits for the
        next boundary, bounded by its own deadline."""
        pending = self._export_waiting
        self._export_waiting = []
        while True:
            try:
                pending.append(self._migrate_q.get_nowait())
            except queue.Empty:
                break
        for tag, fut, opts in pending:
            if fut.done():
                continue
            try:
                if opts.get("cancel"):
                    result = self._cancel_hold(tag)
                else:
                    result = self._do_export(tag, opts)
            except Exception as exc:  # an export never kills the loop
                result = {"ok": False, "reason": f"export failed: {exc}"}
            if result is None:  # not exportable yet: next boundary
                self._export_waiting.append((tag, fut, opts))
                continue
            if not fut.done():
                fut.set_result(result)

    def _do_export(self, tag: str, opts: Optional[dict] = None
                   ) -> Optional[dict]:
        """Decode-thread half of export_row (the row is quiescent here).
        On success the row is gone from this lane: its stream flushed and
        ended with StreamMigratedAway, its blocks released (radix-shared
        prefix blocks stay in the tree), its slot free. None: a
        ``wait_until`` command whose row is still queued or prefilling,
        before its bound."""
        waiting = (opts is not None
                   and opts.get("wait_until") is not None
                   and time.monotonic() < opts["wait_until"])
        row = next((r for r, req in enumerate(self._row_req)
                    if req is not None and req.oneshot is None
                    and req.tag == tag), None)
        if row is None:
            if waiting:
                return None  # not admitted yet
            return {"ok": False, "reason": "no live row with this tag"}
        req = self._row_req[row]
        if self._mixed and self._prefilling[row]:
            if waiting:
                return None  # its prefill chunks still run
            # Nothing emitted yet: a replay re-prefills exactly what an
            # import would have to ship, so refusing costs nothing.
            self._bump_migration("export_refused")
            return {"ok": False, "reason": "row is mid-prefill"}
        if self._done[row]:
            self._bump_migration("export_refused")
            return {"ok": False, "reason": "row already finishing"}
        pos = int(self._pos[row])
        # Cross-lane stitching of a traced stream: the chain carries the
        # row's trace context and the snapshot its traceparent, so the
        # importing lane's spans join this trace (both keys additive).
        trace_hdr = None
        if self.trace_stitch and req.sink is not None:
            trace_hdr = {"trace_id": req.sink.ctx.trace_id,
                         "parent_id": req.sink.ctx.span_id}
        if self._slab:
            # The whole state is ONE slab row: it ships as a
            # one-pseudo-block chain of the same wire format.
            t0 = time.perf_counter()
            spool = self._spool
            with spool.lock:
                chain = spool.export_row_chain(self._slab_rows[row])
            if trace_hdr is not None:
                chain = dict(chain, trace=trace_hdr)
            self._stage(req, "state_export", t0,
                        state_bytes=spool.bytes_per_row())
            prompt = list(req.prompt)
        else:
            pool = self._pool
            n_chain = (pos - 1) // pool.block_size + 1 if pos > 0 else 0
            with pool.lock:
                chain = pool.export_chain(self._row_blocks[row][:n_chain],
                                          trace=trace_hdr)
            # The bucket-truncated prompt is what the row's columns hold.
            pb = pick_bucket(self._prompt_buckets, len(req.prompt))
            prompt = req.prompt[-pb:]
        emitted = list(self._row_emitted[row])
        # Flush everything visible before the terminal, so the stream and
        # the snapshot agree on the resume offset.
        self._push_stream(row, req)
        snap = {
            "ok": True, "tag": tag,
            "prompt": [int(t) for t in prompt],
            "emitted": [int(t) for t in emitted],
            "streamed": int(req.streamed),
            "pos": pos, "tok": int(self._tok[row]),
            "max_new": int(req.max_new), "eos_id": int(req.eos_id),
            "temperature": float(req.temperature), "seed": int(req.seed),
            "top_p": float(req.top_p), "top_k": int(req.top_k),
            "min_p": float(req.min_p),
            "repetition_penalty": float(req.rep_penalty),
            "stop_tokens": [int(t) for t in req.stop_tokens],
            "chain": chain,
        }
        if trace_hdr is not None:
            snap["traceparent"] = req.sink.ctx.to_traceparent()
        self._fail_request(req, StreamMigratedAway(
            f"stream migrated off this lane after {req.streamed} tokens",
            tokens_emitted=req.streamed))
        self._free_row(row)
        with self._stats_lock:
            m = self._migration_stats()
            m["exported_rows"] += 1
            m["exported_tokens"] += len(emitted)
        return snap

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
        self._flight_anomaly(f"recover:{type(exc).__name__}")
        self._counts = None
        if self._stateless:
            return
        if self._slab:
            # The slab may hold half-written rows: rebuild it; row ids of
            # the old generation are void.
            with self._spool.lock:
                self._spool.reset()
                spool = self._spool
                violations = []
                if len(spool._free) != spool.num_rows - 1:
                    violations.append(f"free list {len(spool._free)} != "
                                      f"{spool.num_rows - 1}")
                if int(np.sum(spool._ref[1:])) != 0:
                    violations.append("nonzero refcounts after reset")
            self._slab_rows = [-1] * self.n_slots
            self._report_violations(violations)
            return
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
        self._report_violations(violations)

    def _report_violations(self, violations: List[str]) -> None:
        if violations:
            self._bump("recover_invariant_violations", len(violations))
            print(f"[scheduler] POST-RECOVER INVARIANT VIOLATED: "
                  f"{'; '.join(violations)}", flush=True)

    # -- one-shot rows --------------------------------------------------------

    def _tick_stateless(self) -> None:
        """Drain up to ``n_slots`` (under brownout, ``budget_frac`` of
        them) pending one-shot requests, drop those
        whose deadline passed (``deadline_dropped``), and run one grouped
        dispatch per kind present: /infer rows through the engine's
        batched forward, /score rows through the scorer's. Members take a
        free row for the tick (overflow members ride the same dispatch
        rowless) and free it within the tick."""
        st = self._stats["stateless"]
        budget = self.n_slots
        if self._bo_budget_frac < 1.0:
            # Brownout: shrink the tick's one-shot dispatch as the mixed
            # budget shrinks (floored at 1); the rest stay queued.
            budget = max(1, int(budget * self._bo_budget_frac))
        pairs = []
        free = self._free_rows()
        while len(pairs) < budget:
            try:
                req = self._oneshot_ready.get_nowait()
            except queue.Empty:
                break
            if req.future.cancelled():
                self._bump("cancelled")
                continue
            if req.deadline is not None and req.deadline.expired():
                with self._stats_lock:
                    st["deadline_dropped"] += 1
                self._bump("deadline_cancelled")
                self._fail_request(req, DeadlineExceeded(
                    "deadline expired before one-shot dispatch"))
                continue
            # One-shot rows skip the prefill thread: their queue_wait is
            # submit to this drain.
            self._stage(req, "queue_wait", req.t_submit)
            req.t_admit = time.perf_counter()
            row = free.pop(0) if free else None
            if row is not None:
                self._row_req[row] = req
            with self._stats_lock:
                st["admitted"] += 1
                self._stats["admitted"] += 1
            pairs.append((row, req))
        if not pairs:
            return
        with self._stats_lock:
            st["ticks"] += 1
        for kind in ("infer", "score"):
            group = [(r, q) for r, q in pairs if q.oneshot[0] == kind]
            if group:
                self._dispatch_oneshot(kind, group, st)

    def _dispatch_oneshot(self, kind: str, group, st: dict) -> None:
        reqs = [q for _r, q in group]
        t0 = time.perf_counter()
        try:
            if kind == "infer":
                # Exactly the engine's batched forward, so a unified row
                # equals the batch lane's for the same co-batched inputs.
                shapes = [q.oneshot[2] for q in reqs]
                eng = self._infer_engine
                outs = eng.batch_collect(eng.batch_submit(
                    [q.oneshot[1] for q in reqs],
                    shapes=(shapes if any(s is not None for s in shapes)
                            else None)))
            else:
                outs = self._score_provider().score(
                    [q.oneshot[1] for q in reqs],
                    [q.oneshot[2] for q in reqs])
            if len(outs) != len(group):
                raise RuntimeError(
                    f"one-shot {kind} dispatch returned {len(outs)} "
                    f"results for {len(group)} rows")
        except Exception as exc:
            # A failed dispatch fails exactly its group: no shared device
            # state was written, so the scheduler keeps serving.
            with self._stats_lock:
                st["dispatches"] += 1
                st["failed"] += len(group)
            for r, q in group:
                if r is not None:
                    self._row_req[r] = None
                self._fail_request(q, exc)
            return
        elapsed_us = (time.perf_counter() - t0) * 1e6
        per_us = max(1, int(elapsed_us / max(1, len(group))))
        with self._stats_lock:
            st["dispatches"] += 1
            st[kind + "_rows"] += len(group)
            if len(group) >= self.n_slots:
                st["full_dispatches"] += 1
        for (r, req), out in zip(group, outs):
            if req.sink is not None:
                # The batch lane's spans: batch_form is the row's wait in
                # its tick before the dispatch, device_compute the group's
                # dispatch (submit to collect, the group size beside it).
                bf_us = max(0.0, (t0 - req.t_admit) * 1e6)
                req.sink.stage(
                    "batch_form", bf_us,
                    start_ts=time.time() - (elapsed_us + bf_us) / 1e6,
                    batch_size=len(group))
                req.sink.stage(
                    "device_compute", elapsed_us,
                    start_ts=time.time() - elapsed_us / 1e6,
                    batch_size=len(group))
            if r is not None:
                self._row_req[r] = None
            with self._stats_lock:
                st["completed"] += 1
                self._stats["completed"] += 1
            try:
                req.future.set_result((out, per_us))
            except InvalidStateError:
                pass  # cancelled by the client meanwhile

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
                if item is not None and item is not _WAKE:
                    self._discard_item(item)
                    self._fail_request(item.req, exc)
            while True:  # one-shot requests never dispatched
                try:
                    req = self._oneshot_ready.get_nowait()
                except queue.Empty:
                    break
                self._fail_request(req, exc)
            # Export commands, queued and waiting: answered, never
            # stranded.
            stranded = list(self._export_waiting)
            self._export_waiting = []
            while True:
                try:
                    stranded.append(self._migrate_q.get_nowait())
                except queue.Empty:
                    break
            for _tag, fut, _opts in stranded:
                if not fut.done():
                    fut.set_result({"ok": False,
                                    "reason": "scheduler stopped"})
            stop, self._profile_stop_req = self._profile_stop_req, None
            if self._profile_open:
                # A capture still open ends with the loop.
                self._profile_close()
            if stop is not None:
                stop.set_result(self._profile_result
                                or {"error": "profiler not running"})
            start, self._profile_start_req = self._profile_start_req, None
            if start is not None and start[1].set_running_or_notify_cancel():
                start[1].set_result({"error": "scheduler stopped"})

    def _loop_body(self) -> None:
        while self._running:
            now = time.monotonic()
            if self._flight_capacity:
                # The wall time since the last heartbeat is the previous
                # iteration's, idle waits included.
                self._flight_sample(now - self._last_tick)
            self._profile_tick()
            self._last_tick = now  # liveness heartbeat
            self._cancel_rows()
            if self._paged or self._slab:
                # Exports first: between ticks the row is quiescent, and
                # ahead of admissions no export sees a half-admitted row.
                self._serve_exports()
            if self._paged:
                # Live rows' block growth outranks new admissions.
                self._ensure_capacity_paged()
            free = self._free_rows()
            admitted_any = False
            while free:
                from_pending = bool(self._pending)
                if from_pending:
                    item = self._pending[0]
                else:
                    # Idle: block briefly for an admission, or for a
                    # one-shot submit's wake-up.
                    idle = not admitted_any and len(free) == self.n_slots
                    if idle:
                        # Flag the wait before looking at the one-shot
                        # queue: a submit that lands after the look sees
                        # the flag and sends a wake-up.
                        self._idle_wait = True
                        idle = self._oneshot_ready.empty()
                    try:
                        item = self._ready.get(timeout=0.02 if idle
                                               else 0.0)
                    except queue.Empty:
                        break
                    finally:
                        self._idle_wait = False
                if item is None:
                    return
                if item is _WAKE:
                    break  # one-shot work: dispatch it this tick
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
                except PoolExhausted as exc:
                    if req.migrate is not None:
                        # Imports never park: the replay resume needs
                        # nothing from this lane. Fail retryable and drop
                        # the radix pins.
                        if from_pending:
                            self._pending.popleft()
                        self._discard_item(item)
                        self._bump_migration("import_rejected")
                        self._fail_request(req, ImportRefused(
                            f"migration import refused: {exc}"))
                        continue
                    if self._slab:
                        # A slab request needs exactly one row and the
                        # pool holds at least one: park it (no pins to
                        # drop) until a completion frees a row.
                        if not from_pending:
                            self._pending.append(item)
                        if all(r is None for r in self._row_req):
                            time.sleep(0.005)
                        break
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
            if self._paged or self._slab:
                # Holds past their park window decode on (the colocated
                # fallback: the export never came).
                self._unpark_expired()
            if self._oneshot:
                # One-shot rows dispatch and free here, before the
                # generative step, so they never meet its bookkeeping.
                self._tick_stateless()
            live = [r for r in range(self.n_slots)
                    if self._row_req[r] is not None]
            if not live:
                continue
            if (self._paged or self._slab) and all(self._held[r]
                                                   for r in live):
                # Only parked rows: nothing to dispatch until the export
                # command (or the park bound) arrives.
                time.sleep(0.002)
                continue
            try:
                if self._spec:
                    self._tick_spec()
                elif self._mixed:
                    self._tick_mixed()
                else:
                    self._decode_chunk()
            except Exception as exc:
                self._recover(exc)
