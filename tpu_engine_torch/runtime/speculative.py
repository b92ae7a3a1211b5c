"""Speculative decoding (counterpart of
``tpu_engine/runtime/speculative.py``): the continuous scheduler's drafters
and the acceptance rules, and the batch lane's ``SpeculativeGenerator``.

- ``tagged_uniform`` and ``tagged_categorical`` draw per row under the key
  ``fold_in(fold_in(PRNGKey(seed), position), tag)``: the public
  ``jax.random.uniform`` (bit for bit) and ``jax.random.categorical``
  (its Gumbel noise to about an ulp, ``utils.prng``). The tags keep the
  accept and residual draws apart from the sampling draw at the same
  position.
- ``greedy_acceptance`` and ``rejection_acceptance``: the two acceptance
  rules over a (B, k) draft scored by (B, k + 1, V) target outputs. The
  continuous scheduler applies the same rules slot by slot inside its spec
  step (penalties and stops evolve from slot to slot there); keep the two
  in step.
- ``NGramDrafter`` (prompt lookup, host only) and ``ModelDrafter`` (a
  registry draft model proposing greedily from a bounded recent window:
  one padded prefill through the flash forward, then k - 1 decode steps)
  are the proposal sources of ``ContinuousGenerator(spec_k > 0)``;
  ``make_drafter`` picks one by the ``--spec-draft`` name.

Greedy rows (temperature 0) accept the longest draft prefix that equals
the target's own tokens and emit the target's tokens, so their stream is
the plain lane's for any draft. Rows with temperature > 0 accept a draft
token d with probability min(1, p(d) / q(d)) and on rejection draw from
norm(max(p - q, 0)): unbiased, deterministic per seed, not the plain
lane's stream.

- ``SpeculativeGenerator`` (``gen_scheduler="speculative"``): a batch of
  requests decoded to completion, a draft model proposing k tokens a
  round and the target verifying the window in one pass, with the same
  two rules; temperature sampling only.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.models.transformer import (
    TransformerConfig,
    init_caches,
    transformer_decode_rows,
    transformer_decode_window,
    transformer_prefill,
)
from tpu_engine_torch.runtime.generator import (
    _sample,
    left_pad_batch,
    pick_bucket,
)
from tpu_engine_torch.utils import prng
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype
from tpu_engine_torch.utils.sampling import (
    expand_sampling_params,
    expand_stopping_params,
    truncate_at_stops,
)

# Key-derivation tags: the accept and residual draws stay independent of
# the sampling draw at the same logical position.
_TAG_ACCEPT = 101
_TAG_RESID = 102


def _tagged_key(seeds, positions, tag: int, device=None) -> torch.Tensor:
    seeds = torch.as_tensor(seeds, device=device)
    positions = torch.as_tensor(positions, device=seeds.device)
    key = prng.fold_in(prng.prng_key(seeds), positions)
    return prng.fold_in(key, torch.full_like(positions, tag,
                                             dtype=torch.int64))


def tagged_uniform(seeds, positions, tag: int, n: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """Per-row ``jax.random.uniform(key, shape)`` in [0, 1) under the key
    of (seed, logical position, tag): (B,) for shape (), or (B, n) for
    shape (n,)."""
    key = _tagged_key(seeds, positions, tag, device)
    u = prng.uniform01(key, 1 if n is None else int(n))
    return u[..., 0] if n is None else u


def tagged_categorical(seeds, positions, tag: int,
                       log_probs: torch.Tensor) -> torch.Tensor:
    """Per-row ``jax.random.categorical`` draw from log_probs (B, V) under
    the key of (seed, logical position, tag). Returns (B,) int64."""
    key = _tagged_key(seeds, positions, tag, log_probs.device)
    return prng.categorical(key, log_probs)


def greedy_acceptance(d: torch.Tensor, g: torch.Tensor):
    """Greedy (temperature 0) acceptance: the longest draft prefix equal
    to the target's argmax. ``d`` (B, k) proposals; ``g`` (B, k + 1) the
    target's tokens (g[:, i] follows window slot i). Returns (n_acc (B,),
    emitted (B, k + 1)): the target's own tokens, equal to the draft on
    accepted slots."""
    k = d.shape[1]
    cum = torch.cumprod((d == g[:, :k]).to(torch.int32), dim=1)
    return cum.sum(dim=1), g


def rejection_acceptance(d: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                         seeds, logical):
    """Speculative rejection sampling: accept d_i with probability
    min(1, p_i(d_i) / q_i(d_i)); at the first rejection draw from
    norm(max(p - q, 0)); when all k accept, draw the bonus token from p_k.
    ``d`` (B, k) proposals; ``p`` (B, k + 1, V) target and ``q`` (B, k, V)
    draft probabilities; ``seeds`` and ``logical`` (B,) key the draws.
    Returns (n_acc (B,), emitted (B, k + 1))."""
    bb, k = d.shape
    v = p.shape[-1]
    dl = d.long()
    slot = torch.arange(k + 1, device=d.device)[None, :]
    p_d = torch.gather(p[:, :k], 2, dl[..., None])[..., 0]
    q_d = torch.gather(q, 2, dl[..., None])[..., 0]
    u = tagged_uniform(seeds, logical, _TAG_ACCEPT, k, device=d.device)
    ratio = p_d / torch.clamp(q_d, min=1e-30)
    acc = u < torch.clamp(ratio, max=1.0)
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    # Residual (or bonus) distribution at the first rejected slot: p_k
    # when all k accepted, q padded with zeros there.
    q_pad = torch.cat([q, torch.zeros((bb, 1, v), dtype=q.dtype,
                                      device=q.device)], dim=1)
    rows = torch.arange(bb, device=d.device)
    p_j, q_j = p[rows, n_acc.long()], q_pad[rows, n_acc.long()]
    resid = torch.clamp(p_j - q_j, min=0.0)
    tot = resid.sum(dim=-1, keepdim=True)
    dist = torch.where(tot > 0, resid, p_j)
    corr = tagged_categorical(seeds, logical, _TAG_RESID,
                              torch.log(torch.clamp(dist, min=1e-30)))
    d_ext = torch.cat([dl, dl[:, -1:]], dim=1)
    emitted = torch.where(slot == n_acc[:, None].long(), corr[:, None],
                          d_ext)
    return n_acc, emitted


class NGramDrafter:
    """Host-side n-gram (prompt-lookup) drafter, ``--spec-draft ngram``:
    propose the tokens that followed the most recent earlier occurrence of
    the context's longest matching tail n-gram. No second model and no
    device work; deterministic. An empty or match-free history proposes
    nothing, which costs the scheduler a q_len-1 row."""

    name = "ngram"
    dispatches = 0  # host-side: never touches the device

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_scan: int = 1024):
        if not 1 <= int(min_ngram) <= int(max_ngram):
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        # The backward scan runs per drafted row per tick on the decode
        # thread: bounded, so a match-free long context costs O(max_scan).
        self.max_scan = int(max_scan)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` proposed continuation tokens (possibly none)."""
        ctx = list(context)[-self.max_scan:]
        if k <= 0 or len(ctx) < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, len(ctx) - 1),
                       self.min_ngram - 1, -1):
            tail = ctx[-n:]
            # Most recent EARLIER occurrence whose continuation (which may
            # overlap the tail) fills the window; shorter continuations
            # keep the longest seen as the fallback.
            best: List[int] = []
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    cont = ctx[i + n:i + n + k]
                    if len(cont) >= k:
                        return [int(t) for t in cont]
                    if len(cont) > len(best):
                        best = cont
            if best:
                return [int(t) for t in best]
        return []


class ModelDrafter:
    """A registry draft model proposing greedily from the last
    ``context_window`` tokens, ``--spec-draft model``. Stateless across
    ticks: each ``propose`` is one padded prefill of the window (through
    the flash forward, the left padding masked) and k - 1 greedy decode
    steps on a cache of its own, with one host copy of the proposals, so
    nothing is rewound on rejection. Counted in ``dispatches``, apart from
    the scheduler's verify dispatches. Without ``params`` the draft's
    weights are its own seeded random init (seed 1)."""

    name = "model"

    def __init__(self, spec: Union[str, ModelSpec], params=None, k: int = 4,
                 dtype="bfloat16", context_window: int = 64, device=None):
        if isinstance(spec, str):
            spec = create_model(spec)
        if (not isinstance(spec.config, TransformerConfig)
                or not spec.config.causal):
            raise ValueError(
                f"draft model '{spec.name}' is not a decoder transformer")
        if k < 1:
            raise ValueError(f"speculation depth k must be >= 1, got {k}")
        self.spec = spec
        self.cfg: TransformerConfig = spec.config
        self.k = int(k)
        self._dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self._ctx = int(min(context_window, self.cfg.max_seq - self.k - 1))
        if self._ctx < 1:
            # A non-positive window would slice context[-0:] (the whole
            # history) and feed positions past the draft's table.
            raise ValueError(
                f"draft model '{spec.name}' max_seq {self.cfg.max_seq} "
                f"cannot hold a context window for k={self.k} "
                f"(needs max_seq >= k + 2)")
        # propose() reads only context[-max_scan:], so the scheduler slices
        # a row's history to that before concatenating.
        self.max_scan = self._ctx
        self.params = (params if params is not None else spec.init(
            1, device=self.device, dtype=self._dtype))
        self.dispatches = 0

    def bucket(self, n: int) -> int:
        """The prefill bucket of an n-token window: 16, doubling, capped
        so that the decode steps (positions pb .. pb + k - 2) stay inside
        the draft's max_seq (the cap always still holds the window)."""
        pb = 16
        while pb < n:
            pb *= 2
        return min(pb, max(16, self._ctx), self.cfg.max_seq - self.k)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        if k <= 0 or not len(context):
            return []
        ctx = [int(t) for t in list(context)[-self._ctx:]]
        pb = self.bucket(len(ctx))
        ctx = ctx[-pb:]
        L = len(ctx)
        tokens = np.zeros((1, pb), np.int32)
        attn = np.zeros((1, pb), np.int32)
        pos_ids = np.zeros((1, pb), np.int32)
        tokens[0, pb - L:] = ctx
        attn[0, pb - L:] = 1
        pos_ids[0, pb - L:] = np.arange(L)
        n = min(int(k), self.k)
        dev, cfg, dtype = self.device, self.cfg, self._dtype
        caches = init_caches(cfg, 1, pb + self.k, dtype, dev)
        logits, caches = transformer_prefill(
            self.params, torch.from_numpy(tokens).to(dev), caches, cfg,
            dtype=dtype, attn_mask=torch.from_numpy(attn).to(dev),
            pos_ids=torch.from_numpy(pos_ids).to(dev))
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        start = torch.tensor([pb - L], dtype=torch.int32, device=dev)
        for i in range(n - 1):
            lg, caches = transformer_decode_rows(
                self.params, tok, caches,
                torch.tensor([pb + i], dtype=torch.int32, device=dev), cfg,
                dtype=dtype, start_vec=start)
            tok = torch.argmax(lg, dim=-1)
            out.append(tok)
        self.dispatches += 1
        return [int(t) for t in torch.cat(out).cpu().tolist()]


def make_drafter(kind: str, k: int, *, draft_model=None, draft_params=None,
                 dtype="bfloat16", device=None):
    """The drafter of ``--spec-draft`` ``kind`` for depth ``k``."""
    if kind == "ngram":
        return NGramDrafter()
    if kind == "model":
        if draft_model is None:
            raise ValueError("spec_draft='model' needs a draft model "
                             "(spec_draft_model / --gen-draft-model)")
        return ModelDrafter(draft_model, params=draft_params, k=k,
                            dtype=dtype, device=device)
    raise ValueError(f"unknown drafter kind {kind!r} "
                     "(expected 'ngram' or 'model')")


class SpeculativeGenerator:
    """Batch-to-completion generation with draft-model speculation
    (counterpart of ``tpu_engine.runtime.speculative.SpeculativeGenerator``;
    ``gen_scheduler="speculative"``). ``generate`` is the Generator's
    without top_p, top_k, min_p and the repetition penalty (temperature
    sampling only). ``draft`` shares the target's vocabulary; without
    ``draft_params`` its weights are its own seeded init (``rng_seed``
    + 1). Each round the draft proposes ``k`` tokens (a catch-up window
    over the last W = k + 1 stream tokens, then k - 1 single steps) and
    the target verifies all W positions in one ``transformer_decode_window``
    pass; a row advances 1 to k + 1 tokens a round.

    A group is left-padded with ``min_len=1`` (an idle bucket row keeps
    one valid column and starts done) and prefilled by the target and by
    the draft (the flash kernel on the card). Greedy rows accept the
    longest draft prefix equal to the target's argmax (their stream is
    plain greedy decoding's, for any draft); sampled rows accept by
    rejection sampling (``rejection_acceptance``), which runs only when a
    row samples. ``max_new_tokens`` is clamped to max_seq - the prompt
    bucket - W, and a row is done once another round could pass max_seq.
    The host reads the done flags once a round; the tokens stay on the
    card until the end. ``last_stats`` holds the last call's (rounds,
    tokens, mean tokens per live round), ``stats()`` the lifetime ``spec``
    block (``lane: "batch"``)."""

    def __init__(self, target: Union[str, ModelSpec],
                 draft: Union[str, ModelSpec], params=None,
                 draft_params=None, k: int = 4, rng_seed: int = 0,
                 dtype: str = "bfloat16",
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 prompt_buckets: Optional[Sequence[int]] = None,
                 max_seq: Optional[int] = None, device=None):
        if isinstance(target, str):
            target = create_model(target)
        if isinstance(draft, str):
            draft = create_model(draft)
        for spec, role in ((target, "target"), (draft, "draft")):
            if (not isinstance(spec.config, TransformerConfig)
                    or not spec.config.causal):
                raise ValueError(
                    f"{role} model '{spec.name}' is not a decoder transformer")
        if target.config.vocab != draft.config.vocab:
            raise ValueError(
                f"vocab mismatch: target {target.config.vocab} vs "
                f"draft {draft.config.vocab}")
        if k < 1:
            raise ValueError(f"speculation depth k must be >= 1, got {k}")
        self.spec = target
        self.draft_spec = draft
        self.tcfg: TransformerConfig = target.config
        self.dcfg: TransformerConfig = draft.config
        self.k = int(k)
        self._dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.max_seq = min(max_seq or self.tcfg.max_seq, self.tcfg.max_seq,
                           self.dcfg.max_seq)
        self._batch_buckets = tuple(sorted(set(int(b)
                                               for b in batch_buckets)))
        w = self.k + 1
        if prompt_buckets is None:
            b, prompt_buckets = max(16, w), []
            while b < self.max_seq:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(self.max_seq)
        self._prompt_buckets = tuple(sorted(
            {max(min(int(p), self.max_seq), w) for p in prompt_buckets}))
        self.params = (params if params is not None else target.init(
            rng_seed, device=self.device, dtype=dtype))
        self.draft_params = (draft_params if draft_params is not None
                             else draft.init(rng_seed + 1,
                                             device=self.device,
                                             dtype=dtype))
        # The (bb, pb, cap, stochastic) shapes run so far.
        self._shapes: set = set()
        self._cache_pool: dict = {}
        self._lock = threading.Lock()
        self.last_stats: dict = {}
        # Lifetime counters behind the spec block.
        self._cum = {"verify_passes": 0, "emitted": 0, "live_rounds": 0}

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature=0.0,
                 eos_id: int = -1, seed=0, top_p=1.0, top_k=0,
                 repetition_penalty=1.0, stop_tokens=None,
                 min_p=0.0) -> List[List[int]]:
        n = len(prompts)
        if n == 0:
            return []
        temps, seeds, top_ps, top_ks, min_ps = expand_sampling_params(
            n, temperature, seed, top_p, top_k, min_p)
        pens, stops = expand_stopping_params(n, repetition_penalty,
                                             stop_tokens)
        seeds = [s & 0x7FFFFFFF for s in seeds]
        if any(p < 1.0 for p in top_ps) or any(t > 0 for t in top_ks) \
                or any(p != 1.0 for p in pens) or any(m > 0 for m in min_ps):
            raise ValueError(
                "speculative decoding supports temperature sampling only; "
                "route top_p/top_k/min_p/repetition_penalty requests to "
                "the plain schedulers")
        max_bb = self._batch_buckets[-1]
        if n > max_bb:
            out: List[List[int]] = []
            for i in range(0, n, max_bb):
                out.extend(self.generate(
                    prompts[i:i + max_bb], max_new_tokens,
                    temperature=temps[i:i + max_bb], eos_id=eos_id,
                    seed=seeds[i:i + max_bb],
                    stop_tokens=stops[i:i + max_bb]))
            return out
        bb = pick_bucket(self._batch_buckets, n)
        w = self.k + 1
        longest = max(len(p) for p in prompts)
        pb = pick_bucket(self._prompt_buckets, max(longest, 1))
        max_new = max(1, min(int(max_new_tokens), self.max_seq - pb - w))
        cap = 1 << (max_new + w - 1).bit_length()
        temps_arr = np.zeros((bb,), np.float32)
        seeds_arr = np.zeros((bb,), np.int64)
        temps_arr[:n] = temps
        seeds_arr[:n] = seeds
        stochastic = any(t > 0 for t in temps)
        with torch.inference_mode():
            out_buf, n_out, stats = self._run(
                prompts, n, bb, pb, cap, max_new, int(eos_id), seeds_arr,
                temps_arr, stochastic)
        self._shapes.add((bb, pb, cap, stochastic))
        rounds, emitted, live = (int(x) for x in stats)
        self._cum["verify_passes"] += rounds
        self._cum["emitted"] += emitted
        self._cum["live_rounds"] += live
        self.last_stats = {
            "rounds": rounds,
            "tokens_in_rounds": emitted,
            # Stream advance per verify pass over the rows live in each
            # round (1.0: no speculation win, k + 1: a perfect draft).
            "mean_tokens_per_round": (round(emitted / live, 3)
                                      if live else None),
            "k": self.k,
        }
        # Stop tokens cut on the host (the loop knows only EOS).
        return [truncate_at_stops(
                    out_buf[r, :min(int(n_out[r]), max_new)].tolist(),
                    eos_id, stops[r])
                for r in range(n)]

    def _caches(self, bb: int) -> tuple:
        """The batch bucket's target and draft caches, made once and
        reused (stale columns are rewritten before any read)."""
        with self._lock:
            pooled = self._cache_pool.get(bb)
            if pooled is None:
                pooled = (init_caches(self.tcfg, bb, self.max_seq,
                                      self._dtype, self.device),
                          init_caches(self.dcfg, bb, self.max_seq,
                                      self._dtype, self.device))
                self._cache_pool[bb] = pooled
        return pooled

    def _run(self, prompts, n: int, bb: int, pb: int, cap: int,
             max_new: int, eos_id: int, seeds, temps, stochastic: bool):
        """The whole speculative loop of one group: (out_buf, n_out,
        (rounds, emitted, live row-rounds)) on the host."""
        k, w, dev, dtype = self.k, self.k + 1, self.device, self._dtype
        tcfg, dcfg = self.tcfg, self.dcfg
        tokens, attn_mask, pos_ids, start = left_pad_batch(
            prompts, bb, pb, min_len=1)
        tok_dev = torch.from_numpy(tokens).to(dev)
        mask_dev = torch.from_numpy(attn_mask).to(dev)
        pid_dev = torch.from_numpy(pos_ids).to(dev)
        start_dev = torch.from_numpy(start).to(dev)
        alive = torch.arange(bb, device=dev) < n
        tcaches, dcaches = self._caches(bb)
        tlogits, tcaches = transformer_prefill(
            self.params, tok_dev, tcaches, tcfg, dtype=dtype,
            attn_mask=mask_dev, pos_ids=pid_dev)
        _, dcaches = transformer_prefill(
            self.draft_params, tok_dev, dcaches, dcfg, dtype=dtype,
            attn_mask=mask_dev, pos_ids=pid_dev)
        rows = torch.arange(bb, device=dev)
        slot = torch.arange(w, device=dev)[None, :]
        use_s = torch.from_numpy(temps > 0).to(dev)
        t_safe = torch.from_numpy(np.maximum(temps, 1e-6)).to(dev)

        def sample(logits, positions):
            return _sample(logits, seeds, positions, temps)

        first = sample(tlogits, pb - start)
        out_buf = torch.zeros((bb, cap + 1), dtype=torch.int64, device=dev)
        out_buf[:, 0] = first
        n_out = torch.ones((bb,), dtype=torch.int64, device=dev)
        # Idle bucket rows start done, so they never hold the loop.
        done = (alive.logical_not() | (first == eos_id) | (max_new <= 1)
                | (pb + k + 1 > self.max_seq))
        pos = torch.full((bb,), pb, dtype=torch.int64, device=dev)
        # tail: the last W stream tokens of each row (columns pos-W+1..pos).
        tail = torch.cat([tok_dev[:, pb - (w - 1):].long(), first[:, None]],
                         dim=1)
        stats = torch.zeros((3,), dtype=torch.int64, device=dev)
        while bool(done.logical_not().any()):
            logical = pos - start_dev          # the pending token's
            # The draft: a catch-up window over the tail (columns cached
            # already are rewritten with the same values), whose last slot
            # gives the first proposal, then k - 1 single steps.
            dwin, dcaches = transformer_decode_window(
                self.draft_params, tail, dcaches, pos - (w - 1), dcfg,
                dtype=dtype, start_vec=start_dev)
            dl = [dwin[:, -1]]
            tok_i = sample(dl[0], logical + 1)
            props = [tok_i]
            for i in range(1, k):
                lg, dcaches = transformer_decode_rows(
                    self.draft_params, tok_i, dcaches, pos + i, dcfg,
                    dtype=dtype, start_vec=start_dev)
                dl.append(lg)
                tok_i = sample(lg, logical + 1 + i)
                props.append(tok_i)
            d = torch.stack(props, dim=1)                   # (B, k)
            # The target verifies the whole window in one pass. A row done
            # near max_seq still runs it, and its writes past the cache are
            # dropped (its hidden states still reach an MoE's capacity).
            wtokens = torch.cat([tail[:, -1:], d], dim=1)
            tl, tcaches = transformer_decode_window(
                self.params, wtokens, tcaches, pos, tcfg, dtype=dtype,
                start_vec=start_dev, drop_past=True)        # (B, W, V)
            g = torch.argmax(tl, dim=-1)
            n_acc, emitted = greedy_acceptance(d, g)
            if stochastic:
                p = torch.softmax(tl / t_safe[:, None, None], dim=-1)
                q = torch.softmax(torch.stack(dl, dim=1)
                                  / t_safe[:, None, None], dim=-1)
                n_acc_s, e_s = rejection_acceptance(d, p, q, seeds, logical)
                n_acc = torch.where(use_s, n_acc_s, n_acc)
                emitted = torch.where(use_s[:, None], e_s, emitted)
            n_emit = n_acc + 1
            # The emitted tokens into out_buf (column cap takes the rest).
            idx = n_out[:, None] + slot
            wmask = ((slot < n_emit[:, None]) & done.logical_not()[:, None]
                     & (idx < cap))
            out_buf[rows[:, None].expand(bb, w), torch.where(wmask, idx, cap)] \
                = torch.where(wmask, emitted, 0)
            eos_hit = (eos_id >= 0) & ((emitted == eos_id) & wmask).any(1)
            adv = torch.where(done, 0, n_emit)
            n_out = torch.clamp(n_out + adv, max=cap)
            pos = pos + adv
            shifted = torch.take_along_dim(torch.cat([tail, emitted], dim=1),
                                           adv[:, None] + slot, dim=1)
            tail = torch.where(done[:, None], tail, shifted)
            live = done.logical_not().sum()        # rows that ran this round
            done = (done | eos_hit | (n_out >= max_new)
                    | (pos + k + 1 > self.max_seq))
            stats += torch.stack([torch.ones_like(live), adv.sum(), live])
        return (out_buf[:, :cap].cpu().numpy(), n_out.cpu().numpy(),
                stats.cpu().numpy())

    def stats(self) -> dict:
        """The JAX generator's stats, with the lifetime acceptance in the
        continuous lane's ``spec`` schema (``lane: "batch"``): a live row
        advances 1 + accepted tokens a round, so accepted = emitted - live
        rounds, and it proposes k tokens every round."""
        lr = self._cum["live_rounds"]
        passes, emitted = self._cum["verify_passes"], self._cum["emitted"]
        spec_block = {
            "k": self.k,
            "draft": self.draft_spec.name,
            "lane": "batch",
            "dispatches": passes,
            "proposed_tokens": self.k * lr,
            "accepted_tokens": max(0, emitted - lr),
            "emitted_tokens": emitted,
            "accept_ratio": (round((emitted - lr) / (self.k * lr), 4)
                             if lr else None),
            "tokens_per_dispatch": (round(emitted / passes, 3)
                                    if passes else None),
            "tokens_per_row_dispatch": (round(emitted / lr, 3)
                                        if lr else None),
        }
        return {
            "target": self.spec.name,
            "draft": self.draft_spec.name,
            "k": self.k,
            "max_seq": self.max_seq,
            "batch_buckets": list(self._batch_buckets),
            "prompt_buckets": list(self._prompt_buckets),
            "compiled": sorted(self._shapes),
            "spec": spec_block,
            **self.last_stats,
        }
