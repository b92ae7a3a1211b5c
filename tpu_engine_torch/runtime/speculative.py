"""Continuous speculative decoding's drafters and acceptance rules
(counterpart of the continuous half of ``tpu_engine/runtime/speculative.py``).

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
lane's stream. The batch ``SpeculativeGenerator`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.models.transformer import (
    TransformerConfig,
    init_caches,
    transformer_decode_rows,
    transformer_prefill,
)
from tpu_engine_torch.utils import prng
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype

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
