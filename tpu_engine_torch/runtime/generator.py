"""The batch Generator (counterpart of ``tpu_engine/runtime/generator.py``):
left-padded batch-to-completion generation (one decode loop serves JAX's
chunked and fused forms), beam search and teacher-forced scoring, and the
decode helpers the continuous scheduler shares with it: bucketing, left-
and right-padding, token counts, the repetition penalty and per-row
sampling. ``Scorer`` is
another name of ``Generator`` (its ``score``), kept for the lanes that
score without generating through it. JAX's ``start_host_copies`` (a
link-latency helper of the JAX runtime) has nothing to do in eager
PyTorch and is not carried over.

Sampling. Greedy rows (temperature 0) take the argmax and are exact.
Sampled rows filter in the JAX order — temperature, then top_p and top_k
(tokens tied at the threshold are kept), then min_p — and draw
``jax.random.categorical``'s Gumbel argmax with noise from the key
``fold_in(PRNGKey(seed), position)`` (``utils.prng``, the threefry bits
of jax 0.9.0): a row's draw depends on its own seed and the logical
position of the token only, so a seeded stream is deterministic,
independent of which rows share its batch, and the JAX package's token
for token.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    init_caches,
    transformer_apply,
    transformer_decode_step,
    transformer_prefill,
)
from tpu_engine_torch.utils import prng
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype
from tpu_engine_torch.utils.sampling import (
    expand_sampling_params,
    expand_stopping_params,
    stop_matrix,
    truncate_at_stops,
)


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    """Smallest bucket >= n (largest bucket when n exceeds them all)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def right_pad_prompt(prompt: Sequence[int], pb: int) -> np.ndarray:
    """(1, pb) RIGHT-padded token row: token i sits at column i, so a
    shared prefix lands at identical logical columns whatever bucket each
    prompt picked. Over-long prompts truncate from the left."""
    tokens = np.zeros((1, pb), np.int32)
    p = list(prompt)[-pb:]
    if p:
        tokens[0, :len(p)] = np.asarray(p, np.int32)
    return tokens


def token_counts(rows: "Sequence[Sequence[int]]", n_rows: int,
                 vocab: int) -> np.ndarray:
    """(n_rows, vocab) int32 occurrence counts of each row's tokens."""
    out = np.zeros((n_rows, vocab), np.int32)
    for r, toks in enumerate(rows):
        if len(toks):
            ids = np.asarray(toks, np.int64)
            ids = ids[(ids >= 0) & (ids < vocab)]
            np.add.at(out[r], ids, 1)
    return out


def apply_repetition_penalty(logits: torch.Tensor, counts: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """HF-style repetition penalty. logits (B, V) f32; counts (B, V) int
    occurrences of each token in the row's context; penalty (B,), 1.0 =
    off. Seen tokens' positive logits divide by the penalty, negative ones
    multiply."""
    seen = counts > 0
    p = torch.clamp(penalty, min=1e-6)[:, None]
    return torch.where(seen, torch.where(logits > 0, logits / p,
                                         logits * p), logits)


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, top_k: torch.Tensor,
                  min_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits with the top_p/top_k and min_p filters
    applied (filtered tokens at -inf), in the JAX ``_sample`` order."""
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    lg = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
    k = torch.clamp((cum < top_p[:, None]).sum(-1) + 1, max=lg.shape[-1])
    k = torch.where(top_k > 0, torch.minimum(k, top_k.long()), k)
    thresh = sorted_lg.gather(-1, (k - 1)[:, None])
    lg = torch.where(lg >= thresh, lg, neg_inf)
    min_thresh = torch.where(
        min_p > 0,
        lg.max(-1).values + torch.log(torch.clamp(min_p, min=1e-30)),
        neg_inf)
    return torch.where(lg >= min_thresh[:, None], lg, neg_inf)


def _sample(logits: torch.Tensor, seeds, positions, temperature,
            top_p=None, top_k=None, min_p=None) -> torch.Tensor:
    """Per-row sampling: logits (B, V) f32; ``seeds`` and ``positions``
    (B,) integers, as host arrays or as tensors (the decode chunk keeps
    its positions on the device); the filters (B,) host arrays. Greedy
    where temperature == 0, else a categorical draw from the filtered
    distribution by the Gumbel argmax under the row's
    ``fold_in(PRNGKey(seed), position)`` key. Returns (B,) int64 on the
    logits' device."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temperature, np.float32)
    sampled_rows = np.nonzero(temps > 0)[0]
    if sampled_rows.size == 0:
        return greedy
    b, v = logits.shape
    dev = logits.device
    ones = np.ones((b,), np.float32)
    top_p = ones if top_p is None else np.asarray(top_p, np.float32)
    top_k = np.zeros((b,), np.int64) if top_k is None \
        else np.asarray(top_k, np.int64)
    min_p = np.zeros((b,), np.float32) if min_p is None \
        else np.asarray(min_p, np.float32)
    idx = torch.as_tensor(sampled_rows, device=dev)
    sel = sampled_rows
    lg = filter_logits(
        logits[idx], torch.as_tensor(temps[sel], device=dev),
        torch.as_tensor(top_p[sel], device=dev),
        torch.as_tensor(top_k[sel], device=dev),
        torch.as_tensor(min_p[sel], device=dev))
    key = prng.fold_in(prng.prng_key(torch.as_tensor(seeds, device=dev)[idx]),
                       torch.as_tensor(positions, device=dev)[idx])
    drawn = torch.argmax(lg + prng.gumbel(key, v), dim=-1)
    out = greedy.clone()
    out[idx] = drawn
    return out




def power_of_two_buckets(max_seq: int) -> tuple:
    """16, 32, ... below max_seq, then max_seq: the JAX generator's prompt
    buckets."""
    b, out = 16, []
    while b < max_seq:
        out.append(b)
        b *= 2
    return tuple(out) + (max_seq,)


def left_pad_batch(prompts: Sequence[Sequence[int]], bb: int, pb: int,
                   min_len: int = 0):
    """Left-pad prompts into a (bb, pb) bucket: every row ends at column
    pb - 1, so decode advances with one position for the whole batch.
    Returns (tokens, attn_mask, pos_ids, start) as numpy arrays. ``min_len``
    forces at least that many valid trailing columns per row (the
    speculative loop's idle bucket rows keep one, so their attention is
    never fully masked); 0 leaves an empty row fully padded (start ==
    pb). Over-long prompts truncate from the left."""
    tokens = np.zeros((bb, pb), np.int32)
    attn_mask = np.zeros((bb, pb), np.int32)
    pos_ids = np.zeros((bb, pb), np.int32)
    start = np.full((bb,), pb - min_len, np.int32)
    if min_len:
        attn_mask[:, pb - min_len:] = 1
        pos_ids[:, pb - min_len:] = np.arange(min_len)
    for r, p in enumerate(prompts):
        p = list(p)[-pb:]
        L = max(len(p), min_len)
        tokens[r, pb - len(p):] = np.asarray(p, np.int32)
        attn_mask[r, pb - L:] = 1
        pos_ids[r, pb - L:] = np.arange(L)
        start[r] = pb - L
    return tokens, attn_mask, pos_ids, start


def top_k_lowest_index_first(x: torch.Tensor, k: int):
    """The k largest values of a 1-D tensor and their indices, equal
    values in ascending index order: ``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise. A stable descending sort keeps equal
    elements in their original (ascending index) order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


class _Rows:
    """A left-padded batch's per-row decode state that stays fixed for
    the whole loop: the sampling parameters as host arrays (``_sample``
    reads them there), ``start`` on the host and on the device, and with
    ``controls`` the penalties and the stop matrix on the device."""

    def __init__(self, gen: "Generator", n: int, bb: int, pb: int, start,
                 eos_id: int, temps, seeds, top_ps, top_ks, pens, stops,
                 min_ps):
        dev = gen.device
        self.bb, self.pb, self.eos = bb, pb, int(eos_id)
        self.start = start
        self.start_dev = torch.from_numpy(start).to(dev)
        self.temps = np.zeros((bb,), np.float32)
        self.seeds = np.zeros((bb,), np.int64)
        self.top_p = np.ones((bb,), np.float32)
        self.top_k = np.zeros((bb,), np.int64)
        self.min_p = np.zeros((bb,), np.float32)
        self.temps[:n] = temps
        # The continuous scheduler's normalization: seeds >= 2**31 sample
        # alike under every gen_scheduler.
        self.seeds[:n] = [int(s) & 0x7FFFFFFF for s in seeds]
        self.top_p[:n] = top_ps
        self.top_k[:n] = top_ks
        self.min_p[:n] = min_ps
        self.controls = any(p != 1.0 for p in pens) or any(stops)
        self.rows = torch.arange(bb, device=dev)
        if self.controls:
            pens_arr = np.ones((bb,), np.float32)
            pens_arr[:n] = pens
            self.pens = torch.from_numpy(pens_arr).to(dev)
            self.stops = torch.from_numpy(stop_matrix(stops, bb)).to(dev)

    def sample(self, logits: torch.Tensor, positions) -> torch.Tensor:
        return _sample(logits, self.seeds, positions, self.temps,
                       self.top_p, self.top_k, self.min_p)

    def stopped(self, tok: torch.Tensor) -> torch.Tensor:
        """(B,) bool: the row's token is EOS, or one of its stop tokens."""
        hit = tok == self.eos
        if self.controls:
            hit = hit | (tok[:, None] == self.stops).any(dim=1)
        return hit

    def count(self, counts: torch.Tensor, tok: torch.Tensor,
              add: torch.Tensor) -> None:
        """counts[r, tok[r]] += add[r], in place (a row adding 0 may carry
        any token, EOS -1 included)."""
        counts.index_put_((self.rows, torch.where(add > 0, tok, 0)),
                          add.to(counts.dtype), accumulate=True)


def _decode_step_sampled(params, cfg: TransformerConfig, dtype, rows: _Rows,
                         tok, caches: KVCache, pos: int, done, counts):
    """One decode step, its sampling and its EOS/stop/counts bookkeeping:
    the per-step definition of the decode loop (JAX's
    ``_decode_step_sampled``, which its chunked and fused loops share).
    ``counts`` is None without ``rows.controls``."""
    logits, caches = transformer_decode_step(
        params, tok, caches, pos, cfg, dtype=dtype, start=rows.start_dev)
    if rows.controls:
        logits = apply_repetition_penalty(logits, counts, rows.pens)
    # The token sampled here sits at logical position pos + 1 - start of
    # its own row: the draw is batch- and bucket-independent.
    nxt = rows.sample(logits, pos + 1 - rows.start)
    nxt = torch.where(done, rows.eos, nxt)
    if rows.controls:
        rows.count(counts, nxt, (~done).to(torch.int32))
    done = done | rows.stopped(nxt)
    return caches, nxt, done, counts


class Generator:
    """Batch-to-completion generation of a decoder LM (counterpart of
    ``tpu_engine.runtime.generator.Generator``): ``gen_scheduler="batch"``.

    A call's prompts run in groups of the largest batch bucket; each group
    is left-padded to a (batch bucket, prompt bucket) pair
    (``left_pad_batch``), prefilled in one ``transformer_prefill`` (the
    flash kernel on the card; bucket rows are fully masked and give 0) on
    a dense cache pooled per batch bucket and reused across calls (stale
    contents are never read), and decoded with one position for every
    row. ``max_new_tokens`` is clamped to max_seq - the prompt bucket, so
    a group's longest prompt sets the budget of all its rows.

    - Decode: one loop serves JAX's chunked and fused forms (one stream
      by JAX's contract). The tokens stay on the card until the end
      (``out_buf``, ``n_out``, ``done`` and the counts are device tensors,
      as in JAX's fused loop); the host reads only the all-done flag, once
      per ``step_chunk`` steps, to stop early, as often as JAX's chunked
      loop copies its tokens. Steps after every row is done write nothing;
      no step runs at pos >= max_seq.
    - ``beam_search``: one prompt's beams on the batch axis (the prompt's
      cache repeated to the beam width, rows gathered by each step's
      source beams), candidates chosen in ``jax.lax.top_k``'s order.
    - ``score``: teacher-forced log-probabilities in one
      ``transformer_apply`` (the flash kernel), right-padded to the
      sequence buckets.

    Sampling is ``_sample``'s (greedy rows exact, seeded rows JAX's
    threefry draws at their own logical positions)."""

    def __init__(self, model: Union[str, ModelSpec], params=None,
                 rng_seed: int = 0, dtype: str = "bfloat16",
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 prompt_buckets: Optional[Sequence[int]] = None,
                 step_chunk: int = 16, max_seq: Optional[int] = None,
                 device=None, model_kwargs: Optional[dict] = None):
        if isinstance(model, str):
            model = create_model(model, **(model_kwargs or {}))
        if not isinstance(model.config, TransformerConfig):
            raise ValueError(f"model '{model.name}' is not a transformer "
                             "(no TransformerConfig); generation unsupported")
        if not model.config.causal:
            raise ValueError(f"model '{model.name}' is an encoder "
                             "(causal=False); autoregressive generation "
                             "requires a decoder LM")
        if tuple(model.output_shape) != (model.config.vocab,):
            raise ValueError(f"model '{model.name}' head is not an LM head "
                             f"over the vocab (output_shape="
                             f"{model.output_shape})")
        self.spec = model
        self.cfg: TransformerConfig = model.config
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.max_seq = min(max_seq or self.cfg.max_seq, self.cfg.max_seq)
        self._batch_buckets = tuple(sorted(
            {max(1, int(b)) for b in batch_buckets}))
        if prompt_buckets is None:
            # Up to the model's full context: a long prompt is never
            # truncated below what the model can serve.
            prompt_buckets = power_of_two_buckets(self.max_seq)
        self._prompt_buckets = tuple(sorted(
            {min(int(p), self.max_seq) for p in prompt_buckets}))
        self._step_chunk = int(step_chunk)
        self.params = (params if params is not None else model.init(
            rng_seed, device=self.device, dtype=dtype))
        # The shapes run so far (JAX lists its compiled executables).
        self._prefill_shapes: set = set()
        self._decode_shapes: set = set()
        self._cache_pool: Dict[int, KVCache] = {}
        self._lock = threading.Lock()

    @property
    def prompt_buckets(self) -> tuple:
        return self._prompt_buckets

    @staticmethod
    def _out_cap(max_new: int) -> int:
        """Output-buffer capacity (the power of two >= max_new) of the
        decode and beam loops."""
        return 1 << (max_new - 1).bit_length() if max_new > 1 else 1

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _pooled_cache(self, bb: int) -> KVCache:
        """The batch bucket's dense cache from the pool (made on a miss).
        Stale contents are never read: prefill rewrites [0, pb) and decode
        attends only within [start, pos]."""
        with self._lock:
            caches = self._cache_pool.pop(bb, None)
        if caches is None:
            caches = init_caches(self.cfg, bb, self.max_seq, self._dtype,
                                 self.device)
        return caches

    def _return_cache(self, bb: int, caches: KVCache) -> None:
        with self._lock:
            self._cache_pool.setdefault(bb, caches)

    def _prefill(self, prompts, bb: int, pb: int, min_len: int = 0):
        """The group's left-padded prefill on the pooled cache: (last
        logits (bb, vocab) f32, caches, start)."""
        tokens, attn_mask, pos_ids, start = left_pad_batch(prompts, bb, pb,
                                                           min_len)
        caches = self._pooled_cache(bb)
        logits, caches = transformer_prefill(
            self.params, self._put(tokens), caches, self.cfg,
            dtype=self._dtype, attn_mask=self._put(attn_mask),
            pos_ids=self._put(pos_ids))
        self._prefill_shapes.add((bb, pb))
        return logits, caches, start

    # -- beam search -----------------------------------------------------------

    def beam_search(self, prompt: Sequence[int], beam_width: int = 4,
                    max_new_tokens: int = 32, eos_id: int = -1,
                    length_penalty: float = 1.0) -> List[int]:
        """Deterministic beam decode of one prompt: the best beam by summed
        log-probability / length ** length_penalty (applied on the host,
        where the lengths are known)."""
        bw = int(beam_width)
        if bw < 1:
            raise ValueError(f"beam_width must be >= 1, got {beam_width}")
        prompt = list(prompt)
        pb = pick_bucket(self._prompt_buckets,
                         min(max(len(prompt), 1), self.max_seq))
        max_new = max(1, min(int(max_new_tokens), self.max_seq - pb))
        cap = self._out_cap(max_new)
        vocab = self.cfg.vocab
        dev = self.device
        with torch.inference_mode():
            logits, caches, start1 = self._prefill([prompt], 1, pb)
            logp0 = torch.log_softmax(logits[0].float(), dim=-1)
            scores, first = top_k_lowest_index_first(logp0, bw)
            # The prompt's K/V on every beam row; the width-1 cache goes
            # back to the pool.
            beams = KVCache(caches.k.repeat_interleave(bw, dim=1),
                            caches.v.repeat_interleave(bw, dim=1))
            self._return_cache(1, caches)
            start = self._put(np.repeat(start1, bw))
            rows = torch.arange(bw, device=dev)
            out_buf = torch.zeros((bw, cap), dtype=torch.int64, device=dev)
            out_buf[:, 0] = first
            done = (first == eos_id) | (max_new <= 1)
            eos_col = max(int(eos_id), 0)
            tok, pos, n_out = first, pb, 1
            while n_out < max_new and pos < self.max_seq:
                if ((n_out - 1) % self._step_chunk == 0
                        and not bool(done.logical_not().any())):
                    break
                logits, beams = transformer_decode_step(
                    self.params, tok, beams, pos, self.cfg,
                    dtype=self._dtype, start=start)
                logp = torch.log_softmax(logits.float(), dim=-1)
                # Live beams extend by any token; a finished beam stays as
                # one candidate (its score unchanged, EOS again).
                cand = torch.where(done[:, None], float("-inf"),
                                   scores[:, None] + logp)
                cand[:, eos_col] = torch.where(done, scores,
                                               cand[:, eos_col])
                vals, idx = top_k_lowest_index_first(cand.reshape(-1), bw)
                # A step after every beam finished (the early stop reads
                # the flag once per step_chunk steps) changes nothing.
                still = done.logical_not().any()
                src = torch.where(still, idx // vocab, rows)
                scores = torch.where(still, vals, scores)
                nxt = idx % vocab
                beams = KVCache(beams.k[:, src], beams.v[:, src])
                out_buf = out_buf[src]
                done = done[src]
                nxt = torch.where(done, eos_id, nxt)
                col = min(n_out, cap - 1)
                out_buf[:, col] = torch.where(done, out_buf[:, col], nxt)
                done = done | (nxt == eos_id)
                tok, pos, n_out = nxt, pos + 1, n_out + 1
            out = out_buf.cpu().numpy()
            final = scores.cpu().numpy()
        best, best_norm = [], -np.inf
        for b in range(bw):
            row = truncate_at_stops(out[b, :max_new].tolist(), eos_id, ())
            norm = final[b] / max(len(row), 1) ** float(length_penalty)
            if norm > best_norm:
                best, best_norm = row, norm
        return best

    # -- scoring ---------------------------------------------------------------

    def score(self, prompts: Sequence[Sequence[int]],
              completions: Sequence[Sequence[int]]) -> List[List[float]]:
        """Per-token log-probabilities of each completion given its prompt
        (teacher-forced, one forward a group): len(completion) floats per
        row. Rows RIGHT-pad to a shared sequence bucket; groups of the
        largest batch bucket."""
        if len(prompts) != len(completions):
            raise ValueError("prompts and completions length mismatch")
        out: List[List[float]] = []
        max_bb = self._batch_buckets[-1]
        for i in range(0, len(prompts), max_bb):
            out.extend(self._score_batch(
                [list(p) for p in prompts[i:i + max_bb]],
                [list(c) for c in completions[i:i + max_bb]]))
        return out

    def _score_batch(self, prompts, completions) -> List[List[float]]:
        n = len(prompts)
        bb = pick_bucket(self._batch_buckets, n)
        seqs = [(p or [0]) + c for p, c in zip(prompts, completions)]
        longest = min(max(len(s) for s in seqs), self.max_seq)
        sb = pick_bucket(self._prompt_buckets, longest)
        tokens = np.zeros((bb, sb), np.int32)
        attn = np.zeros((bb, sb), np.int32)
        for r, s in enumerate(seqs):
            if len(s) > sb:
                raise ValueError(
                    f"prompt+completion length {len(s)} exceeds the "
                    f"largest sequence bucket {sb}")
            tokens[r, :len(s)] = np.asarray(s, np.int32)
            attn[r, :len(s)] = 1
        with torch.inference_mode():
            tok = self._put(tokens)
            logits = transformer_apply(self.params, tok, self.cfg,
                                       mask=self._put(attn),
                                       dtype=self._dtype)
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            # log P(tokens[:, i] | tokens[:, :i]) sits at row i - 1.
            lp = logp.gather(-1, tok[:, 1:, None].long())[..., 0]
            lp = lp.cpu().numpy()
        results = []
        for r in range(n):
            start = max(len(prompts[r]), 1)  # an empty prompt scores pad 0
            end = start + len(completions[r])
            results.append([float(x) for x in lp[r, start - 1:end - 1]])
        return results

    # -- generation ------------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, eos_id: int = -1,
                 temperature: Union[float, Sequence[float]] = 0.0,
                 seed: Union[int, Sequence[int]] = 0,
                 top_p: Union[float, Sequence[float]] = 1.0,
                 top_k: Union[int, Sequence[int]] = 0,
                 repetition_penalty: Union[float, Sequence[float]] = 1.0,
                 stop_tokens=None,
                 min_p: Union[float, Sequence[float]] = 0.0,
                 fused: bool = False) -> List[List[int]]:
        """Generated tokens per prompt, cut before the first EOS or stop
        token (``eos_id`` -1 disables EOS). Sampling parameters may be
        per-prompt sequences; a scalar seed expands to seed + row.
        ``repetition_penalty`` (1.0 = off) and ``stop_tokens`` (a flat
        list for every row, or one list per row, at most 8 each) as in the
        continuous scheduler. ``fused`` (the lane's ``gen_decode_fused``)
        runs the same loop: eager PyTorch has no one-dispatch loop to
        choose, and JAX's two forms give one stream."""
        if not prompts:
            return []
        n = len(prompts)
        temps, seeds, top_ps, top_ks, min_ps = expand_sampling_params(
            n, temperature, seed, top_p, top_k, min_p)
        pens, stops = expand_stopping_params(n, repetition_penalty,
                                             stop_tokens)
        out: List[List[int]] = []
        max_bb = self._batch_buckets[-1]
        for i in range(0, n, max_bb):
            sl = slice(i, i + max_bb)
            out.extend(self._generate_batch(
                [list(p) for p in prompts[sl]], max_new_tokens, eos_id,
                temps[sl], seeds[sl], top_ps[sl], top_ks[sl], pens[sl],
                stops[sl], min_ps[sl]))
        return out

    def _group(self, prompts, max_new: int) -> tuple:
        """(n, batch bucket, prompt bucket, clamped max_new) of a group."""
        n = len(prompts)
        bb = pick_bucket(self._batch_buckets, n)
        longest = max(1, max(len(p) for p in prompts))
        pb = pick_bucket(self._prompt_buckets, min(longest, self.max_seq))
        return n, bb, pb, max(1, min(int(max_new), self.max_seq - pb))

    def _generate_batch(self, prompts, max_new, eos_id, temps, seeds,
                        top_ps, top_ks, pens, stops, min_ps):
        n, bb, pb, max_new = self._group(prompts, max_new)
        cap = self._out_cap(max_new)
        dev = self.device
        with torch.inference_mode():
            logits, caches, start = self._prefill(prompts, bb, pb)
            rows = _Rows(self, n, bb, pb, start, eos_id, temps, seeds,
                         top_ps, top_ks, pens, stops, min_ps)
            alive = torch.arange(bb, device=dev) < n
            counts = None
            if rows.controls:
                counts = self._put(token_counts([p[-pb:] for p in prompts],
                                                bb, self.cfg.vocab))
                logits = apply_repetition_penalty(logits, counts, rows.pens)
            # The first token: the prefill logits penalized by the prompt's
            # counts, which then count it too. Bucket rows start done.
            first = rows.sample(logits, pb - start)
            # Column cap takes the writes of rows that write nothing.
            out_buf = torch.zeros((bb, cap + 1), dtype=torch.int64,
                                  device=dev)
            out_buf[:, 0] = first
            n_out = torch.ones((bb,), dtype=torch.int64, device=dev)
            done = alive.logical_not() | rows.stopped(first) | (max_new <= 1)
            if rows.controls:
                rows.count(counts, first, alive.to(torch.int32))
            tok, pos = first, pb
            while pos < self.max_seq:
                # The loop's one host read: the all-done flag, once per
                # step_chunk steps.
                if ((pos - pb) % self._step_chunk == 0
                        and not bool(done.logical_not().any())):
                    break
                done0 = done
                caches, tok, done, counts = _decode_step_sampled(
                    self.params, self.cfg, self._dtype, rows, tok, caches,
                    pos, done, counts)
                write = done0.logical_not() & (n_out < cap)
                out_buf[rows.rows, torch.where(write, n_out, cap)] = \
                    torch.where(write, tok, 0)
                n_out = torch.where(done0, n_out, n_out + 1)
                done = done | (n_out >= max_new)
                pos += 1
            self._decode_shapes.add((bb, rows.controls))
            self._return_cache(bb, caches)
            out = out_buf[:, :cap].cpu().numpy()
            n_out = n_out.cpu().numpy()
        return [truncate_at_stops(out[r, :min(int(n_out[r]), max_new)]
                                  .tolist(), eos_id, stops[r])
                for r in range(n)]

    def stats(self) -> dict:
        """The JAX Generator's stats keys; ``compiled_prefill`` and
        ``compiled_decode`` list the (batch bucket, prompt bucket) and
        (batch bucket, controls) shapes run so far."""
        return {
            "model": self.spec.name,
            "max_seq": self.max_seq,
            "batch_buckets": list(self._batch_buckets),
            "prompt_buckets": list(self._prompt_buckets),
            "step_chunk": self._step_chunk,
            "compiled_prefill": sorted(self._prefill_shapes),
            "compiled_decode": sorted(self._decode_shapes),
        }


# The teacher-forced scorer of a lane without a batch Generator is a
# Generator (JAX's worker scores through one too).
Scorer = Generator
