"""Decode helpers the continuous scheduler uses (counterpart of the
helpers in ``tpu_engine/runtime/generator.py``): bucketing, right-padding,
token counts, the repetition penalty and per-row sampling; and ``Scorer``,
the counterpart of ``Generator.score`` (teacher-forced scoring; the
Generator's batch decode, beam search and fused decode are not ported).

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

from typing import List, Sequence

import numpy as np
import torch

from tpu_engine_torch.models.registry import ModelSpec
from tpu_engine_torch.models.transformer import transformer_apply
from tpu_engine_torch.utils import prng
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype


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


# The JAX Generator's default batch buckets, which its scorer pads to.
SCORE_BATCH_BUCKETS = (1, 2, 4, 8)


def power_of_two_buckets(max_seq: int) -> tuple:
    """16, 32, ... below max_seq, then max_seq: the JAX generator's prompt
    buckets."""
    b, out = 16, []
    while b < max_seq:
        out.append(b)
        b *= 2
    return tuple(out) + (max_seq,)


class Scorer:
    """Teacher-forced scoring of a decoder LM: per-token log P(completion
    | prompt) in one forward (counterpart of ``Generator.score`` and
    ``_score_batch``, with its batch and sequence buckets).

    Each row is prompt (or [0] when empty) + completion, RIGHT-padded to
    the group's sequence bucket (``power_of_two_buckets(max_seq)``);
    batches pad to a bucket of ``SCORE_BATCH_BUCKETS`` and chunk at the
    largest. The forward is one ``transformer_apply`` with the padding
    mask (the flash kernel on the card); the result is the f32
    ``log_softmax`` gathered at each completion token."""

    def __init__(self, spec: ModelSpec, params, dtype: str = "bfloat16",
                 device=None):
        self.cfg = spec.config
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self.prompt_buckets = power_of_two_buckets(self.cfg.max_seq)
        self.params = params

    def score(self, prompts: Sequence[Sequence[int]],
              completions: Sequence[Sequence[int]]) -> List[List[float]]:
        """len(completion) log-probabilities per row."""
        if len(prompts) != len(completions):
            raise ValueError("prompts and completions length mismatch")
        out: List[List[float]] = []
        max_bb = SCORE_BATCH_BUCKETS[-1]
        for i in range(0, len(prompts), max_bb):
            out.extend(self._score_batch(
                [list(p) for p in prompts[i:i + max_bb]],
                [list(c) for c in completions[i:i + max_bb]]))
        return out

    def _score_batch(self, prompts, completions) -> List[List[float]]:
        n = len(prompts)
        bb = pick_bucket(SCORE_BATCH_BUCKETS, n)
        seqs = [(p or [0]) + c for p, c in zip(prompts, completions)]
        longest = min(max(len(s) for s in seqs), self.cfg.max_seq)
        sb = pick_bucket(self.prompt_buckets, longest)
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
            tok = torch.from_numpy(tokens).to(self.device)
            logits = transformer_apply(
                self.params, tok, self.cfg,
                mask=torch.from_numpy(attn).to(self.device),
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
