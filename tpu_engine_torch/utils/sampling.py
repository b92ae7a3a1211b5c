"""Wire-level sampling-parameter normalization, shared by the port's
continuous scheduler and its /generate HTTP surface.

The port's own copy of ``tpu_engine/utils/sampling.py`` (the port imports
nothing of ``tpu_engine``); the rules are the same, so both packages
normalize a request's parameters identically.
"""

from __future__ import annotations

import numpy as np


def validate_min_p(m) -> float:
    """min_p boundary rule (0 = off, 1 = only-max-prob tokens) — one
    definition for every wire/API entry point."""
    m = float(m)
    if not 0.0 <= m <= 1.0:
        raise ValueError(f"min_p must be in [0, 1], got {m}")
    return m


def clamp_top_k(k) -> int:
    """Clamp a wire top_k to int32 range (like seed's & 0x7FFFFFFF): an
    out-of-range value must not OverflowError inside a shared batch."""
    return max(0, min(int(k), 0x7FFFFFFF))


def expand_sampling_params(n, temperature, seed, top_p, top_k, min_p=0.0):
    """Normalize scalar-or-sequence sampling params to per-row lists of
    length n (scalar seed expands to seed+row so rows of one call still
    sample independently; top_k clamps to int32 range at the boundary).
    Shared by both decode schedulers so the wire semantics can't drift.
    min_p (0 = off) keeps tokens with prob >= min_p x max prob (HF
    semantics, applied after temperature)."""
    temps = ([float(temperature)] * n if np.isscalar(temperature)
             else [float(t) for t in temperature])
    seeds = ([int(seed) + r for r in range(n)] if np.isscalar(seed)
             else [int(s) for s in seed])
    top_ps = ([float(top_p)] * n if np.isscalar(top_p)
              else [float(p) for p in top_p])
    top_ks = ([int(top_k)] * n if np.isscalar(top_k)
              else [int(k) for k in top_k])
    top_ks = [clamp_top_k(k) for k in top_ks]
    min_ps = ([float(min_p)] * n if np.isscalar(min_p)
              else [float(m) for m in min_p])
    if (len(temps) != n or len(seeds) != n or len(top_ps) != n
            or len(top_ks) != n or len(min_ps) != n):
        raise ValueError(
            "temperature/seed/top_p/top_k/min_p sequence length != n "
            "prompts")
    min_ps = [validate_min_p(m) for m in min_ps]
    return temps, seeds, top_ps, top_ks, min_ps


MAX_STOP_TOKENS = 8


def expand_stopping_params(n, repetition_penalty, stop_tokens):
    """Normalize repetition_penalty (scalar-or-sequence, 1.0 = off) and
    stop_tokens (None | flat id list shared by all rows | per-row list of
    lists) to per-row lists. Each row allows at most MAX_STOP_TOKENS stop
    ids (they pad a fixed-width device tensor)."""
    pens = ([float(repetition_penalty)] * n
            if np.isscalar(repetition_penalty)
            else [float(p) for p in repetition_penalty])
    if len(pens) != n:
        raise ValueError("repetition_penalty sequence length != n prompts")
    for p in pens:
        if p <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {p}")
    if stop_tokens is None:
        stops = [[] for _ in range(n)]
    else:
        stop_tokens = list(stop_tokens)
        if stop_tokens and isinstance(stop_tokens[0], (list, tuple)):
            stops = [[int(t) for t in row] for row in stop_tokens]
            if len(stops) != n:
                raise ValueError("stop_tokens rows != n prompts")
        else:
            shared = [int(t) for t in stop_tokens]
            stops = [list(shared) for _ in range(n)]
    for row in stops:
        if len(row) > MAX_STOP_TOKENS:
            raise ValueError(
                f"at most {MAX_STOP_TOKENS} stop tokens per request")
    return pens, stops


def stop_matrix(stops, n_rows):
    """(n_rows, MAX_STOP_TOKENS) int32 padded with -1 (matches no token)."""
    out = np.full((n_rows, MAX_STOP_TOKENS), -1, np.int32)
    for r, row in enumerate(stops[:n_rows]):
        out[r, :len(row)] = row
    return out


def truncate_at_stops(row, eos_id, stops):
    """Client-visible tokens: cut (exclusive) at the first EOS or stop
    token. The ONE truncation rule all decode lanes share."""
    enders = set(stops or ())
    if eos_id >= 0:
        enders.add(eos_id)
    if not enders:
        return row
    for i, t in enumerate(row):
        if t in enders:
            return row[:i]
    return row
