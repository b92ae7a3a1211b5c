"""The port's batch Generator (tpu_engine_torch.runtime.generator) against
the JAX package's ``Generator`` on the same weights (carried across by
models.convert), on the CPU in f32, for gpt2-small-test,
llama-small-test (GQA, rope), mistral-small-test (a sliding window in the
prefill band and the decode mask) and a drop-prone MoE config (DROP:
gpt2-moe's routing at test size, 4 experts, top-2, capacity factor 1.25,
whose capacity slots the left padding and the bucket rows share):

- greedy, seeded top_p, top_k and min_p, a repetition penalty with stop
  tokens, and EOS: the port's stream, with and without ``fused`` (one
  loop serves both), equals JAX's chunked stream token for token, and on
  the long prompt JAX's fused stream too (fused == chunked == JAX);
- a partial batch bucket (3 prompts in a bucket of 4, one fully masked
  row), a long prompt whose group runs its last chunk past max_seq, and a
  prompt in the max_seq bucket (clamped to one token, with every prompt
  grouped with it);
- beam width 1 equals greedy; beam width 4 equals JAX's ``beam_search``
  (with EOS and a length penalty too); on a model whose every logit ties,
  the beams keep ``jax.lax.top_k``'s order (lowest index first), and
  ``top_k_lowest_index_first`` equals ``lax.top_k`` on tied rows;
- ``score`` within 1e-5 of JAX's; ``stats()`` has JAX's keys;
- in bf16 the greedy streams agree with JAX's bf16 streams up to a token
  whose top-2 margin (JAX's bf16 forward of the stream so far) is at most
  BF16_MARGIN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models import transformer as jt
from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.generator import Generator as JaxGenerator
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.generator import (
    Generator,
    top_k_lowest_index_first,
)

_ensure_builtin_models_imported()

CHUNK = 5
MAX_NEW = 20
SCORE_TOL = 1e-5
# bf16 greedy streams may part where the top two logits are this close
# (JAX's bf16 forward; logits of order 1 carry bf16 errors of ~1e-2).
BF16_MARGIN = 5e-2
DROP = dict(vocab=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq=64, n_experts=4, top_k=2, capacity_factor=1.25,
            seq_len=16)
MODELS = {"gpt2-small-test": ("gpt2-small-test", {}),
          "llama-small-test": ("llama-small-test", {}),
          "mistral-small-test": ("mistral-small-test", {}),
          "moe-drop": ("gpt2-moe", DROP)}
CASES = {
    "greedy": {},
    "top_p": dict(temperature=0.8, seed=[11, 12, 13], top_p=0.9),
    "top_k": dict(temperature=1.0, seed=7, top_k=5),
    "min_p": dict(temperature=0.9, seed=3, min_p=0.1),
    "penalty_stops": dict(repetition_penalty=1.2, stop_tokens=[7, 9, 40]),
    # eos_id: a token of the greedy stream (set by the test).
    "eos": dict(temperature=0.8, seed=21),
}


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


class _Pair:
    """One model in both packages: JAX's Generator and the port's on the
    same f32 weights."""

    def __init__(self, key, dtype="float32"):
        name, kw = MODELS[key]
        self.jspec, self.tspec = jcreate(name, **kw), tcreate(name, **kw)
        self.jp = self.jspec.init(jax.random.PRNGKey(0))
        self.tp = convert.params_from_jax(jax.tree.map(np.asarray, self.jp),
                                          self.tspec.config, device="cpu",
                                          dtype=dtype)
        self.jax = JaxGenerator(self.jspec, params=self.jp, dtype=dtype,
                                step_chunk=CHUNK)
        self.port = Generator(self.tspec, params=self.tp, dtype=dtype,
                              step_chunk=CHUNK, device="cpu")
        self.vocab = self.tspec.config.vocab
        self.max_seq = self.tspec.config.max_seq


_PAIRS = {}


@pytest.fixture(scope="module")
def pairs():
    def get(key, dtype="float32"):
        if (key, dtype) not in _PAIRS:
            _PAIRS[key, dtype] = _Pair(key, dtype)
        return _PAIRS[key, dtype]
    yield get
    _PAIRS.clear()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("key", list(MODELS))
def test_streams_match_jax(pairs, key, case):
    pair = pairs(key)
    prompts = _prompts(pair.vocab, (5, 12, 3))
    kw = dict(CASES[case])
    if case == "eos":
        greedy = pair.jax.generate(prompts, max_new_tokens=MAX_NEW)
        kw = dict(kw, eos_id=greedy[1][5])
    want = pair.jax.generate(prompts, max_new_tokens=MAX_NEW, **kw)
    chunked = pair.port.generate(prompts, max_new_tokens=MAX_NEW, **kw)
    fused = pair.port.generate(prompts, max_new_tokens=MAX_NEW, fused=True,
                               **kw)
    assert chunked == want
    assert fused == chunked
    if case == "eos":
        # EOS ends a row early (and is not part of its result).
        assert any(len(r) < MAX_NEW for r in want)
    if case == "penalty_stops":
        assert not any({7, 9, 40} & set(r) for r in want)


@pytest.mark.parametrize("key", list(MODELS))
def test_long_prompt_and_clamp(pairs, key):
    pair = pairs(key)
    # A long prompt: the 32 bucket, 40 new tokens clamped to 32, the
    # last 5-step chunk reaching past max_seq.
    long = _prompts(pair.vocab, (30, 4, 11), seed=2)
    want = pair.jax.generate(long, max_new_tokens=40)
    assert len(want[0]) == pair.max_seq - 32
    assert pair.port.generate(long, max_new_tokens=40) == want
    # JAX's one-dispatch loop, which never steps past max_seq, gives the
    # same stream; so does the port with the flag.
    assert pair.jax.generate(long, max_new_tokens=40, fused=True) == want
    assert pair.port.generate(long, max_new_tokens=40, fused=True) == want
    # A prompt in the max_seq bucket gets one token, and so does every
    # prompt grouped with it.
    clamp = _prompts(pair.vocab, (pair.max_seq - 10, 3, 8), seed=3)
    want = pair.jax.generate(clamp, max_new_tokens=16)
    assert [len(r) for r in want] == [1, 1, 1]
    assert pair.port.generate(clamp, max_new_tokens=16) == want
    assert pair.port.generate(clamp, max_new_tokens=16, fused=True) == want


@pytest.mark.parametrize("key", list(MODELS))
def test_beam_search_matches_jax(pairs, key):
    pair = pairs(key)
    prompt = _prompts(pair.vocab, (9,), seed=4)[0]
    assert pair.port.beam_search(prompt, beam_width=1, max_new_tokens=12) \
        == pair.port.generate([prompt], max_new_tokens=12)[0]
    greedy = pair.jax.generate([prompt], max_new_tokens=12)[0]
    for kw in (dict(), dict(eos_id=greedy[3], length_penalty=0.6)):
        want = pair.jax.beam_search(prompt, beam_width=4, max_new_tokens=12,
                                    **kw)
        assert pair.port.beam_search(prompt, beam_width=4,
                                     max_new_tokens=12, **kw) == want


def test_top_k_keeps_lax_tie_order():
    rng = np.random.default_rng(6)
    rows = [np.array([1, 3, 3, 2, 3], np.float32),
            np.array([-np.inf, 0, -np.inf, 0, 0, -np.inf], np.float32),
            rng.integers(0, 3, 200).astype(np.float32)]
    for x in rows:
        for k in (1, 3, 4):
            vals, idx = jax.lax.top_k(jnp.asarray(x), k)
            got_v, got_i = top_k_lowest_index_first(torch.from_numpy(x), k)
            assert got_i.tolist() == np.asarray(idx).tolist()
            assert got_v.tolist() == np.asarray(vals).tolist()


def test_beam_ties_keep_lax_order(pairs):
    """A head of zeros: every logit ties, so every beam candidate ties and
    the beams are the lowest token indices, in ``lax.top_k``'s order."""
    pair = pairs("gpt2-small-test")

    def zero_head(tree, zeros):
        return {**tree, "head": {k: zeros(v) for k, v in tree["head"].items()}}

    jp = zero_head(pair.jp, jnp.zeros_like)
    tp = zero_head(pair.tp, torch.zeros_like)
    jgen = JaxGenerator(pair.jspec, params=jp, dtype="float32",
                        step_chunk=CHUNK)
    tgen = Generator(pair.tspec, params=tp, dtype="float32",
                     step_chunk=CHUNK, device="cpu")
    prompt = _prompts(pair.vocab, (9,), seed=4)[0]
    for bw in (2, 4):
        want = jgen.beam_search(prompt, beam_width=bw, max_new_tokens=6)
        assert tgen.beam_search(prompt, beam_width=bw,
                                max_new_tokens=6) == want


@pytest.mark.parametrize("key", list(MODELS))
def test_score_matches_jax(pairs, key):
    pair = pairs(key)
    prompts = _prompts(pair.vocab, (5, 12, 0), seed=7)
    completions = _prompts(pair.vocab, (3, 1, 6), seed=8)
    want = pair.jax.score(prompts, completions)
    got = pair.port.score(prompts, completions)
    assert [len(r) for r in got] == [3, 1, 6]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=SCORE_TOL, rtol=0)


def test_stats_have_the_jax_keys(pairs):
    pair = pairs("gpt2-small-test")
    jgen = JaxGenerator(pair.jspec, params=pair.jp, dtype="float32",
                        step_chunk=CHUNK)
    prompts = _prompts(pair.vocab, (5,))
    jgen.generate(prompts, max_new_tokens=4)
    pair.port.generate(prompts, max_new_tokens=4)
    got = pair.port.stats()
    assert set(got) == set(jgen.stats())
    assert got["batch_buckets"] == [1, 2, 4, 8]
    assert got["prompt_buckets"] == [16, 32, 64]
    assert (1, 16) in got["compiled_prefill"]
    assert (1, False) in got["compiled_decode"]


def _margins(jspec, jp, seq, n_prompt):
    """Top-2 logit margin of JAX's bf16 forward at each generated
    position of ``seq`` (the prompt's n_prompt tokens, then the stream)."""
    logits = np.asarray(jt.transformer_apply(
        jp, jnp.asarray([seq], jnp.int32), jspec.config,
        dtype=jnp.bfloat16))[0].astype(np.float32)
    top2 = np.sort(logits[n_prompt - 1:len(seq) - 1], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("key", ["gpt2-small-test", "llama-small-test"])
def test_bf16_streams_agree_above_the_margin(pairs, key):
    pair = pairs(key, "bfloat16")
    prompts = _prompts(pair.vocab, (5, 12, 3), seed=9)
    want = pair.jax.generate(prompts, max_new_tokens=MAX_NEW)
    got = pair.port.generate(prompts, max_new_tokens=MAX_NEW)
    assert pair.port.generate(prompts, max_new_tokens=MAX_NEW,
                              fused=True) == got
    for p, w, g in zip(prompts, want, got):
        if w == g:
            continue
        i = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        m = _margins(pair.jspec, pair.jp, p + w, len(p))
        assert m[i] <= BF16_MARGIN, (i, m[i], w, g)
