"""The port's batch ``SpeculativeGenerator``
(tpu_engine_torch.runtime.speculative) against the JAX package's on the
same target and draft weights (carried across by models.convert), on the
CPU in f32, k = 3:

- for gpt2-small-test, llama-small-test, mistral-small-test and
  gpt2-moe-test, with a self-draft (the target's own weights) and a
  random draft (other seeded weights): greedy, temperature 0.8 and 1.2
  with seeds, and mixed temperatures with EOS give JAX's tokens and JAX's
  ``last_stats`` (rounds, tokens, mean tokens per round); greedy equals
  the plain Generator's greedy stream; the self-draft's greedy rounds
  advance k + 1 tokens;
- a differently shaped draft (one layer, another d_ff), a group split at
  the largest batch bucket (11 prompts), idle bucket rows (3 prompts in a
  bucket of 4) and stop tokens;
- a group clamped by max_seq (gpt2-small-test and gpt2-moe-test, a draft
  near the target, greedy and sampled), whose finished rows write past
  the cache;
- the constructor's and ``generate``'s refusals carry JAX's messages;
- ``stats()`` has JAX's keys, its ``spec`` block (``lane: "batch"``)
  JAX's values, and the port's /metrics renderer gives the JAX
  renderer's ``tpu_engine_spec_*`` lines for it.
"""

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.speculative import SpeculativeGenerator as JaxSpec
from tpu_engine.utils.metrics import render_prometheus as jax_render
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.generator import Generator
from tpu_engine_torch.runtime import speculative as spec_mod
from tpu_engine_torch.runtime.speculative import SpeculativeGenerator
from tpu_engine_torch.utils.metrics import render_prometheus

_ensure_builtin_models_imported()

K = 3
MAX_NEW = 16
MODELS = ("gpt2-small-test", "llama-small-test", "mistral-small-test",
          "gpt2-moe-test")
DRAFTS = ("self", "random")
CASES = {
    "greedy": {},
    "t0.8": dict(temperature=0.8, seed=[5, 6, 7]),
    "t1.2": dict(temperature=1.2, seed=11),
    # eos_id: a token of the greedy stream (set by the test).
    "mixed_eos": dict(temperature=[0.0, 1.2, 0.8], seed=[3, 4, 5]),
}


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


def _port(tree, spec):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree),
                                   spec.config, device="cpu",
                                   dtype="float32")


def _near(tree, noise):
    """The target's weights with seeded noise of ``noise`` times each
    matrix's spread: a draft that agrees often but not always."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(1)
    out = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.ndim >= 2:
            a = a + (noise * a.std()
                     * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return jax.tree.unflatten(treedef, out)


class _Pair:
    """JAX's and the port's SpeculativeGenerator on the same weights."""

    def __init__(self, name, draft, draft_kw=None):
        self.jspec, self.tspec = jcreate(name), tcreate(name)
        jd, td = (jcreate(name, **(draft_kw or {})),
                  tcreate(name, **(draft_kw or {})))
        jp = self.jspec.init(jax.random.PRNGKey(0))
        if draft == "self":
            jdp = jp
        elif draft.startswith("near"):
            jdp = _near(jp, float(draft.split("-")[1]))
        else:
            jdp = jd.init(jax.random.PRNGKey(5))
        self.tp = _port(jp, self.tspec)
        self.jax = JaxSpec(self.jspec, jd, params=jp, draft_params=jdp, k=K,
                           dtype="float32")
        self.port = SpeculativeGenerator(
            self.tspec, td, params=self.tp, draft_params=_port(jdp, td), k=K,
            dtype="float32", device="cpu")
        self.vocab = self.tspec.config.vocab


_PAIRS = {}


@pytest.fixture(scope="module")
def pairs():
    def get(name, draft, draft_kw=None):
        key = (name, draft, tuple(sorted((draft_kw or {}).items())))
        if key not in _PAIRS:
            _PAIRS[key] = _Pair(name, draft, draft_kw)
        return _PAIRS[key]
    yield get
    _PAIRS.clear()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("name", MODELS)
def test_streams_match_jax(pairs, name, draft, case):
    pair = pairs(name, draft)
    prompts = _prompts(pair.vocab, (5, 12, 3))
    kw = dict(CASES[case])
    if case == "mixed_eos":
        greedy = pair.jax.generate(prompts, max_new_tokens=MAX_NEW)
        kw["eos_id"] = greedy[0][4]
    want = pair.jax.generate(prompts, max_new_tokens=MAX_NEW, **kw)
    assert pair.port.generate(prompts, max_new_tokens=MAX_NEW, **kw) == want
    assert pair.port.last_stats == pair.jax.last_stats
    if case == "greedy":
        plain = Generator(pair.tspec, params=pair.tp, dtype="float32",
                          device="cpu")
        assert want == plain.generate(prompts, max_new_tokens=MAX_NEW)
        if draft == "self":
            assert pair.port.last_stats["mean_tokens_per_round"] == K + 1
    if case == "mixed_eos":
        assert len(want[0]) < MAX_NEW


def test_shaped_draft_split_idle_rows_and_stops(pairs):
    pair = pairs("gpt2-small-test", "random", dict(n_layers=1, d_ff=96))
    prompts = _prompts(pair.vocab, (5, 12, 3))
    for kw in ({}, dict(temperature=0.8, seed=9)):
        want = pair.jax.generate(prompts, max_new_tokens=MAX_NEW, **kw)
        assert pair.port.generate(prompts, max_new_tokens=MAX_NEW,
                                  **kw) == want
    # Eleven prompts: a group of 8 and a group of 3 (one idle row).
    many = _prompts(pair.vocab, [int(n) for n in np.random.default_rng(
        1).integers(1, 14, 11)], seed=2)
    want = pair.jax.generate(many, max_new_tokens=MAX_NEW)
    assert pair.port.generate(many, max_new_tokens=MAX_NEW) == want
    assert pair.port.last_stats == pair.jax.last_stats
    stops = sorted({r[2] for r in want if len(r) > 2})[:3]
    want = pair.jax.generate(prompts, max_new_tokens=MAX_NEW,
                             stop_tokens=stops)
    assert pair.port.generate(prompts, max_new_tokens=MAX_NEW,
                              stop_tokens=stops) == want


@pytest.mark.parametrize("name,draft,kw", [
    ("gpt2-small-test", "near-0.05", {}),
    ("gpt2-small-test", "near-0.1", dict(temperature=0.8, seed=[1, 2, 3])),
    ("gpt2-moe-test", "near-0.1", {}),
    ("gpt2-moe-test", "near-0.1", dict(temperature=0.8, seed=[1, 2, 3])),
], ids=["gpt2-greedy", "gpt2-t0.8", "moe-greedy", "moe-t0.8"])
def test_max_seq_clamp_matches_jax(pairs, monkeypatch, name, draft, kw):
    """Prompts in the 32 bucket ask for 40 tokens: max_new clamps to
    max_seq - 32 - W. A draft near the target accepts unevenly, so the
    rows reach the clamp in different rounds, and a row done first runs
    the next verify windows with writes past the cache (dropped, as JAX's
    scatter drops them; for MoE its hidden states still share the
    experts' capacity). The test checks that such a write happened."""
    pair = pairs(name, draft)
    past = []
    window = spec_mod.transformer_decode_window

    def spy(params, tokens, caches, pos_vec, cfg, **kw):
        past.append(bool((pos_vec + tokens.shape[1]
                          > caches.k.shape[2]).any()))
        return window(params, tokens, caches, pos_vec, cfg, **kw)
    monkeypatch.setattr(spec_mod, "transformer_decode_window", spy)
    prompts = _prompts(pair.vocab, (17, 30, 24), seed=1)
    want = pair.jax.generate(prompts, max_new_tokens=40, **kw)
    assert pair.port.generate(prompts, max_new_tokens=40, **kw) == want
    assert pair.port.last_stats == pair.jax.last_stats
    assert max(len(r) for r in want) == 64 - 32 - (K + 1)
    assert any(past)


def _raises_alike(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("draft,kw", [
    ("gpt2-chaos-test", {}),
    ("gpt2-small-test", dict(k=0)),
    ("bert-small-test", {}),
], ids=["vocab-mismatch", "k-zero", "encoder-draft"])
def test_constructor_refusals_carry_the_jax_message(draft, kw):
    _raises_alike(
        lambda: JaxSpec("gpt2-small-test", draft, dtype="float32", **kw),
        lambda: SpeculativeGenerator("gpt2-small-test", draft,
                                     dtype="float32", device="cpu", **kw))


@pytest.mark.parametrize("kw", [dict(top_p=0.9), dict(top_k=3),
                                dict(min_p=0.1),
                                dict(repetition_penalty=1.1)],
                         ids=["top_p", "top_k", "min_p", "penalty"])
def test_generate_refuses_filters_like_jax(pairs, kw):
    pair = pairs("gpt2-small-test", "self")
    _raises_alike(lambda: pair.jax.generate([[1, 2, 3]], 4, **kw),
                  lambda: pair.port.generate([[1, 2, 3]], 4, **kw))


def test_spec_block_and_metrics_match_jax():
    jspec, tspec = jcreate("gpt2-small-test"), tcreate("gpt2-small-test")
    jp = jspec.init(jax.random.PRNGKey(0))
    jdp = jspec.init(jax.random.PRNGKey(5))
    jgen = JaxSpec(jspec, jspec, params=jp, draft_params=jdp, k=K,
                   dtype="float32")
    tgen = SpeculativeGenerator(tspec, tspec, params=_port(jp, tspec),
                                draft_params=_port(jdp, tspec), k=K,
                                dtype="float32", device="cpu")
    prompts = _prompts(256, (5, 12, 3))
    for kw in ({}, dict(temperature=0.8, seed=3)):
        assert tgen.generate(prompts, MAX_NEW, **kw) \
            == jgen.generate(prompts, MAX_NEW, **kw)
    want, got = jgen.stats(), tgen.stats()
    assert set(got) == set(want)
    assert got["spec"] == want["spec"]
    assert got["spec"]["lane"] == "batch"
    assert got["prompt_buckets"] == want["prompt_buckets"]

    def spec_lines(render, st):
        text = render([{"node_id": "w1", "healthy": True,
                        "generator": st}]).decode()
        return [ln for ln in text.splitlines() if "tpu_engine_spec_" in ln]
    lines = spec_lines(render_prometheus, got)
    assert lines == spec_lines(jax_render, want)
    assert any('lane="batch"' in ln for ln in lines)
