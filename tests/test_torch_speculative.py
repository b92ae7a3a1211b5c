"""The port's speculation pieces (tpu_engine_torch.runtime.speculative and
the ragged reads at the verify-window shape) against the JAX package's, on
the CPU, on the same numpy-seeded inputs:

- ``tagged_uniform`` gives ``jax.random.uniform``'s bits exactly, for
  shape () and (k,), over 64 (seed, position) pairs;
- ``tagged_categorical`` gives ``jax.random.categorical``'s draw wherever
  the perturbed top-two margin exceeds MARGIN (the port's Gumbel noise
  agrees with JAX's to about an ulp of values below 20, 2e-6; MARGIN is
  fifty times that), at V 256 and 50257;
- ``greedy_acceptance`` and ``rejection_acceptance``: n_acc and the
  emitted tokens exact, the correction token by the same margin rule;
- ``NGramDrafter`` proposes JAX's tokens on random and repetitive
  histories, k 1..6, with ``max_scan`` reached;
- ``ModelDrafter`` on gpt2-small-test in f32 (weights carried across by
  models.convert) proposes JAX's tokens over context lengths 1, 15, 16,
  17 and 63, with the bucket cap of a small draft, and refuses as JAX
  does;
- the ragged reads #1 and #4 at the spec verify shape (q_lens 1, k+1,
  k+1, 16, 17, windows placed across a 512-key split and a 16-token
  block): the port's plain and split versions against JAX's reference
  and its Pallas kernel in interpret mode (f32 1e-5, bf16 2e-2, int8
  2e-4, the tolerances of tests/test_torch_paged_split.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.ops import paged_attention as jpa
from tpu_engine.runtime import speculative as jsp
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import ModelSpec
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops import paged_attention as tpa
from tpu_engine_torch.ops.quant import quantize_kv
from tpu_engine_torch.runtime import speculative as tsp

_ensure_builtin_models_imported()

MARGIN = 1e-4
F32_TOL, BF16_TOL, QUANT_TOL = 1e-5, 2e-2, 2e-4


def _pairs(seed, n=64):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    seeds[:4] = [0, 1, 7, 2**31 - 1]
    pos = rng.integers(0, 4096, n).astype(np.int32)
    pos[:4] = [0, 1, 2047, 4095]
    return seeds, pos


def _jax_margin(seeds, pos, tag, logits):
    """Top-two margin of each row's perturbed logits under JAX's noise."""
    def row(s, p, lg):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(s),
                                                    p), tag)
        return lg + jax.random.gumbel(key, lg.shape)
    pert = np.asarray(jax.vmap(row)(seeds, pos, jnp.asarray(logits)))
    top2 = np.sort(pert, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("tag", [jsp._TAG_ACCEPT, jsp._TAG_RESID])
@pytest.mark.parametrize("shape", [(), (5,)])
def test_tagged_uniform_bits_equal_jax(tag, shape):
    seeds, pos = _pairs(tag)
    want = np.asarray(jsp._tagged_uniform(jnp.asarray(seeds),
                                          jnp.asarray(pos), tag, shape))
    got = tsp.tagged_uniform(torch.from_numpy(seeds), torch.from_numpy(pos),
                             tag, shape[0] if shape else None).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert tsp._TAG_ACCEPT == jsp._TAG_ACCEPT
    assert tsp._TAG_RESID == jsp._TAG_RESID


@pytest.mark.parametrize("vocab", [256, 50257])
def test_tagged_categorical_equals_jax_beyond_the_margin(vocab):
    seeds, pos = _pairs(vocab)
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((64, vocab)).astype(np.float32) * 2.0
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    want = np.asarray(jsp._tagged_categorical(
        jnp.asarray(seeds), jnp.asarray(pos), jsp._TAG_RESID,
        jnp.asarray(lp)))
    got = tsp.tagged_categorical(torch.from_numpy(seeds),
                                 torch.from_numpy(pos), tsp._TAG_RESID,
                                 torch.from_numpy(lp)).numpy()
    clear = _jax_margin(seeds, pos, jsp._TAG_RESID, lp) > MARGIN
    assert clear.sum() >= 60  # the rule leaves out near ties only
    assert np.array_equal(got[clear], want[clear])


def test_greedy_acceptance_equals_jax():
    rng = np.random.default_rng(3)
    b, k = 32, 4
    g = rng.integers(0, 6, (b, k + 1)).astype(np.int32)
    d = np.where(rng.random((b, k)) < 0.7, g[:, :k],
                 rng.integers(0, 6, (b, k))).astype(np.int32)
    jn, je = jsp.greedy_acceptance(jnp.asarray(d), jnp.asarray(g))
    tn, te = tsp.greedy_acceptance(torch.from_numpy(d), torch.from_numpy(g))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert len(set(tn.tolist())) >= 3  # several accept lengths seen


@pytest.mark.parametrize("seed", [0, 1])
def test_rejection_acceptance_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b, k, v = 64, 4, 16
    p = np.array(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((b, k + 1, v)).astype(np.float32))))
    q = np.array(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((b, k, v)).astype(np.float32))))
    d = rng.integers(0, v, (b, k)).astype(np.int32)
    seeds, logical = _pairs(seed + 10)
    jn, je = jsp.rejection_acceptance(*(jnp.asarray(a) for a in
                                        (d, p, q, seeds, logical)))
    tn, te = tsp.rejection_acceptance(*(torch.from_numpy(a) for a in
                                        (d, p, q, seeds, logical)))
    jn, je = np.asarray(jn), np.asarray(je)
    tn, te = tn.numpy(), te.numpy()
    assert np.array_equal(tn, jn)
    assert len(set(tn.tolist())) >= 3
    corr_slot = np.arange(k + 1)[None, :] == jn[:, None]
    assert np.array_equal(te[~corr_slot], je[~corr_slot])
    # The correction slot: JAX's draw wherever its margin is clear.
    rows = np.arange(b)
    q_pad = np.concatenate([q, np.zeros((b, 1, v), np.float32)], axis=1)
    p_j, q_j = p[rows, jn], q_pad[rows, jn]
    resid = np.maximum(p_j - q_j, 0.0)
    dist = np.where(resid.sum(-1, keepdims=True) > 0, resid, p_j)
    lp = np.log(np.maximum(dist, 1e-30))
    clear = _jax_margin(seeds, logical, jsp._TAG_RESID, lp) > MARGIN
    assert clear.sum() >= 60
    assert np.array_equal(te[corr_slot][clear], je[corr_slot][clear])


def _histories(seed):
    rng = np.random.default_rng(seed)
    out = [[], [5], [7] * 10, [1, 2, 3, 9, 9, 1, 2, 3], [1, 2, 3, 4, 5]]
    for n in (12, 40, 200):
        out.append(rng.integers(0, 6, n).tolist())        # repetitive
        out.append(rng.integers(0, 50000, n).tolist())    # random
        motif = rng.integers(0, 100, 7).tolist()
        out.append((motif * (n // 7 + 1))[:n])            # periodic
    return out


@pytest.mark.parametrize("max_scan", [1024, 24])
def test_ngram_drafter_equals_jax(max_scan):
    jd = jsp.NGramDrafter(max_scan=max_scan)
    td = tsp.NGramDrafter(max_scan=max_scan)
    seen = 0
    for ctx in _histories(max_scan):
        for k in range(1, 7):
            want = jd.propose(ctx, k)
            assert td.propose(ctx, k) == want, (ctx, k)
            seen += bool(want)
    assert seen > 30
    assert td.propose([1, 2, 3], 0) == [] and td.dispatches == 0
    for bad in (dict(max_ngram=1, min_ngram=2), dict(min_ngram=0)):
        with pytest.raises(ValueError, match="min_ngram <= max_ngram"):
            tsp.NGramDrafter(**bad)


def _drafter_pair(max_seq, k):
    jspec = jcreate("gpt2-small-test", max_seq=max_seq)
    params = jspec.init(jax.random.PRNGKey(4))
    tspec = tcreate("gpt2-small-test", max_seq=max_seq)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      tspec.config, device="cpu")
    return (jsp.ModelDrafter(jspec, params=params, k=k, dtype="float32"),
            tsp.ModelDrafter(tspec, params=tparams, k=k, dtype="float32",
                             device="cpu"))


@pytest.mark.parametrize("k", [1, 3])
def test_model_drafter_equals_jax(k):
    jd, td = _drafter_pair(64, k)
    rng = np.random.default_rng(k)
    for n in (1, 15, 16, 17, 63):
        ctx = rng.integers(1, 256, n).tolist()
        want = jd.propose(ctx, k)
        assert len(want) == k
        assert td.propose(ctx, k) == want, n
    assert td.dispatches == jd.dispatches == 5
    assert td.propose([], k) == [] and td.propose([3], 0) == []
    assert td.max_scan == jd.max_scan


def test_small_draft_caps_its_bucket_like_jax():
    """A draft whose max_seq is below the 16-token bucket floor caps the
    bucket (decode positions stay inside its table) and proposes JAX's
    tokens."""
    jd, td = _drafter_pair(8, 2)
    assert td.bucket(5) == 6
    for ctx in ([1, 2, 3, 4, 5], [9], list(range(1, 12))):
        assert td.propose(ctx, 2) == jd.propose(ctx, 2)


def test_model_drafter_refusals_match_jax():
    encoder = tcreate("gpt2-small-test")
    encoder = ModelSpec("bert-small-test",
                        dataclasses.replace(encoder.config, causal=False))
    cases = (
        (lambda: jsp.ModelDrafter(jcreate("bert-small-test"), k=3),
         lambda: tsp.ModelDrafter(encoder, k=3, device="cpu")),
        (lambda: jsp.ModelDrafter(jcreate("gpt2-small-test"), k=0),
         lambda: tsp.ModelDrafter("gpt2-small-test", k=0, device="cpu")),
        (lambda: jsp.ModelDrafter(jcreate("gpt2-small-test", max_seq=4),
                                  k=3, dtype="float32"),
         lambda: tsp.ModelDrafter(tcreate("gpt2-small-test", max_seq=4),
                                  k=3, dtype="float32", device="cpu")),
        (lambda: jsp.make_drafter("model", 3),
         lambda: tsp.make_drafter("model", 3)),
        (lambda: jsp.make_drafter("ngrma", 3),
         lambda: tsp.make_drafter("ngrma", 3)),
    )
    for jax_call, port_call in cases:
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)


def test_model_drafter_random_init_is_its_own_seeded_init():
    a = tsp.ModelDrafter("gpt2-small-test", k=2, dtype="float32",
                         device="cpu")
    b = tsp.make_drafter("model", 2, draft_model="gpt2-small-test",
                         dtype="float32", device="cpu")
    ref = tcreate("gpt2-small-test").init(1, device="cpu", dtype="float32")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for key in sorted(tree) for x in leaves(tree[key])]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves(t)]
        return [tree]
    assert all(torch.equal(x, y) for x, y in zip(leaves(a.params),
                                                 leaves(ref), strict=True))
    assert a.propose([1, 2, 3], 2) == b.propose([1, 2, 3], 2)


# -- the ragged reads at the spec verify shape --------------------------------

def _verify_inputs(k, h, h_kv, quant, seed=0, d=16, bs=16, nb=48):
    """One ragged batch of the --spec-k tick: an undrafted decode row, two
    k+1 verify windows (one across the 512-key split, one across a
    16-token block edge) and prefill chunks of 16 and 17 tokens."""
    q_lens = (1, k + 1, k + 1, 16, 17)
    pos0 = (100, 512 - k // 2 - 1, 2 * bs - 2, 300, 600)
    rng = np.random.default_rng(seed)
    b, w = len(q_lens), max(q_lens)
    n_pool = b * nb + 1
    q = rng.standard_normal((b, w, h, d), np.float32)
    k_pool = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    v_pool = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    tables = (1 + rng.permutation(n_pool - 1)).reshape(b, nb).astype(
        np.int32)
    meta = (tables, np.asarray(pos0, np.int32), np.asarray(q_lens, np.int32))
    if quant:
        (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(x))
                              for x in (k_pool, v_pool))
        return (q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(), *meta)
    return (q, k_pool, v_pool, *meta)


def _valid_err(got, want, qlen):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    valid = np.arange(diff.shape[1])[None, :] < qlen[:, None]
    return float(np.where(valid[:, :, None, None], diff, 0.0).max())


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_ragged_read_at_the_verify_shape_matches_jax(k, dtype, tol):
    arrs = _verify_inputs(k, 8, 2, quant=False, seed=k)
    t = [torch.from_numpy(a) for a in arrs]
    t[1], t[2] = t[1].to(getattr(torch, dtype)), t[2].to(getattr(torch,
                                                                dtype))
    jargs = [jnp.asarray(a) for a in arrs]
    jargs[1], jargs[2] = (jargs[1].astype(dtype), jargs[2].astype(dtype))
    wants = (jpa.ragged_paged_attention_reference(*jargs),
             jpa.ragged_paged_attention(*jargs, interpret=True))
    qlen = arrs[-1]
    plain = tpa.ragged_paged_attention(*t)  # the CPU wrapper: plain version
    split = tpa.ragged_paged_attention_split_reference(*t)
    for got in (plain, split):
        for want in wants:
            assert _valid_err(got.float().numpy(), want, qlen) < tol
    plan = tpa.ragged_split_plan(arrs[4], qlen, split.shape[1], 4, 16,
                                 arrs[3].shape[1])
    assert plan[1].max() > 1  # the window across 512 keys merges splits


@pytest.mark.parametrize("k", [3, 4])
def test_int8_ragged_read_at_the_verify_shape_matches_jax(k):
    arrs = _verify_inputs(k, 8, 2, quant=True, seed=k)
    t = [torch.from_numpy(a) for a in arrs]
    jargs = [jnp.asarray(a) for a in arrs]
    wants = (jpa.quant_ragged_paged_attention_reference(*jargs),
             jpa.quant_ragged_paged_attention(*jargs, interpret=True))
    qlen = arrs[-1]
    for got in (tpa.quant_ragged_paged_attention(*t),
                tpa.quant_ragged_paged_attention_split_reference(*t)):
        for want in wants:
            assert _valid_err(got.numpy(), want, qlen) < QUANT_TOL
