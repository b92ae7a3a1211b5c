"""The port's recurrent family (state_slab: ops.ssd, models.ssd,
runtime.kv_blocks.StateSlabPool and the scheduler's slab lanes) against
the JAX package's on the CPU, at ssd-small-test (2 layers, d_model 64),
with the same weights (carried across by models.convert.ssd_params_from_
jax) and numpy-seeded inputs. The wrapper takes the window scan's plain
version here (CPU tensors).

Tolerances, each with its reason:
- ops (``ssd_step``, ``ssd_recurrent``, ``ssd_chunked``): 1e-5 absolute on
  unit-scale values, f32 sums taken in another order;
- the model (``ssd_window_scan``, ``ssd_step_rows``,
  ``ssd_prefill_chunked``): 1e-4 absolute on logits of magnitude about 5
  and on the states. The rmsnorms' rsqrt differs from XLA's CPU rsqrt by
  an ulp on about a third of inputs, and the port's in_proj runs over all
  B·W tokens at once, so the bits differ; the readings are about 6e-6;
- streams: token for token on margin prompts, whose JAX greedy streams
  keep a top-two logit margin above MARGIN, 5 times the model bound,
  checked here (the smallest reads 1.1e-3). The JAX reference is its
  mixed lane for both of the port's modes: the JAX scheduler holds its
  two-path and mixed slab streams byte-identical by design, and its
  two-path lane's seeded streams were seen to vary from run to run in a
  process that had run other jitted JAX work first (ROADMAP §C).

Also: the pool's invariants and refusals, chains crossing between the two
packages in both directions bit-exactly, the scheduler's two-path and
mixed lanes (greedy and seeded, penalty and stop controls, replay resume,
deferred admission, deadline cancel, migration splice, handoff, crash
recovery) against the JAX scheduler's live streams, the fences' messages,
the gated ``state_pool`` block, the ``state_*`` spans, /metrics and a
worker serving /generate and /infer with the JAX worker's /health
schema."""

import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models import ssd as jssd
from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    available_models as javailable,
    create_model as jcreate,
)
from tpu_engine.ops import ssd as jops
from tpu_engine.runtime.kv_blocks import StateSlabPool as JaxPool
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine_torch.models import convert
from tpu_engine_torch.models import ssd as tssd
from tpu_engine_torch.models.registry import (
    FAMILY_CAPABILITIES,
    available_models,
    create_model as tcreate,
)
from tpu_engine_torch.ops import ssd as tops
from tpu_engine_torch.runtime.kv_blocks import PoolExhausted, StateSlabPool
from tpu_engine_torch.runtime.scheduler import (
    ContinuousGenerator,
    ImportRefused,
)
from tpu_engine_torch.utils.deadline import Deadline, DeadlineExceeded

_ensure_builtin_models_imported()

OPS_TOL = 1e-5
MODEL_TOL = 1e-4
MARGIN = 5e-4
KW = dict(n_slots=4, step_chunk=2, prefill_chunk=8)  # the JAX test's lane
MIXED = dict(mixed_step=True, mixed_token_budget=6)
PROMPTS = [[5, 9, 3, 17, 44, 2, 8, 11, 23], [7, 2], [1] * 12]


@pytest.fixture(scope="module")
def jspec():
    return jcreate("ssd-small-test")


@pytest.fixture(scope="module")
def jparams(jspec):
    return jspec.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def spec():
    return tcreate("ssd-small-test")


@pytest.fixture(scope="module")
def tparams(jparams, spec):
    return convert.ssd_params_from_jax(jax.tree.map(np.asarray, jparams),
                                       spec.config, device="cpu")


def _tgen(spec, tparams, **kw):
    return ContinuousGenerator(spec, params=tparams, dtype="float32",
                               device="cpu", **dict(KW, **kw))


def _jgen(jspec, jparams, **kw):
    return JaxGen(jspec, params=jparams, dtype="float32", **dict(KW, **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _drain(q, got=None, until=None) -> list:
    """Tokens from a stream queue until its end (or ``until`` tokens)."""
    got = [] if got is None else got
    while until is None or len(got) < until:
        item = q.get(timeout=60)
        if item is None:
            break
        got += item
    return got


def _leak_free(gen) -> bool:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        st = gen.stats()
        sp = st["state_pool"]
        if st["active"] == 0 and sp["rows_free"] == sp["rows_total"]:
            return True
        time.sleep(0.02)
    return False


@pytest.fixture(scope="module")
def lanes(spec, tparams, jspec, jparams):
    """The port's two-path and mixed lanes and the JAX mixed lane, their
    reference, shared by the stream tests (each test's requests are its
    own)."""
    gens = {"jax": _jgen(jspec, jparams, **MIXED),
            "two-path": _tgen(spec, tparams),
            "mixed": _tgen(spec, tparams, **MIXED)}
    yield gens
    for g in gens.values():
        g.stop()


# -- ops ----------------------------------------------------------------------

def _ops_inputs(seed, b=2, t=24, h=2, p=4, n=3, s0=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.standard_normal((b, t, h, p)).astype(f),
           rng.uniform(0.05, 0.3, (b, t, h)).astype(f),
           -rng.uniform(0.2, 1.5, (h,)).astype(f),
           rng.standard_normal((b, t, n)).astype(f),
           rng.standard_normal((b, t, n)).astype(f)]
    if s0:
        out.append(rng.standard_normal((b, h, p, n)).astype(f))
    return out


def test_ops_step_and_recurrence_match_jax():
    x, dt, A, B, C, s0 = _ops_inputs(3, s0=True)
    jy, js = jops.ssd_step(jnp.asarray(s0), jnp.asarray(x[:, 0]),
                           jnp.asarray(dt[:, 0]), jnp.asarray(A),
                           jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    ty, ts = tops.ssd_step(_t(s0), _t(x[:, 0]), _t(dt[:, 0]), _t(A),
                           _t(B[:, 0]), _t(C[:, 0]))
    assert _maxdiff(jy, ty) < OPS_TOL and _maxdiff(js, ts) < OPS_TOL
    jy, js = jops.ssd_recurrent(*map(jnp.asarray, (x, dt, A, B, C)),
                                initial_state=jnp.asarray(s0))
    ty, ts = tops.ssd_recurrent(*map(_t, (x, dt, A, B, C)),
                                initial_state=_t(s0))
    assert _maxdiff(jy, ty) < OPS_TOL and _maxdiff(js, ts) < OPS_TOL


@pytest.mark.parametrize("chunk,initial", [(8, False), (8, True), (5, True)])
def test_ops_chunked_matches_jax_and_recurrence(chunk, initial):
    x, dt, A, B, C, s0 = _ops_inputs(7, s0=True)
    init_j = jnp.asarray(s0) if initial else None
    init_t = _t(s0) if initial else None
    jy, js = jops.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                              chunk=chunk, initial_state=init_j)
    ty, ts = tops.ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk=chunk,
                              initial_state=init_t)
    assert _maxdiff(jy, ty) < OPS_TOL and _maxdiff(js, ts) < OPS_TOL
    ry, rs = tops.ssd_recurrent(*map(_t, (x, dt, A, B, C)),
                                initial_state=init_t)
    assert _maxdiff(ry, ty) < 1e-4 and _maxdiff(rs, ts) < 1e-4
    # _segsum: -inf above the diagonal, equal sums below.
    a = np.random.default_rng(1).standard_normal((2, 6)).astype(np.float32)
    assert np.array_equal(np.isinf(np.asarray(jops._segsum(jnp.asarray(a)))),
                          np.isinf(tops._segsum(_t(a)).numpy()))


@pytest.mark.parametrize("kw", [{}, dict(batch=1, seq=11, chunk=32, seed=5)])
def test_ops_parity_check_matches_jax(kw):
    t = tops.ssd_parity_check(**kw)
    j = jops.ssd_parity_check(**kw)
    assert t["ok"] and j["ok"], (t, j)
    assert set(t) == set(j)
    assert abs(t["max_abs_diff_y"] - j["max_abs_diff_y"]) < 1e-5


@pytest.mark.parametrize("batch,width,qlen", [(1, 1, [1]), (3, 5, [5, 2, 0]),
                                              (2, 7, [3, 7])])
def test_scan_reference_partition_invariant(batch, width, qlen):
    """The window scan's plain version: one W-slot call gives the state
    bits and y of W one-slot calls; qlen-0 rows are untouched."""
    di, N, H = 16, 8, 2
    proj, state, ids, cw, cb, dtb, alog, D = tops.scan_parity_inputs(
        batch, width, di, N, H, seed=batch)
    args = tuple(map(_t, (cw, cb, dtb, alog, D)))
    whole = _t(state)
    y = tops.ssd_scan_reference(_t(proj), whole, _t(ids),
                                _t(np.array(qlen, np.int32)), *args, N, H)
    steps = _t(state)
    ys = []
    for j in range(width):
        ql = np.array([1 if j < q else 0 for q in qlen], np.int32)
        ys.append(tops.ssd_scan_reference(_t(proj[:, j:j + 1]), steps,
                                          _t(ids), _t(ql), *args, N, H))
    assert torch.equal(whole, steps)
    assert torch.equal(y, torch.cat(ys, 1))
    for r, q in enumerate(qlen):
        if q == 0:
            assert torch.equal(whole[ids[r]], _t(state)[ids[r]])
            assert not y[r].any()
    assert torch.equal(whole[0], _t(state)[0])  # the null row


# -- the model ----------------------------------------------------------------

def test_window_scan_ragged_matches_jax(jspec, jparams, spec, tparams):
    cfg = spec.config
    rng = np.random.default_rng(0)
    B, W = 4, 7
    toks = rng.integers(0, cfg.vocab, (B, W)).astype(np.int32)
    qlen = np.array([7, 3, 0, 1], np.int32)
    slot = np.array([6, 2, 0, 0], np.int32)
    zero = jssd.ssd_init_states(jspec.config, B)
    s0 = jssd.SSDState(
        jnp.asarray(rng.standard_normal(zero.conv.shape), jnp.float32),
        jnp.asarray(rng.standard_normal(zero.ssm.shape), jnp.float32))
    jk, js = jssd.ssd_window_scan(jparams, jnp.asarray(toks), s0,
                                  jnp.asarray(qlen), jnp.asarray(slot),
                                  jspec.config)
    tk, ts = tssd.ssd_window_scan(
        tparams, _t(toks), tssd.SSDState(_t(s0.conv), _t(s0.ssm)), qlen,
        slot, cfg)
    valid = qlen > 0
    assert _maxdiff(np.asarray(jk)[valid], tk.numpy()[valid]) < MODEL_TOL
    assert _maxdiff(js.conv, ts.conv) < MODEL_TOL
    assert _maxdiff(js.ssm, ts.ssm) < MODEL_TOL
    # The masked row (qlen 0) keeps its state bit for bit.
    assert np.array_equal(np.asarray(s0.ssm)[:, 2], ts.ssm[:, 2].numpy())
    assert np.array_equal(np.asarray(s0.conv)[:, 2], ts.conv[:, 2].numpy())


def test_step_rows_and_chunked_prefill_match_jax(jspec, jparams, spec,
                                                 tparams):
    cfg = spec.config
    toks = np.array([[5, 9, 3, 17, 44, 2, 8, 11]], np.int32)
    jst = jssd.ssd_init_states(jspec.config, 1)
    tst = tssd.ssd_init_states(cfg, 1, device="cpu")
    for t in toks[0]:
        jl, jst = jssd.ssd_step_rows(jparams, jnp.asarray([t]), jst,
                                     jspec.config)
        tl, tst = tssd.ssd_step_rows(tparams, _t([t]), tst, cfg)
        assert _maxdiff(jl, tl) < MODEL_TOL
    assert _maxdiff(jst.ssm, tst.ssm) < MODEL_TOL
    # Masked stepping freezes the invalid row.
    _, frozen = tssd.ssd_step_rows_masked(tparams, _t([3]), tst,
                                          torch.tensor([False]), cfg)
    assert torch.equal(frozen.ssm, tst.ssm)
    jc, jcs = jssd.ssd_prefill_chunked(jparams, jnp.asarray(toks),
                                       jspec.config)
    tc, tcs = tssd.ssd_prefill_chunked(tparams, _t(toks), cfg)
    assert _maxdiff(jc, tc) < MODEL_TOL
    assert _maxdiff(jcs.ssm, tcs.ssm) < MODEL_TOL
    # Model-level duality: the chunked form against the recurrence.
    assert _maxdiff(tc, tl) < 1e-3
    assert _maxdiff(tcs.ssm, tst.ssm) < 1e-3
    assert _maxdiff(tcs.conv, tst.conv) < 1e-3


def test_state_layout_round_trip(spec):
    cfg = spec.config
    rng = np.random.default_rng(2)
    flat = _t(rng.standard_normal((cfg.n_layers, 3, tssd.ssd_state_dim(cfg)))
              .astype(np.float32))
    st = tssd.unflatten_states(flat, cfg)
    assert torch.equal(tssd.flatten_states(st), flat)
    jcfg = jcreate("ssd-small-test").config
    jst = jssd.unflatten_states(jnp.asarray(flat.numpy()), jcfg)
    assert np.array_equal(np.asarray(jst.ssm), st.ssm.numpy())
    assert np.array_equal(np.asarray(jst.conv), st.conv.numpy())
    assert jssd.ssd_state_dim(jcfg) == tssd.ssd_state_dim(cfg)


def test_oneshot_apply_matches_jax(jspec, jparams, spec, tparams):
    x = np.zeros((3, 16), np.float32)
    x[0, :5] = [5, 9, 3, 17, 44]
    x[1, :1] = [200]
    x[2, :16] = np.arange(1, 17)
    jo = jspec.apply(jparams, jnp.asarray(x))
    to = spec.apply(tparams, _t(x))
    assert _maxdiff(jo, to) < MODEL_TOL
    # Token ids past 256 stay exact on the wire (staged in f32).
    assert spec.token_input and tcreate("mamba2").token_input


def test_margin_prompts_clear_the_bound(jspec, jparams):
    """The stream tests' prompts: JAX's greedy continuation keeps a top-two
    logit margin above MARGIN at every step, so a port logit within
    MODEL_TOL picks the same token."""
    cfg = jspec.config
    step = jax.jit(lambda p, t, s: jssd.ssd_step_rows(p, t, s, cfg))
    margins = []
    for prompt in PROMPTS + [[5, 9, 3], [5, 9, 3, 11], [4, 8, 2, 6]]:
        st = jssd.ssd_init_states(cfg, 1)
        for t in prompt:
            lg, st = step(jparams, jnp.asarray([t]), st)
        for _ in range(20):
            top = np.sort(np.asarray(lg[0]))[-2:]
            margins.append(float(top[1] - top[0]))
            lg, st = step(jparams, jnp.asarray([int(np.argmax(lg[0]))]), st)
    assert min(margins) > MARGIN, min(margins)


# -- registry -----------------------------------------------------------------

def test_registry_declares_families_and_capabilities():
    # Every JAX registry name is ported (the MoE pair since its slice).
    assert available_models() == sorted(javailable())
    for name in available_models():
        m = tcreate(name)
        assert m.state_family in FAMILY_CAPABILITIES, name
        j = jcreate(name)
        assert m.state_family == j.state_family, name
        assert m.capabilities == j.capabilities, name
    ssd = tcreate("ssd-small-test")
    assert ssd.state_family == "state_slab"
    assert ssd.supports("mixed_step") and ssd.supports("migration")
    assert not ssd.supports("spec_decode") and not ssd.supports("paged_kv")
    assert ssd.tp_rule == jcreate("ssd-small-test").tp_rule
    m = tcreate("mamba2")
    cfg = m.config
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_heads,
            cfg.head_dim, cfg.d_state, cfg.d_conv, cfg.vocab) == (
        24, 768, 1536, 24, 64, 64, 4, 50257)
    # One stream's whole state: 24 x 102,912 f32.
    assert tssd.ssd_state_dim(cfg) == 102912


# -- the pool -----------------------------------------------------------------

def test_slab_pool_invariants():
    pool = StateSlabPool(2, 8, 4, device="cpu")
    assert pool.rows_free == 3  # row 0 is the null row
    with pytest.raises(ValueError):
        StateSlabPool(2, 8, 1, device="cpu")
    ids = [pool.alloc_row() for _ in range(3)]
    assert 0 not in ids and len(set(ids)) == 3
    with pytest.raises(PoolExhausted):
        pool.alloc_row()
    pool.release_row(ids[0])
    assert pool.rows_free == 1
    pool.release_row(0)  # null row release is a no-op
    assert pool.refcount(0) == 1
    st = pool.stats()
    assert st["rows_total"] == 3
    assert "not block-addressable" in st["prefix_sharing"]
    assert st["bytes_per_row"] == 2 * 8 * 4
    assert set(st) == set(JaxPool(2, 8, 4).stats())
    gen = pool.generation
    pool.reset()
    assert pool.generation == gen + 1 and pool.rows_free == 3


def test_slab_chain_refusals_before_allocation():
    pool = StateSlabPool(2, 8, 4, device="cpu")
    chain = pool.export_row_chain(pool.alloc_row())
    assert "state_dim" in StateSlabPool(2, 9, 4, device="cpu"
                                        ).chain_compatible(chain)
    assert "n_layers" in StateSlabPool(3, 8, 4, device="cpu"
                                       ).chain_compatible(chain)
    assert "exactly one pseudo-block" in pool.chain_compatible(
        dict(chain, blocks=[]))
    assert "payload" in pool.chain_compatible(
        dict(chain, blocks=[{"v": "aa"}]))
    truncated = dict(chain, blocks=[{"k": chain["blocks"][0]["k"][:8]}])
    assert "bytes" in pool.chain_compatible(truncated)
    assert not StateSlabPool.verify_chain(dict(chain, checksum=1))
    assert not StateSlabPool.verify_chain({"blocks": "garbage",
                                           "checksum": 0})
    # The refusals are the JAX pool's, message for message.
    jpool = JaxPool(2, 8, 4)
    for bad in (dict(chain, blocks=[]), dict(chain, state_dim=9),
                truncated):
        assert jpool.chain_compatible(bad) == pool.chain_compatible(bad)


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_slab_chain_crosses_packages_bit_exact(direction):
    flat = (np.arange(16, dtype=np.float32).reshape(2, 8) * 0.37
            - 1.1).astype(np.float32)
    tpool = StateSlabPool(2, 8, 4, device="cpu")
    jpool = JaxPool(2, 8, 4)
    if direction == "jax-to-torch":
        rid = jpool.alloc_row()
        jpool.slab = jpool.slab.at[:, rid].set(jnp.asarray(flat))
        chain = jpool.export_row_chain(rid)
        assert chain["dtype"] == "float32"
        assert tpool.chain_compatible(chain) is None
        assert tpool.verify_chain(chain)
        dst = tpool.alloc_row()
        tpool.import_row_chain(chain, dst)
        assert np.array_equal(tpool.slab[:, dst].numpy(), flat)
    else:
        rid = tpool.alloc_row()
        tpool.slab[:, rid] = _t(flat)
        chain = tpool.export_row_chain(rid)
        assert chain == dict(chain, dtype="float32", family="state_slab")
        assert jpool.chain_compatible(chain) is None
        assert JaxPool.verify_chain(chain)
        dst = jpool.alloc_row()
        jpool.import_row_chain(chain, dst)
        assert np.array_equal(np.asarray(jpool.slab[:, dst]), flat)


# -- the scheduler ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["two-path", "mixed"])
def test_streams_equal_jax(lanes, mode):
    """Greedy and seeded streams on the margin prompts, co-scheduled, equal
    the JAX scheduler's live streams of the same mode; the mixed lane's
    ticks equal its dispatches; no slab row leaks."""
    j, t = lanes["jax"], lanes[mode]
    want = j.generate(PROMPTS, max_new_tokens=14)
    got = t.generate(PROMPTS, max_new_tokens=14)
    assert got == want
    seeded = dict(max_new_tokens=10, temperature=0.8, seed=9)
    assert t.generate([PROMPTS[0]], **seeded) == j.generate([PROMPTS[0]],
                                                            **seeded)
    assert t.generate([PROMPTS[0]], **seeded) != t.generate(
        [PROMPTS[0]], **dict(seeded, seed=10))
    st = t.stats()
    if mode == "mixed":
        assert st["mixed"]["ticks"] == st["mixed"]["dispatches"] > 0
    else:
        assert st["chunks"] > 0
    assert "kv_pool" not in st and _leak_free(t)


@pytest.mark.parametrize("mode", ["two-path", "mixed"])
def test_penalty_and_stop_controls_equal_jax(lanes, mode):
    """Repetition penalty and stop tokens against JAX's live output. The
    stop token is one whose first occurrence in the plain stream is known,
    so the stopped stream is the plain one cut before it."""
    j, t = lanes["jax"], lanes[mode]
    prompt = [5, 9, 3]
    plain = t.generate([prompt], max_new_tokens=12)[0]
    assert plain == j.generate([prompt], max_new_tokens=12)[0]
    pen = t.generate([prompt], max_new_tokens=12, repetition_penalty=3.0)[0]
    assert pen == j.generate([prompt], max_new_tokens=12,
                             repetition_penalty=3.0)[0]
    assert pen != plain
    k = next(i for i in range(1, len(plain)) if plain[i] not in plain[:i])
    stopped = t.generate([prompt], max_new_tokens=12,
                         stop_tokens=[plain[k]])[0]
    assert stopped == plain[:k]
    assert stopped == j.generate([prompt], max_new_tokens=12,
                                 stop_tokens=[plain[k]])[0]


def test_replay_resume_equals_jax(lanes):
    """A replay resume (prompt ⧺ emitted, re-prefilled through the
    recurrence) continues as JAX's does, and as the unbroken stream."""
    j, t = lanes["jax"], lanes["two-path"]
    full = t.generate([[5, 9, 3]], max_new_tokens=20)[0]
    assert full == j.generate([[5, 9, 3]], max_new_tokens=20)[0]
    for cut in (1, 7, 13):
        resume = t.generate([[5, 9, 3] + full[:cut]],
                            max_new_tokens=len(full) - cut)[0]
        assert resume == full[cut:], cut


def test_deferred_admission_under_row_exhaustion(spec, tparams):
    gen = _tgen(spec, tparams, state_rows=3)  # 2 usable + null
    try:
        long_futs = [gen.submit([9, i], max_new_tokens=40)
                     for i in range(2)]
        deadline = time.monotonic() + 60
        while gen.stats()["active"] < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        late = [gen.submit([3 + i, 7], max_new_tokens=10) for i in range(2)]
        saw_pending = False
        while any(not f.done() for f in long_futs + late):
            saw_pending |= gen.stats()["state_pool"][
                "pending_admissions"] > 0
            time.sleep(0.001)
        assert saw_pending
        assert all(len(f.result(1)) == 40 for f in long_futs)
        assert all(len(f.result(1)) == 10 for f in late)
        st = gen.stats()["state_pool"]
        assert st["rows_total"] == 2 and st["rows_free"] == 2
        assert st["rows_admitted"] == st["rows_released"] == 4
    finally:
        gen.stop()


def test_deadline_cancel_releases_slab_row(lanes):
    t = lanes["two-path"]
    fut = t.submit([5, 9, 3], max_new_tokens=40,
                   deadline=Deadline.after_ms(40))
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=60)
    assert _leak_free(t)


@pytest.mark.parametrize("mode", ["two-path", "mixed"])
def test_migration_splice_equals_unmoved_stream(spec, tparams, jspec,
                                                jparams, mode):
    """A live row exported mid-stream and adopted by a second lane: the
    spliced stream equals the unmoved one (and JAX's), greedy and seeded,
    with the state_export and state_import spans, zero re-prefilled
    tokens and no leaked row. The port's chain also adopts on a JAX lane
    and continues there as JAX's own stream."""
    from tpu_engine_torch.utils.tracing import (
        SpanRecorder,
        TraceContext,
        TraceSink,
    )

    extra = MIXED if mode == "mixed" else {}
    a = _tgen(spec, tparams, **extra)
    b = _tgen(spec, tparams, **extra)
    jb = _jgen(jspec, jparams, **MIXED)
    try:
        for kw, tag in (({}, "m0"),
                        ({"temperature": 0.9, "seed": 17}, "m1")):
            control = a.generate([[5, 9, 3, 11]], max_new_tokens=18,
                                 **kw)[0]
            rec = SpanRecorder(256)
            ctx = TraceContext.root(tag)
            q = queue.Queue()
            a.submit([5, 9, 3, 11], max_new_tokens=18, stream=q, tag=tag,
                     sink=TraceSink(rec, "a", tag, ctx), **kw)
            got = _drain(q, until=5)
            snap = a.export_row(tag)
            assert snap["ok"], snap
            assert snap["chain"]["family"] == "state_slab"
            got = _drain(q, got)
            spliced = list(got)
            q2 = queue.Queue()
            fut = b.submit_import(snap, stream=q2,
                                  sink=TraceSink(rec, "b", tag, ctx))
            got = _drain(q2, got)
            assert got == control and fut.result(timeout=10) == control
            q3 = queue.Queue()
            jfut = jb.submit_import(snap, stream=q3)
            assert _drain(q3, spliced) == control
            assert jfut.result(timeout=30) == control
            ops = {s["op"] for s in rec.snapshot()}
            assert {"state_alloc", "state_export", "state_import"} <= ops
        for g in (a, b):
            assert _leak_free(g)
        assert a.stats()["migration"]["exported_rows"] == 2
        assert b.stats()["migration"]["imported_rows"] == 2
        assert b.stats()["state_pool"]["imports"] == 2
    finally:
        a.stop()
        b.stop()
        jb.stop()


def test_jax_chain_imports_into_port(spec, tparams, jspec, jparams):
    """A row exported by the JAX scheduler continues on the port's lane as
    the JAX stream does."""
    a = _jgen(jspec, jparams, **MIXED)
    b = _tgen(spec, tparams)
    try:
        control = a.generate([[4, 8, 2, 6]], max_new_tokens=16)[0]
        q = queue.Queue()
        a.submit([4, 8, 2, 6], max_new_tokens=16, stream=q, tag="x")
        got = _drain(q, until=4)
        snap = a.export_row("x")
        assert snap["ok"], snap
        got = _drain(q, got)
        q2 = queue.Queue()
        fut = b.submit_import(snap, stream=q2)
        assert _drain(q2, got) == control
        assert fut.result(timeout=30) == control
        assert _leak_free(b)
    finally:
        a.stop()
        b.stop()


def test_import_refusals_resolve_retryable(lanes, spec, tparams):
    a = lanes["two-path"]
    b = _tgen(spec, tparams)
    try:
        q = queue.Queue()
        a.submit([5, 9, 3], max_new_tokens=16, stream=q, tag="r0")
        _drain(q, until=4)
        snap = a.export_row("r0")
        assert snap["ok"]
        _drain(q)
        free0 = b.stats()["state_pool"]["rows_free"]
        with pytest.raises(ImportRefused, match="checksum"):
            b.submit_import(dict(snap, chain=dict(snap["chain"],
                                                  checksum=777))
                            ).result(timeout=30)
        with pytest.raises(ImportRefused, match="state_dim"):
            b.submit_import(dict(snap, chain=dict(snap["chain"],
                                                  state_dim=99))
                            ).result(timeout=30)
        assert b.stats()["state_pool"]["rows_free"] == free0
        assert b.stats()["migration"]["import_rejected"] == 2
    finally:
        b.stop()


@pytest.mark.parametrize("mode", ["two-path", "mixed"])
def test_handoff_hold_and_export(spec, tparams, mode):
    """A handoff row parks after its first token, exports at the first
    tick past its prefill (wait_prefill), and the decode lane's import
    gives the colocated stream; a cancelled hold decodes on locally."""
    extra = MIXED if mode == "mixed" else {}
    a = _tgen(spec, tparams, **extra)
    b = _tgen(spec, tparams, **extra)
    try:
        control = a.generate([[4, 8, 2, 6]], max_new_tokens=12)[0]
        q = queue.Queue()
        a.submit([4, 8, 2, 6], max_new_tokens=12, stream=q, tag="h0",
                 handoff=True, handoff_park_s=30.0)
        snap = a.export_row("h0", timeout_s=30.0, wait_prefill=True)
        assert snap["ok"], snap
        got = _drain(q)
        assert got == control[:len(got)] and len(got) >= 1
        fut = b.submit_import(snap, stream=(q2 := queue.Queue()))
        assert _drain(q2, got) == control
        assert fut.result(timeout=10) == control
        assert a.stats()["handoff"]["holds"] == 1
        f = a.submit([4, 8, 2, 6], max_new_tokens=12, tag="h1",
                     handoff=True, handoff_park_s=30.0)
        deadline = time.monotonic() + 30
        while (a.stats()["handoff"]["held_rows"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.005)
        res = a.export_row("h1", cancel=True)
        assert res["cancelled"], res
        assert f.result(timeout=30) == control
        for g in (a, b):
            assert _leak_free(g)
    finally:
        a.stop()
        b.stop()


def test_crash_recover_keeps_serving(spec, tparams):
    """A failed window scan recovers on the decode thread: the in-flight
    row fails retryable, the slab rebuilds clean, fresh streams serve as
    before."""
    gen = _tgen(spec, tparams)
    try:
        before = gen.generate([[5, 9, 3]], max_new_tokens=8)[0]
        real = gen._slab_forward
        calls = {"n": 0}

        def failing(*a, **k):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected device failure")
            return real(*a, **k)

        gen._slab_forward = failing
        fut = gen.submit([5, 9, 3], max_new_tokens=30)
        with pytest.raises(RuntimeError, match="device-step failure"):
            fut.result(timeout=60)
        gen._slab_forward = real
        assert _leak_free(gen)
        assert gen.stats().get("recover_invariant_violations", 0) == 0
        assert gen._spool.generation == 1  # rebuilt
        assert gen.generate([[5, 9, 3]], max_new_tokens=8)[0] == before
        assert gen.stats()["failures"] == 1
    finally:
        gen.stop()


def test_scheduler_family_fences(spec, tparams):
    def make(model=spec, **kw):
        return ContinuousGenerator(model, params=tparams if model is spec
                                   else None, device="cpu", **kw)

    with pytest.raises(ValueError,
                       match="state_slab family has no paged KV cache"):
        make(kv_block_size=16)
    with pytest.raises(ValueError, match="kv_quantize applies to"):
        make(kv_quantize="int8")
    with pytest.raises(ValueError, match="kv_host_blocks applies to"):
        make(kv_host_blocks=4)
    with pytest.raises(ValueError, match="requires the kv_paged family"):
        make(spec_k=2)
    with pytest.raises(RuntimeError, match="cannot serve tensor-parallel"):
        make(tp=2)
    with pytest.raises(ValueError,
                       match="state_rows applies to the state_slab"):
        make("gpt2-small-test", state_rows=8)
    # Prefix export and fingerprints refuse (no radix tree on the slab).
    gen = _tgen(spec, tparams)
    try:
        assert not gen.export_prefix([1, 2, 3])["ok"]
        assert gen.prefix_fingerprints() == []
    finally:
        gen.stop()


def test_state_pool_gated_and_stats_schema(lanes, spec):
    """state_pool appears on slab lanes only, with the JAX block's keys;
    the lane's stats keys equal the JAX slab lane's."""
    j = lanes["jax"].stats()
    for mode in ("two-path", "mixed"):
        t = lanes[mode].stats()
        assert "state_pool" in t and "kv_pool" not in t
        assert set(t["state_pool"]) == set(j["state_pool"])
        assert t["state_pool"]["state_dim"] == tssd.ssd_state_dim(
            spec.config)
        # Beside the JAX mixed lane's keys: the two-path lane's admission
        # dispatches and the blocks earlier tests' events created.
        assert set(t) - set(j) <= {"admission_dispatches", "migration",
                                   "handoff", "failures", "cancelled",
                                   "deadline_cancelled"}
    g = ContinuousGenerator("gpt2-small-test", n_slots=2, step_chunk=2,
                            kv_block_size=16, device="cpu")
    try:
        assert "state_pool" not in g.stats()
    finally:
        g.stop()


# -- the worker ---------------------------------------------------------------

def test_worker_family_fences(tparams):
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig

    def worker(**kw):
        return WorkerNode(WorkerConfig(node_id="x", device="cpu", **kw),
                          params=tparams if kw.get("model", "").startswith(
                              "ssd") else None)

    with pytest.raises(RuntimeError, match="state_slab-family models have "
                                           "no paged KV cache"):
        worker(model="ssd-small-test", gen_kv_block_size=16)
    with pytest.raises(RuntimeError,
                       match="--spec-k requires a kv_paged-family model"):
        worker(model="ssd-small-test", gen_continuous_spec_k=2)
    with pytest.raises(RuntimeError,
                       match="--state-rows applies to state_slab"):
        worker(model="gpt2-small-test", gen_state_rows=8)
    with pytest.raises(RuntimeError, match="--prefix-fetch requires"):
        worker(model="ssd-small-test", gen_prefix_fetch=True)


def test_worker_serves_generate_and_infer(jspec, jparams, spec, tparams):
    """A worker of the slab family serves /generate (the JAX worker's
    tokens), /infer (the JAX engine's logits), a dedicated role and
    /admin/role, with the JAX worker's /health schema and the
    tpu_engine_state_* families in /metrics, rendered as JAX renders the
    same /health."""
    from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
    from tpu_engine.serving.worker import WorkerNode as JaxWorker
    from tpu_engine.utils.config import WorkerConfig as JaxConfig
    from tpu_engine.utils.metrics import render_prometheus as jrender
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig
    from tpu_engine_torch.utils.metrics import render_prometheus

    lane = dict(gen_step_chunk=2, gen_prefill_chunk=8, gen_state_rows=6,
                gen_mixed_step=True, gen_mixed_token_budget=8)
    w = WorkerNode(WorkerConfig(node_id="s0", model="ssd-small-test",
                                dtype="float32", device="cpu",
                                role="decode", **lane), params=tparams)
    jw = JaxWorker(JaxConfig(node_id="s0", model="ssd-small-test",
                             dtype="float32", role="decode", **lane),
                   engine=JaxEngine(jspec, jparams, dtype="float32"))
    try:
        req = {"request_id": "r1", "prompt_tokens": [5, 9, 3],
               "max_new_tokens": 8}
        out = w.handle_generate(req)
        assert out["tokens"] == jw.handle_generate(req)["tokens"]
        x = [5.0, 9.0, 3.0, 17.0] + [0.0] * 12
        ti = w.handle_infer({"request_id": "i1", "input_data": x})
        ji = jw.handle_infer({"request_id": "i1", "input_data": x})
        assert _maxdiff(ti["output_data"], ji["output_data"]) < MODEL_TOL
        assert w.set_role("prefill")["role"] == "prefill"
        jw.set_role("prefill")
        h, jh = w.get_health(), jw.get_health()
        assert set(h) == set(jh)
        assert set(h["generator"]) == set(jh["generator"])
        assert h["generator"]["state_pool"]["rows_total"] == 5
        assert "kv_pool" not in h["generator"]
        body = render_prometheus([h]).decode()
        jbody = jrender([jh]).decode()
        for fam in ("tpu_engine_state_rows_total",
                    "tpu_engine_state_bytes_per_row",
                    "tpu_engine_state_rows_free"):
            lines = sorted(ln for ln in body.splitlines()
                           if ln.startswith(fam))
            assert lines and lines == sorted(
                ln for ln in jbody.splitlines() if ln.startswith(fam))
    finally:
        w.stop()
        jw.stop()


def test_slab_serving_subprocess_imports_no_jax():
    """A slab worker in a process of its own (mixed and two-path lanes,
    /generate and /infer): the family's modules load, and no jax or
    tpu_engine module does."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = (
        "import json, sys, urllib.request\n"
        "from tpu_engine_torch.serving.app import serve_worker\n"
        "from tpu_engine_torch.utils.config import WorkerConfig\n"
        "def post(port, path, body):\n"
        "    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',"
        " data=json.dumps(body).encode())\n"
        "    return json.loads(urllib.request.urlopen(req, timeout=60)"
        ".read())\n"
        "lens = []\n"
        "for lane in (dict(gen_mixed_step=True), {}):\n"
        "    w, s = serve_worker(WorkerConfig(port=0,"
        " model='ssd-small-test', dtype='float32', device='cpu',"
        " gen_prefill_chunk=8, **lane))\n"
        "    out = post(s.port, '/generate', {'request_id': 'a',"
        " 'prompt_tokens': [1, 2], 'max_new_tokens': 3})\n"
        "    inf = post(s.port, '/infer', {'request_id': 'b',"
        " 'input_data': [5.0, 9.0, 3.0]})\n"
        "    s.stop(); w.stop()\n"
        "    lens += [len(out['tokens']), len(inf['output_data'])]\n"
        "for m in ('tpu_engine_torch.models.ssd', 'tpu_engine_torch.ops.ssd'):"
        "\n    assert m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'lens': lens, 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "lens": [3, 256, 3, 256], "bad": []}


def test_gateway_hands_off_and_drains_slab_lanes(spec, tparams):
    """The port's gateway has no family branch: in front of slab workers
    (a prefill lane and a decode lane) a disagg request is handed off
    through /admin/migrate's wait_prefill and the decode lane's
    migrate_import, and a migrate-mode drain moves a live stream, each
    spliced stream equal to the colocated one with 0 replayed tokens."""
    import threading

    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.serving.gateway import Gateway, _parse_sse
    from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

    lane = dict(model="ssd-small-test", dtype="float32", device="cpu",
                gen_step_chunk=2, gen_prefill_chunk=8, gen_max_batch_size=4)
    served = [serve_worker(WorkerConfig(port=0, node_id=f"s{i}", role=r,
                                        **lane), params=tparams)
              for i, r in enumerate(("prefill", "decode"))]
    urls = [f"127.0.0.1:{s.port}" for _, s in served]
    prompt = [5, 9, 3, 17, 44, 2, 8]
    body = {"prompt_tokens": prompt, "max_new_tokens": 24}
    control = served[0][0].handle_generate(dict(body, request_id="c")
                                           )["tokens"]

    def consume(gw, req, on_tokens=None):
        toks, final = [], None
        for frame in gw.route_generate_stream(dict(req)):
            evt = _parse_sse(frame)
            if evt is None:
                continue
            if evt.get("done"):
                final = evt
                break
            toks.extend(evt.get("tokens", ()))
            if on_tokens is not None:
                on_tokens(toks)
        return toks, final

    try:
        gw = Gateway(urls, GatewayConfig(disagg=True,
                                         handoff_timeout_s=20.0))
        try:
            toks, final = consume(gw, dict(body, request_id="h1"))
            assert "error" not in final and toks == control
            assert gw.get_stats()["handoff"]["handoffs_spliced"] == 1
        finally:
            gw.stop()
        gw = Gateway(urls, GatewayConfig(failover_streams=True,
                                         migrate_streams=True,
                                         migrate_timeout_s=20.0))
        try:
            rid = next(f"d{i}" for i in range(2000)
                       if gw._ring.get_node(f"d{i}") == urls[0])
            armed = threading.Event()
            out = {}
            gen0 = served[0][0].generator
            orig = gen0._decode_chunk

            def slow():  # a drain must find the stream still running
                time.sleep(0.03)
                orig()
            gen0._decode_chunk = slow
            t = threading.Thread(target=lambda: out.update(res=consume(
                gw, dict(body, request_id=rid),
                lambda toks: len(toks) >= 3 and armed.set())))
            t.start()
            assert armed.wait(60)
            gw.remove_worker(urls[0], drain=True)
            t.join(timeout=60)
            gen0._decode_chunk = orig
            toks, final = out["res"]
            assert "error" not in final and toks == control
            st = gw.get_stats()
            assert st["migration"]["streams_migrated"] == 1
            assert st["failover"]["tokens_replayed"] == 0
        finally:
            gw.stop()
        for w, _ in served:
            assert _leak_free(w.generator)
    finally:
        for w, s in served:
            s.stop()
            w.stop()
