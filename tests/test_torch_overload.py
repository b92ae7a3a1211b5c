"""Overload control in the port (tpu_engine_torch.serving.overload, the
tiered and adaptive AdmissionController, the scheduler's brownout, the
worker's wiring and flags) against the JAX package's, on the CPU:

- parse_priority, tier_limit and load_retry_after give the same answers;
  TenantRateLimiter, AIMDLimit, BrownoutController and SheddingStats fed
  the same event sequences on the same fake clock give the same
  decisions, hints, stages and as_dict() after every step;
- AdmissionController with tier fractions and an AIMD limiter sheds the
  same requests in the same order, with the same causes and messages,
  and reports the same as_dict();
- ContinuousGenerator (gpt2-small-test, f32, 16-token blocks) in mixed,
  two-path and speculative mode under the same set_brownout stages gives
  JAX's greedy streams and JAX's stats()["brownout"], spec suspension
  stops proposals, and the budget floor keeps admission moving;
- the worker with priority_admission, adaptive_depth and brownout sheds,
  clamps and reports /health as JAX's does, its brownout thread walks the
  ladder from its own signals and stops with the worker, and a
  defaults-only worker's /health and a defaults-only gateway's /stats
  keep JAX's key sets (the priority and tenant fields ignored);
- the worker command's overload flags reach WorkerConfig.
Comparisons are exact."""

import random
import re
import time
import types

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine.serving import overload as jov
from tpu_engine.serving import resilience as jres
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving import overload as tov
from tpu_engine_torch.serving import resilience as tres
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import WorkerConfig

_ensure_builtin_models_imported()


class FakeClock:
    """A monotonic clock both packages' modules read (``module.time``)."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    for mod in (jov, tov, jres, tres):
        monkeypatch.setattr(mod, "time", fake)
    return c


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # compared across the packages
        return (type(exc).__name__, getattr(exc, "cause", None),
                re.sub(r"\d+", "N", str(exc)))


# -- pure decisions -----------------------------------------------------------

@pytest.mark.parametrize("payload", [
    {}, {"priority": "background"}, {"priority": "batch"},
    {"priority": "interactive"}, {"priority": "urgent"}, {"priority": 2},
    {"prority": "background"}])
def test_parse_priority_matches_jax(payload):
    assert _outcome(lambda: tov.parse_priority(payload)) == \
        _outcome(lambda: jov.parse_priority(payload))
    assert tov.TIER_NAMES == jov.TIER_NAMES
    assert tov.TIER_ADMIT_FRAC == jov.TIER_ADMIT_FRAC
    assert tov.BROWNOUT_STAGES == jov.BROWNOUT_STAGES
    assert tov.BROWNOUT_BUDGET_FRAC == jov.BROWNOUT_BUDGET_FRAC


def test_tier_limit_and_retry_after_match_jax():
    for limit in range(0, 40):
        for tier in (-1, 0, 1, 2, 3):
            assert tov.tier_limit(limit, tier) == jov.tier_limit(limit, tier)
        for frac in (0.0, 0.5, 0.7, 0.85, 1.0):
            assert tres.tier_cap(limit, frac) == jres.tier_cap(limit, frac)
    for base in (0.5, 1.0, 3.0):
        for p in (-2.0, 0.0, 0.3, 1.0, 4.0, 100.0, 1e9):
            assert tov.load_retry_after(base, p) == \
                jov.load_retry_after(base, p)


@pytest.mark.parametrize("rate,burst", [(1.0, 2.0), (5.0, 0.0),
                                        (0.5, 0.0), (20.0, 3.0)])
def test_tenant_rate_limiter_matches_jax(clock, rate, burst):
    port = tov.TenantRateLimiter(rate, burst, idle_evict_s=30.0)
    ref = jov.TenantRateLimiter(rate, burst, idle_evict_s=30.0)
    assert (port.rate, port.burst) == (ref.rate, ref.burst)
    rng = random.Random(int(rate * 10 + burst))
    for _ in range(400):
        clock.now += rng.choice((0.0, 0.01, 0.1, 0.5, 2.0, 40.0))
        tenant = f"t{rng.randrange(70)}"
        assert port.allow(tenant) == ref.allow(tenant)
        assert port.tenants() == ref.tenants()


@pytest.mark.parametrize("kw", [dict(), dict(start=4, max_limit=16),
                                dict(min_limit=2, max_limit=8,
                                     cooldown_s=0.0, min_samples=3),
                                dict(tolerance=1.2, decrease=0.5)])
def test_aimd_limit_matches_jax(clock, kw):
    port, ref = tov.AIMDLimit(**kw), jov.AIMDLimit(**kw)
    rng = random.Random(len(kw))
    for i in range(300):
        clock.now += rng.choice((0.01, 0.3, 1.5))
        lat = rng.choice((0.05, 0.06, 0.08, 0.3, 1.0))
        port.observe(lat)
        ref.observe(lat)
        assert port.as_dict() == ref.as_dict()
        assert port.limit == ref.limit
    assert port.as_dict()["increases"] > 0
    assert port.as_dict()["decreases"] > 0


@pytest.mark.parametrize("seed", range(3))
def test_brownout_controller_matches_jax(seed):
    port, ref = tov.BrownoutController(), jov.BrownoutController()
    rng = random.Random(seed)
    moves = 0
    for _ in range(400):
        comps = {name: rng.choice((0.0, 0.2, 0.6, 0.9, 1.5))
                 for name in rng.sample(("queue_depth", "tick_age",
                                         "pool_pending", "deadline_miss"),
                                        rng.randrange(0, 4))}
        # Runs of the same pressure let the ladder move.
        for _ in range(rng.choice((1, 2, 5))):
            a, b = port.evaluate(comps), ref.evaluate(comps)
            assert a == b
            moves += a is not None
            assert port.as_dict() == ref.as_dict()
            assert port.stage == ref.stage
    assert moves > 0
    for low, high in ((0.9, 0.5), (-0.1, 0.5), (0.5, 0.5)):
        with pytest.raises(ValueError, match="low"):
            tov.BrownoutController(high=high, low=low)


def test_shedding_stats_and_counters_match_jax(clock):
    port, ref = tov.SheddingStats(window_s=5.0), jov.SheddingStats(5.0)
    rng = random.Random(3)
    for _ in range(200):
        clock.now += rng.choice((0.1, 0.5, 3.0))
        shed = rng.random() < 0.3
        port.record(shed)
        ref.record(shed)
        assert port.pressure() == ref.pressure()
    assert tov.OverloadCounters.FIELDS == jov.OverloadCounters.FIELDS
    assert tres.FailoverCounters.FIELDS == jres.FailoverCounters.FIELDS
    c = tov.OverloadCounters()
    assert not c.any_nonzero() and set(c.as_dict()) == set(c.FIELDS)


@pytest.mark.parametrize("window", [8, 20, 512])
def test_latency_tracker_matches_jax(window):
    port, ref = tres.LatencyTracker(window), jres.LatencyTracker(window)
    rng = random.Random(window)
    assert port.quantile(0.5) is ref.quantile(0.5) is None
    for _ in range(300):
        v = rng.choice((0.01, 0.02, 0.5)) * rng.random()
        port.record(v)
        ref.record(v)
        assert len(port) == len(ref)
        for q in (0.0, 0.1, 0.5, 0.95, 1.0):
            assert port.quantile(q) == ref.quantile(q)


# -- admission ----------------------------------------------------------------

def _admission_pair(max_depth, tiered, adaptive):
    fr_t = tov.TIER_ADMIT_FRAC if tiered else None
    fr_j = jov.TIER_ADMIT_FRAC if tiered else None
    lim_t = (tov.AIMDLimit(max_limit=12, start=max_depth or None,
                           min_samples=3, cooldown_s=0.0)
             if adaptive else None)
    lim_j = (jov.AIMDLimit(max_limit=12, start=max_depth or None,
                           min_samples=3, cooldown_s=0.0)
             if adaptive else None)
    return (tres.AdmissionController(max_depth, "lane", fr_t, lim_t),
            jres.AdmissionController(max_depth, "lane", fr_j, lim_j))


@pytest.mark.parametrize("tiered,adaptive", [(True, False), (False, True),
                                             (True, True)])
@pytest.mark.parametrize("max_depth", [1, 5, 10])
def test_tiered_adaptive_admission_matches_jax(clock, tiered, adaptive,
                                               max_depth):
    port, ref = _admission_pair(max_depth, tiered, adaptive)
    assert port.active == ref.active is True
    rng = random.Random(max_depth * 4 + tiered * 2 + adaptive)
    sheds = []
    for _ in range(400):
        r = rng.random()
        if r < 0.55:
            tier = rng.choice((None, 0, 1, 2))
            a = _outcome(lambda: port.admit(tier=tier))
            b = _outcome(lambda: ref.admit(tier=tier))
            assert a == b
            if a[0] != "ok":
                sheds.append((tier, a[1]))
        elif r < 0.85:
            if port.depth:
                port.release()
                ref.release()
        elif adaptive:
            clock.now += 0.5
            lat = rng.choice((0.05, 0.06, 0.5))
            port.limiter.observe(lat)
            ref.limiter.observe(lat)
        assert port.as_dict() == ref.as_dict()
        assert port.effective_limit() == ref.effective_limit()
    d = port.as_dict()
    assert d["shed_overloaded"] == (d["shed_depth"] + d["shed_tier"]
                                    + d["shed_adaptive"]) > 0
    if tiered and max_depth >= 5:
        # Lowest tier first: background sheds at least as often as batch,
        # and only the top tier is never shed for its tier.
        causes = [t for t, cause in sheds if cause == "tier"]
        assert causes and 2 not in causes and None not in causes
        assert causes.count(0) >= causes.count(1)


def test_plain_admission_keeps_its_schema():
    port, ref = _admission_pair(4, False, False)
    assert set(port.as_dict()) == set(ref.as_dict()) == {
        "draining", "queue_depth", "max_queue_depth", "shed_overloaded",
        "shed_deadline", "shed_draining"}
    port.admit()
    ref.admit()
    assert port.admit(tier=0) is ref.admit(tier=0) is None  # untiered


# -- the scheduler's brownout -------------------------------------------------

SCHED_KW = dict(dtype="float32", n_slots=2, max_seq=128, kv_block_size=16,
                prefill_chunk=16)
SCHED_MODES = {"mixed": dict(mixed_step=True, mixed_token_budget=16),
               "two-path": dict(step_chunk=4),
               "mixed-spec": dict(mixed_step=True, mixed_token_budget=16,
                                  spec_k=2)}
STAGES = [dict(), dict(budget_frac=0.5), dict(budget_frac=0.5,
                                              suspend_spec=True),
          dict(budget_frac=0.5, suspend_spec=True, defer_swap_in=True),
          dict(budget_frac=0.0001, suspend_spec=True)]
BO_PROMPTS = [[5, 9, 3, 5, 9, 3, 5, 9], [(i * 7) % 90 + 1 for i in range(37)]]


@pytest.fixture(scope="module")
def sched_pair():
    jspec = jcreate("gpt2-small-test", max_seq=128)
    params = jspec.init(jax.random.PRNGKey(0))
    spec = tcreate("gpt2-small-test", max_seq=128)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      spec.config, device="cpu")
    built = {}

    def get(mode):
        if mode not in built:
            kw = dict(SCHED_KW, **SCHED_MODES[mode])
            built[mode] = (JaxGen(jspec, params=params, **kw),
                           ContinuousGenerator(spec, params=tparams,
                                               device="cpu", **kw))
        return built[mode]
    yield get
    for gens in built.values():
        for g in gens:
            g.stop()


@pytest.mark.parametrize("mode", sorted(SCHED_MODES))
def test_brownout_stages_match_jax(sched_pair, mode):
    jgen, tgen = sched_pair(mode)
    base = None
    for stage in STAGES:
        for g in (jgen, tgen):
            g.set_brownout(**stage)
        try:
            assert tgen.stats().get("brownout") == \
                jgen.stats().get("brownout")
            if mode != "two-path":
                assert tgen._effective_mixed_budget() == \
                    jgen._effective_mixed_budget()
            assert (tgen._swap_reserve() == tgen._pool.num_blocks) is \
                bool(stage.get("defer_swap_in"))
            p0 = tgen.stats().get("spec", {}).get("proposed_tokens")
            got = tgen.generate(BO_PROMPTS, max_new_tokens=10)
            assert got == jgen.generate(BO_PROMPTS, max_new_tokens=10)
            if base is None:
                base = got
            # Every stage changes the work's shape, never the stream.
            assert got == base
            if mode == "mixed-spec":
                moved = tgen.stats()["spec"]["proposed_tokens"] - p0
                assert (moved == 0) is bool(stage.get("suspend_spec"))
        finally:
            for g in (jgen, tgen):
                g.set_brownout()
    assert "brownout" not in tgen.stats()


@pytest.mark.parametrize("frac,want", [(1.0, [15, 0]), (0.5, [7, 0]),
                                       (0.25, [3, 0]), (0.0001, [1, 0])])
def test_brownout_budget_shrinks_the_prefill_chunks(sched_pair, frac, want):
    """The tick's prefill tokens: the budget scaled by the fraction, less
    one per decode row, floored at 1; the chunk cap (the ragged batch's
    width) stays."""
    _jgen, tgen = sched_pair("mixed")
    row_l, row_w0 = tgen._row_L, tgen._row_w0
    tgen._row_L, tgen._row_w0 = [40, 40], [0, 0]
    tgen.set_brownout(budget_frac=frac)
    try:
        chunk = tgen._prefill_chunks([0, 1], 1)
        assert chunk.tolist() == want and tgen._chunk_cap == 16
        assert tgen._effective_mixed_budget() == max(1, int(16 * frac))
    finally:
        tgen.set_brownout()
        tgen._row_L, tgen._row_w0 = row_l, row_w0


# -- the worker ---------------------------------------------------------------

MLP = dict(model="mlp", dtype="float32", batch_buckets=(1, 2))


def _worker_pair(**kw):
    return (WorkerNode(WorkerConfig(device="cpu", **MLP, **kw)),
            JaxWorker(JaxWorkerConfig(**MLP, **kw)))


def _infer(w, rid, **extra):
    return _outcome(lambda: w.handle_infer(
        {"request_id": rid, "input_data": [1.0, 2.0], **extra})["node_id"])


def test_worker_tiered_admission_matches_jax():
    tw, jw = _worker_pair(node_id="ov1", max_queue_depth=4,
                          priority_admission=True)
    try:
        for w in (tw, jw):
            for _ in range(3):  # hold 3 of 4 slots (past 70%)
                w._admission.admit()
        for rid, extra in (("x", {"priority": "background"}),
                           ("y", {"priority": "batch"}), ("z", {}),
                           ("q", {"priority": "now"})):
            assert _infer(tw, rid, **extra) == _infer(jw, rid, **extra)
        adm_t = tw.get_health()["admission"]
        adm_j = jw.get_health()["admission"]
        assert adm_t == adm_j
        assert adm_t["shed_tier"] == 2 and adm_t["shed_overloaded"] == 2
    finally:
        for w in (tw, jw):
            for _ in range(3):
                w._admission.release()
            w.stop()


def test_worker_adaptive_depth_matches_jax():
    tw, jw = _worker_pair(node_id="ov2", adaptive_depth=True,
                          adaptive_depth_max=16, max_queue_depth=4)
    try:
        assert tw._aimd.limit == jw._aimd.limit == 4
        for i in range(3):
            for w in (tw, jw):
                w.handle_infer({"request_id": f"r{i}",
                                "input_data": [1.0, float(i)]})
        adm_t, adm_j = (w.get_health()["admission"] for w in (tw, jw))
        assert adm_t == adm_j
        assert adm_t["adaptive"] == {"limit": 4, "min": 1, "max": 16,
                                     "increases": 0, "decreases": 0}
        assert len(tw._aimd._tracker) == len(jw._aimd._tracker) == 3
    finally:
        tw.stop()
        jw.stop()


def test_worker_brownout_clamp_and_health_match_jax():
    tw, jw = _worker_pair(node_id="ov3", brownout=True,
                          brownout_clamp_tokens=8)
    try:
        clamp = tov.BROWNOUT_STAGES.index("clamp")
        for w in (tw, jw):
            assert w._brownout_clamp(100, 0) == 100
            w._brownout._stage = clamp
        for args in ((100, 0), (100, 1), (100, tov.TOP_TIER), (4, 0),
                     (100, None)):
            assert tw._brownout_clamp(*args) == jw._brownout_clamp(*args)
        bt, bj = (w.get_health()["brownout"] for w in (tw, jw))
        assert bt == bj and bt["clamped_requests"] == 2
        assert bt["stage"] == clamp
        # The priority field is validated with brownout on.
        assert _infer(tw, "p", priority="soon") == \
            _infer(jw, "p", priority="soon")
    finally:
        tw.stop()
        jw.stop()
    assert tw._brownout_thread is None and tw._brownout_stop.is_set()


def test_worker_brownout_loop_walks_the_ladder():
    """The control thread reads the lane's own signals: a full queue
    escalates stage by stage into the scheduler's degradations, and an
    idle lane restores them in reverse."""
    spec = tcreate("gpt2-small-test", max_seq=128)
    w = WorkerNode(WorkerConfig(
        node_id="ov5", model="gpt2-small-test", dtype="float32",
        device="cpu", gen_kv_block_size=16, gen_mixed_step=True,
        gen_mixed_token_budget=16, gen_prefill_chunk=16,
        max_queue_depth=2, brownout=True, brownout_interval_s=0.05))
    try:
        assert spec.name == w.engine.spec.name
        stages = []
        for _ in range(2):
            w._admission.admit()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            stages.append(w._brownout.stage)
            if stages[-1] >= 3:
                break
            time.sleep(0.02)
        assert stages[-1] >= 3
        bo = w.generator.stats()["brownout"]
        assert bo == {"budget_frac": 0.5, "spec_suspended": True,
                      "swap_in_deferred": True}
        assert w.get_health()["brownout"]["binding_signal"] == "queue_depth"
        for _ in range(2):
            w._admission.release()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and w._brownout.stage:
            stages.append(w._brownout.stage)
            time.sleep(0.02)
        stages.append(w._brownout.stage)
        assert stages[-1] == 0 and "brownout" not in w.generator.stats()
        # One stage at a time, up then down.
        steps = [b - a for a, b in zip(stages, stages[1:]) if b != a]
        assert set(steps) <= {1, -1}
        h = w.get_health()["brownout"]
        assert h["escalations"] == h["restores"] >= 3
    finally:
        w.stop()


def test_defaults_only_worker_health_keeps_jax_keys():
    tw, jw = _worker_pair()
    try:
        for w in (tw, jw):
            w.handle_infer({"request_id": "a", "input_data": [1.0],
                            "priority": "bogus", "tenant": "T"})
        ht, hj = tw.get_health(), jw.get_health()
        # The same body as JAX's (and as before overload control): the
        # fields are ignored, no admission or brownout block appears.
        assert ht == hj
        assert set(ht) == {"healthy", "node_id", "model", "total_requests",
                           "cache_hits", "cache_size", "cache_hit_rate",
                           "batch_processor"}
    finally:
        tw.stop()
        jw.stop()


def test_worker_overload_flags_reach_the_config(monkeypatch):
    seen = {}

    def fake_serve(cfg, params=None, warmup=False):
        seen["cfg"] = cfg
        raise SystemExit(0)

    import tpu_engine_torch.serving.app as app
    monkeypatch.setattr(app, "serve_worker", fake_serve)
    with pytest.raises(SystemExit):
        cli.main(["worker", "8001", "w1", "mlp", "--device", "cpu",
                  "--priority-admission", "--adaptive-depth", "--brownout",
                  "--brownout-clamp-tokens", "12"])
    cfg = seen["cfg"]
    assert (cfg.priority_admission, cfg.adaptive_depth, cfg.brownout,
            cfg.brownout_clamp_tokens) == (True, True, True, 12)
    with pytest.raises(SystemExit):
        cli.main(["worker", "8001", "w1", "mlp", "--device", "cpu"])
    d = WorkerConfig()
    cfg = seen["cfg"]
    assert (cfg.priority_admission, cfg.adaptive_depth, cfg.brownout,
            cfg.brownout_clamp_tokens) == (False, False, False,
                                           d.brownout_clamp_tokens)
    jd = JaxWorkerConfig()
    for f in ("priority_admission", "adaptive_depth", "adaptive_depth_max",
              "brownout", "brownout_interval_s", "brownout_clamp_tokens"):
        assert getattr(d, f) == getattr(jd, f), f
