"""One-shot rows of the port's continuous scheduler (submit_infer,
submit_score; tpu_engine_torch.runtime.scheduler) on the CPU, against the
port's engine and the JAX package's scorer on the same weights.

- /infer rows equal the engine's batch_predict rows for the same
  co-batched inputs, bit for bit (the tick's dispatch is that call);
- /score rows equal the JAX Generator.score on llama-small-test and
  gpt2-small-test (f32, 1e-4 of each log-probability's magnitude, at
  least 1e-5: the same forward summed in another order);
- the stateless counters balance; an expired deadline is dropped before
  dispatch; a failing dispatch fails its group only;
- a stateless model's lane refuses the generative knobs with the JAX
  scheduler's messages, and generation with its message;
- decode streams on a decoder lane are token-identical with and without
  one-shot rows riding beside them."""

import threading
import time

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.generator import Generator as JaxGenerator
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.engine import InferenceEngine
from tpu_engine_torch.runtime.generator import Scorer
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.utils.deadline import Deadline, DeadlineExceeded

_ensure_builtin_models_imported()


class RecordingEngine(InferenceEngine):
    """The engine, recording each batch it was given; a batch holding a
    NaN fails, as a device error would."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.batches = []

    def batch_submit(self, inputs, shapes=None):
        if any(np.isnan(np.asarray(x, np.float32)).any() for x in inputs):
            raise RuntimeError("device error in this batch")
        self.batches.append([np.asarray(x, np.float32) for x in inputs])
        return super().batch_submit(inputs, shapes=shapes)


@pytest.fixture
def mlp_lane():
    eng = RecordingEngine("mlp", dtype="float32", device="cpu",
                          batch_buckets=(1, 2, 4, 8))
    gen = ContinuousGenerator(tcreate("mlp"), params=eng.params,
                              dtype="float32", n_slots=8, prefix_cache_mb=0,
                              infer_engine=eng, device="cpu")
    yield eng, gen
    gen.stop()


def test_infer_rows_equal_the_engines_batched_rows(mlp_lane):
    eng, gen = mlp_lane
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal(int(rng.integers(2, 16))).tolist()
              for _ in range(20)]
    futs = [gen.submit_infer(x) for x in inputs]
    outs = [f.result(timeout=30) for f in futs]
    assert all(us >= 1 for _row, us in outs)
    by_input = {np.asarray(x, np.float32).tobytes(): row
                for x, (row, _us) in zip(inputs, outs)}
    groups = list(eng.batches)
    assert sum(len(b) for b in groups) == 20
    for batch in groups:  # each co-batched group, replayed
        want = eng.batch_predict(batch)
        for x, w in zip(batch, want):
            assert np.array_equal(by_input[x.tobytes()], w)
    st = gen.stats()["stateless"]
    assert st["infer_rows"] == 20 and st["score_rows"] == 0
    assert st["ticks"] == st["dispatches"] == len(groups)
    assert st["admitted"] == st["completed"] == 20 and st["failed"] == 0


def test_expired_deadline_is_dropped_before_dispatch(mlp_lane):
    eng, gen = mlp_lane
    late = Deadline.after_ms(0)
    time.sleep(0.002)
    with pytest.raises(DeadlineExceeded, match="before one-shot dispatch"):
        gen.submit_infer([1.0], deadline=late).result(timeout=30)
    ok = gen.submit_infer([1.0], deadline=Deadline.after_ms(60000))
    assert ok.result(timeout=30)[0].shape == (16,)
    st = gen.stats()
    assert st["stateless"]["deadline_dropped"] == 1
    assert st["deadline_cancelled"] == 1
    # Submitted = completed + failed + dropped; a dropped row is never
    # admitted.
    s = st["stateless"]
    assert s["admitted"] == s["completed"] + s["failed"] == 1
    assert len(eng.batches) == 1


def test_failing_dispatch_fails_its_group_only(mlp_lane):
    eng, gen = mlp_lane
    bad = gen.submit_infer([float("nan"), 1.0])
    with pytest.raises(RuntimeError, match="device error in this batch"):
        bad.result(timeout=30)
    assert gen.submit_infer([2.0, 1.0]).result(timeout=30)[0].shape == (16,)
    st = gen.stats()["stateless"]
    assert st["failed"] == 1 and st["completed"] == 1
    assert st["admitted"] == st["completed"] + st["failed"]
    assert st["ticks"] == st["dispatches"] == 2
    assert gen.stats()["active"] == 0


def test_stateless_lane_refuses_generation_and_scoring(mlp_lane):
    _eng, gen = mlp_lane
    jgen = JaxGen(jcreate("mlp"), dtype="float32", n_slots=2,
                  prefix_cache_mb=0, infer_engine=object())
    try:
        for call in (lambda g: g.submit([1, 2]),
                     lambda g: g.submit_score([1], [2])):
            with pytest.raises(RuntimeError) as want:
                call(jgen)
            with pytest.raises(RuntimeError) as got:
                call(gen)
            assert str(got.value) == str(want.value)
    finally:
        jgen.stop()
    assert gen.accepts_oneshot and not gen.accepts_score


@pytest.mark.parametrize("knobs", [
    dict(kv_block_size=16), dict(kv_blocks=64), dict(kv_quantize="int8"),
    dict(spec_k=2), dict(mixed_step=True), dict(state_rows=4)],
    ids=["kv-block-size", "kv-blocks", "kv-quantize", "spec-k",
         "mixed-step", "state-rows"])
def test_stateless_fences_match_jax(knobs):
    with pytest.raises(ValueError) as want:
        JaxGen(jcreate("mlp"), dtype="float32", **knobs)
    with pytest.raises(ValueError) as got:
        ContinuousGenerator(tcreate("mlp"), dtype="float32", device="cpu",
                            **knobs)
    assert str(got.value) == str(want.value)


def test_submit_infer_needs_an_engine():
    gen = ContinuousGenerator("gpt2-small-test", dtype="float32",
                              device="cpu", n_slots=2)
    try:
        assert not gen.accepts_oneshot and not gen.accepts_score
        assert "stateless" not in gen.stats()
        with pytest.raises(RuntimeError, match="requires an infer_engine"):
            gen.submit_infer([1.0])
        with pytest.raises(RuntimeError, match="requires a score_provider"):
            gen.submit_score([1], [2])
    finally:
        gen.stop()


# -- /score against the JAX scorer -------------------------------------------

SCORE_ROWS = [([5, 9, 3], [7, 1, 2]), ([], [4, 4]),
              ([(i * 7) % 90 + 1 for i in range(20)], [3, 8, 9, 10]),
              ([11] * 40, [12] * 9), ([1], [2])]


@pytest.mark.parametrize("name", ["llama-small-test", "gpt2-small-test"])
def test_submit_score_matches_jax_generator_score(name):
    jspec = jcreate(name)
    jparams = jspec.init(jax.random.PRNGKey(1))
    want = JaxGenerator(jspec, params=jparams, dtype="float32").score(
        [p for p, _ in SCORE_ROWS], [c for _, c in SCORE_ROWS])
    spec = tcreate(name)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), spec.config,
                              device="cpu")
    scorer = Scorer(spec, params=tparams, dtype="float32", device="cpu")
    gen = ContinuousGenerator(spec, params=tparams, dtype="float32",
                              n_slots=4, device="cpu",
                              score_provider=lambda: scorer)
    try:
        futs = [gen.submit_score(p, c) for p, c in SCORE_ROWS]
        got = [f.result(timeout=60)[0] for f in futs]
        st = gen.stats()["stateless"]
    finally:
        gen.stop()
    for g, w, (_p, c) in zip(got, want, SCORE_ROWS):
        assert len(g) == len(w) == len(c)
        g, w = np.asarray(g), np.asarray(w)
        assert np.all(np.abs(g - w) <= np.maximum(1e-4 * np.abs(w), 1e-5))
    assert st["score_rows"] == len(SCORE_ROWS) and st["failed"] == 0
    assert st["admitted"] == st["completed"] == len(SCORE_ROWS)
    # Over-long rows refuse with the JAX scorer's message.
    long = ([1] * 60, [2] * 10)
    with pytest.raises(ValueError) as jerr:
        JaxGenerator(jspec, params=jparams, dtype="float32").score(*[
            [x] for x in long])
    with pytest.raises(ValueError) as terr:
        scorer.score(*[[x] for x in long])
    assert str(terr.value) == str(jerr.value)


# -- decode streams beside one-shot rows --------------------------------------

@pytest.mark.parametrize("lane", [
    {}, dict(kv_block_size=16, mixed_step=True, mixed_token_budget=16,
             prefill_chunk=16)], ids=["dense", "mixed"])
def test_decode_streams_unchanged_by_oneshot_rows(lane):
    spec = tcreate("gpt2-small-test")
    eng = InferenceEngine(spec, dtype="float32", device="cpu", rng_seed=3,
                          batch_buckets=(1, 2, 4))
    scorer = Scorer(spec, params=eng.params, dtype="float32", device="cpu")
    prompts = [[5, 9, 3], [(i * 7) % 90 + 1 for i in range(30)], [8] * 12]
    plain = ContinuousGenerator(spec, params=eng.params, dtype="float32",
                                n_slots=4, device="cpu", **lane)
    try:
        want = [plain.generate([p], max_new_tokens=8)[0] for p in prompts]
    finally:
        plain.stop()
    gen = ContinuousGenerator(spec, params=eng.params, dtype="float32",
                              n_slots=4, device="cpu", infer_engine=eng,
                              score_provider=lambda: scorer, **lane)
    stop = threading.Event()
    oneshots = []

    def flood():
        i = 0
        while not stop.is_set():
            oneshots.append(gen.submit_infer([float(i % 50 + 1)] * 4))
            oneshots.append(gen.submit_score([i % 50 + 1], [3, 4]))
            i += 1
            time.sleep(0.002)

    t = threading.Thread(target=flood)
    t.start()
    try:
        futs = [gen.submit(p, max_new_tokens=8) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
    finally:
        stop.set()
        t.join(timeout=30)
    try:
        assert not t.is_alive()
        assert all(f.result(timeout=60) for f in oneshots)
        st = gen.stats()
    finally:
        gen.stop()
    assert got == want
    s = st["stateless"]
    assert s["infer_rows"] > 0 and s["score_rows"] > 0
    assert s["admitted"] == s["completed"] == len(oneshots)
    assert s["ticks"] <= s["dispatches"] <= 2 * s["ticks"]
