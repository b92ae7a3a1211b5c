"""Continuous speculation in the port's scheduler
(tpu_engine_torch.runtime.scheduler, ``spec_k`` > 0) against the JAX
package's ``ContinuousGenerator(spec_k=3)`` on the same weights (carried
across by models.convert) and against the port's own plain lane, on the
CPU: gpt2-small-test at max_seq 128, 16-token blocks, spec_k 3, f32.

- greedy streams equal JAX's and the plain lane's, token for token, in
  mixed and two-path mode over the f32 and the int8 pool, with penalties
  and stop lists, and with top_p/top_k at temperature > 0 (rows that are
  not drafted);
- drafted rows at temperature > 0 (the rejection rule) give JAX's tokens
  for the stated seeds; every draw on the way had a perturbed top-two
  margin above MARGIN (recorded here from the port's noise, which agrees
  with JAX's to about an ulp); the accept draws compare JAX's uniform
  bits with f32 probabilities that agree to an ulp;
- an oracle drafter advances a row k + 1 tokens per dispatch, an
  always-wrong one across a block edge leaks no block and leaves
  radix-shared prefixes intact, over-allocated horizon blocks return
  (``tail_blocks_released``), a stop on an accepted draft token counts as
  accepted, a deadline passing mid-speculation cancels the row between
  ticks, and ``dispatches == ticks`` throughout;
- for one request at a time the spec counters equal the JAX lane's;
- the worker over HTTP with ``gen_continuous_spec_k`` 3 (the n-gram
  drafter, and the model drafter with the auto draft) serves the plain
  lane's tokens with the JAX worker's ``spec`` schema, and refuses each
  misconfiguration with the JAX worker's message.
"""

import http.client
import json
import time

import jax
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime import scheduler as tsched
from tpu_engine_torch.runtime.generator import filter_logits
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.utils import prng
from tpu_engine_torch.utils.checkpoint import save_params
from tpu_engine_torch.utils.config import WorkerConfig
from tpu_engine_torch.utils.deadline import Deadline, DeadlineExceeded

_ensure_builtin_models_imported()

K = 3
KW = dict(dtype="float32", n_slots=4, step_chunk=4, max_seq=128,
          kv_block_size=16, prefill_chunk=16)
MODES = {"two-path": {}, "mixed": dict(mixed_step=True,
                                       mixed_token_budget=16),
         "two-path-int8": dict(kv_quantize="int8"),
         "mixed-int8": dict(mixed_step=True, mixed_token_budget=16,
                            kv_quantize="int8")}
PROMPTS = [[3, 3, 3], [5, 9, 3], [(i * 3) % 90 + 1 for i in range(15)],
           [1, 2, 3, 1, 2, 3, 1, 2]]
SHARED = [(i * 7) % 90 + 1 for i in range(16)]
MARGIN = 1e-4
SAMPLED_SEEDS = (5, 11)


@pytest.fixture(scope="module")
def params():
    return jcreate("gpt2-small-test", max_seq=128).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def spec():
    return tcreate("gpt2-small-test", max_seq=128)


@pytest.fixture(scope="module")
def tparams(params, spec):
    return convert.params_from_jax(jax.tree.map(np.asarray, params),
                                   spec.config, device="cpu")


@pytest.fixture(scope="module")
def lanes(params, spec, tparams):
    """mode -> (JAX spec lane, port spec lane, port plain lane), built on
    first use and stopped at the module's end."""
    built = {}

    def get(mode):
        if mode not in built:
            kw = dict(KW, **MODES[mode])
            built[mode] = (
                JaxGen(jcreate("gpt2-small-test", max_seq=128),
                       params=params, spec_k=K, **kw),
                ContinuousGenerator(spec, params=tparams, device="cpu",
                                    spec_k=K, **kw),
                ContinuousGenerator(spec, params=tparams, device="cpu",
                                    **kw))
        return built[mode]
    yield get
    for gens in built.values():
        for g in gens:
            g.stop()


class _StubDrafter:
    """A drafter driven by a known stream: its continuation after the
    tokens emitted so far, or each of those tokens plus one (always
    wrong)."""

    name = "stub"
    dispatches = 0

    def __init__(self, stream, prompt_len, wrong=False, vocab=256):
        self.stream = list(stream)
        self.plen = prompt_len
        self.wrong = wrong
        self.vocab = vocab

    def propose(self, ctx, k):
        n_emitted = len(ctx) - self.plen
        cont = self.stream[n_emitted:n_emitted + k]
        if self.wrong:
            cont = [(t + 1) % self.vocab for t in cont]
        return cont


def _with_drafter(gen, drafter, fn):
    old = gen._drafter
    gen._drafter = drafter
    try:
        return fn()
    finally:
        gen._drafter = old


def _wait_idle(g, timeout=20.0):
    deadline = time.time() + timeout
    while True:
        st = g.stats()
        pool = st["kv_pool"]
        if (st["active"] == 0 and pool["blocks_free"] + pool["radix_nodes"]
                == pool["blocks_total"]) or time.time() > deadline:
            return st
        time.sleep(0.01)


def _check_counters(st):
    sp = st["spec"]
    assert sp["ticks"] == sp["dispatches"]
    assert sp["accepted_tokens"] <= sp["proposed_tokens"]
    if "mixed" in st:
        assert st["mixed"]["ticks"] == st["mixed"]["dispatches"] \
            == sp["ticks"]


# (prompts, generate kwargs): an all-greedy batch without controls, and
# one whose rows carry a penalty, a stop list, and top_k or top_p at
# temperature > 0 (rows that are not drafted).
BATCHES = (
    (PROMPTS, dict(eos_id=50)),
    (PROMPTS + [[3, 3, 3], SHARED],
     dict(repetition_penalty=[1.0, 1.3, 1.0, 1.2, 1.0, 1.0],
          stop_tokens=[[], [], [7], [40, 41], [], []],
          temperature=[0.0, 0.0, 0.0, 0.0, 0.8, 0.7],
          seed=[0, 0, 0, 0, 5, 9], top_k=[0, 0, 0, 0, 5, 0],
          top_p=[1.0, 1.0, 1.0, 1.0, 1.0, 0.9])),
)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_match_jax_and_the_plain_lane(lanes, mode):
    """Greedy rows (with controls) and undrafted sampled rows (top_p,
    top_k): the JAX spec lane's tokens and the plain lane's."""
    jgen, tgen, plain = lanes(mode)
    for prompts, kw in BATCHES:
        want = plain.generate(prompts, max_new_tokens=16, **kw)
        assert tgen.generate(prompts, max_new_tokens=16, **kw) == want, kw
        assert jgen.generate(prompts, max_new_tokens=16, **kw) == want, kw
    st = _wait_idle(tgen)
    _check_counters(st)
    sp = st["spec"]
    assert sp["proposed_tokens"] > 0 and sp["accepted_tokens"] > 0
    assert sp["tokens_per_row_dispatch"] >= 1.0
    pool = st["kv_pool"]
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]
    assert bool(pool.get("quantized")) == ("int8" in mode)


@pytest.mark.parametrize("mode", ["two-path", "mixed"])
def test_drafted_sampled_rows_match_jax(lanes, mode, monkeypatch):
    """Temperature-0.8 rows that are drafted take the rejection rule:
    JAX's tokens for SAMPLED_SEEDS, and not (in general) the plain
    lane's. Every sampling and residual draw of the port's run is
    recorded with its perturbed top-two margin, which must exceed
    MARGIN."""
    jgen, tgen, plain = lanes(mode)
    margins = []

    def top2(x):
        t = torch.topk(x, 2, dim=-1).values
        return (t[..., 0] - t[..., 1]).tolist()

    real_sample, real_cat = tsched._sample, tsched.tagged_categorical

    def sample(logits, seeds, positions, temps, topps, topks, minps):
        rows = np.nonzero(np.asarray(temps) > 0)[0]
        if rows.size:
            idx = torch.as_tensor(rows)
            lg = filter_logits(
                logits[idx], torch.as_tensor(np.asarray(temps)[rows]),
                torch.as_tensor(np.asarray(topps)[rows]),
                torch.as_tensor(np.asarray(topks)[rows]),
                torch.as_tensor(np.asarray(minps)[rows]))
            key = prng.fold_in(prng.prng_key(torch.as_tensor(seeds)[idx]),
                               torch.as_tensor(positions)[idx])
            margins.extend(top2(lg + prng.gumbel(key, lg.shape[-1])))
        return real_sample(logits, seeds, positions, temps, topps, topks,
                           minps)

    def categorical(seeds, positions, tag, log_probs):
        key = prng.fold_in(prng.fold_in(prng.prng_key(seeds), positions),
                           torch.full_like(positions, tag))
        margins.extend(top2(log_probs + prng.gumbel(key,
                                                    log_probs.shape[-1])))
        return real_cat(seeds, positions, tag, log_probs)

    monkeypatch.setattr(tsched, "_sample", sample)
    monkeypatch.setattr(tsched, "tagged_categorical", categorical)
    before = tgen.stats()["spec"]
    for seed in SAMPLED_SEEDS:
        kw = dict(max_new_tokens=20, temperature=0.8, seed=seed)
        got = tgen.generate(PROMPTS, **kw)
        assert got == jgen.generate(PROMPTS, **kw), seed
        assert all(0 <= t < 256 for row in got for t in row)
    sp = tgen.stats()["spec"]
    assert sp["proposed_tokens"] > before["proposed_tokens"]
    assert len(margins) > 100 and min(margins) > MARGIN


def test_oracle_drafter_advances_k_plus_one_per_dispatch(lanes):
    jgen, tgen, plain = lanes("two-path")
    want = plain.generate([[3, 3, 3]], max_new_tokens=24)[0]
    deltas = []
    for gen in (tgen, jgen):
        before = gen.stats()["spec"]
        got = _with_drafter(gen, _StubDrafter(want, 3), lambda: gen.generate(
            [[3, 3, 3]], max_new_tokens=24)[0])
        assert got == want
        st = gen.stats()["spec"]
        deltas.append({k: st[k] - before[k] for k in (
            "ticks", "dispatches", "proposed_tokens", "accepted_tokens",
            "emitted_tokens", "row_ticks")})
    d = deltas[0]
    assert deltas[0] == deltas[1]
    # 23 tokens after the first: five ticks of k + 1, then the last 3.
    assert d["emitted_tokens"] == 23 and d["ticks"] == d["dispatches"] == 6
    assert d["accepted_tokens"] == d["proposed_tokens"] == 5 * K + 2


def test_rejecting_drafter_across_a_block_edge(lanes):
    """An always-wrong draft over a 31-token prompt whose first 16 tokens
    are radix-shared: each window verifies one token and leaves a rejected
    tail that crosses the block edge at column 32 on the first tick.
    Streams stay the plain lane's, a second prompt on the shared block
    takes the radix hit with the same tokens, every block comes back, and
    a 12-token prompt with a 3-token budget returns the block its
    admission reserved for the horizon."""
    jgen, tgen, plain = lanes("two-path")
    prompts = [SHARED + [(i * 5) % 90 + 1 for i in range(15)],
               SHARED + [(i * 11) % 90 + 1 for i in range(15)]]
    hits = []
    for prompt in prompts:
        want = plain.generate([prompt], max_new_tokens=10)[0]
        hits.append(tgen.stats()["kv_pool"]["prefix_hit_tokens"])
        for gen in (tgen, jgen):
            got = _with_drafter(
                gen, _StubDrafter(want, len(prompt), wrong=True),
                lambda: gen.generate([prompt], max_new_tokens=10)[0])
            assert got == want
    assert tgen.stats()["kv_pool"]["prefix_hit_tokens"] >= hits[1] + 16
    released = tgen.stats()["spec"]["tail_blocks_released"]
    short = [(i * 13) % 90 + 1 for i in range(12)]
    want = plain.generate([short], max_new_tokens=3)[0]
    for gen in (tgen, jgen):
        assert _with_drafter(
            gen, _StubDrafter(want, 12, wrong=True),
            lambda: gen.generate([short], max_new_tokens=3)[0]) == want
    assert tgen.stats()["spec"]["tail_blocks_released"] == released + 1
    st = _wait_idle(tgen)
    pool = st["kv_pool"]
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]
    _check_counters(st)
    assert not tgen._tables.any()


def test_stop_on_an_accepted_draft_token_counts_as_accepted(lanes):
    """A stream that stops ON an accepted draft token has no corrected
    slot: n_acc counted on the device includes that last slot."""
    jgen, tgen, plain = lanes("mixed")
    want = plain.generate([[5, 9, 3]], max_new_tokens=24)[0]
    j = next(i for i in (1, 2, 3) if want[i] not in want[:i])
    kw = dict(max_new_tokens=24, stop_tokens=[want[j]])
    assert plain.generate([[5, 9, 3]], **kw)[0] == want[:j]
    for gen in (tgen, jgen):
        before = gen.stats()["spec"]["accepted_tokens"]
        got = _with_drafter(gen, _StubDrafter(want, 3), lambda: gen.generate(
            [[5, 9, 3]], **kw)[0])
        assert got == want[:j]
        assert gen.stats()["spec"]["accepted_tokens"] - before == j


def test_deadline_mid_speculation_cancels_between_ticks(lanes):
    jgen, tgen, plain = lanes("two-path")
    want = plain.generate([[5, 9, 3]], max_new_tokens=4)[0]
    futs = [tgen.submit([(i * 17 + j) % 90 + 1 for j in range(40)],
                        max_new_tokens=80, deadline=Deadline.after_ms(30))
            for i in range(4)]
    expired = 0
    for f in futs:
        try:
            f.result(60)
        except DeadlineExceeded as exc:
            expired += 1
            assert "deadline" in str(exc)
    assert expired >= 1
    st = _wait_idle(tgen)
    pool = st["kv_pool"]
    assert st["active"] == 0
    assert pool["blocks_free"] + pool["radix_nodes"] == pool["blocks_total"]
    assert st["deadline_cancelled"] >= expired
    _check_counters(st)
    assert tgen.generate([[5, 9, 3]], max_new_tokens=4)[0] == want
    assert jgen.generate([[5, 9, 3]], max_new_tokens=4)[0] == want


@pytest.mark.parametrize("mode", ["two-path", "mixed-int8"])
def test_counters_of_one_request_at_a_time_equal_jax(lanes, mode):
    jgen, tgen, _ = lanes(mode)
    keys = ("proposed_tokens", "accepted_tokens", "emitted_tokens",
            "row_ticks")
    for prompt, kw in ((PROMPTS[0], {}), (PROMPTS[3], {}),
                       (PROMPTS[2], dict(repetition_penalty=1.2)),
                       (SHARED * 2, dict(stop_tokens=[40]))):
        deltas = []
        for gen in (tgen, jgen):
            before = gen.stats()["spec"]
            out = gen.generate([prompt], max_new_tokens=18, **kw)[0]
            _wait_idle(gen)
            st = gen.stats()["spec"]
            deltas.append((out, {k: st[k] - before[k] for k in keys}))
        assert deltas[0] == deltas[1], prompt


def test_spec_lane_refusals(spec, tparams):
    """Speculation needs the paged pool and a window that fits; state_rows
    refuses on this family (the JAX scheduler's message) and tensor
    parallelism still refuses as unported; a spec lane builds with the
    host tier."""
    for kw, match in ((dict(spec_k=2, kv_block_size=0),
                       "requires the paged KV cache"),
                      (dict(spec_k=127), "cannot fit a verify window"),
                      (dict(spec_k=2, spec_draft="ngrma"),
                       "unknown drafter kind"),
                      (dict(spec_k=2, spec_draft="model",
                            spec_draft_model="gpt2-chaos-test"),
                       "draft vocab 1024 != target vocab 256")):
        with pytest.raises(ValueError, match=match):
            ContinuousGenerator(spec, params=tparams, device="cpu",
                                **dict(KW, **kw))
    with pytest.raises(ValueError,
                       match="state_rows applies to the state_slab family"):
        ContinuousGenerator(spec, params=tparams, device="cpu", spec_k=2,
                            **dict(KW, state_rows=2))
    # Tensor parallelism is ported: tp beside a single `device` refuses
    # (the JAX scheduler's message), and a tp 2 spec lane builds on its
    # ranks' devices.
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousGenerator(spec, params=tparams, device="cpu", spec_k=2,
                            **dict(KW, tp=2))
    sharded = ContinuousGenerator(spec, params=tparams, spec_k=2,
                                  tp_devices=["cpu"] * 2, **dict(KW, tp=2))
    try:
        assert sharded.stats()["spec"]["k"] == 2
        assert sharded.stats()["kv_pool"]["tp"] == 2
    finally:
        sharded.stop()
    # The host tier is ported: a spec lane builds with it.
    tiered = ContinuousGenerator(spec, params=tparams, device="cpu",
                                 spec_k=2, **dict(KW, kv_host_blocks=4))
    try:
        assert tiered.stats()["kv_pool"]["host"]["blocks_total"] == 4
        assert tiered.stats()["spec"]["k"] == 2
    finally:
        tiered.stop()


# -- the worker --------------------------------------------------------------

WORKER_LANE = dict(gen_kv_block_size=16, gen_prefill_chunk=16,
                   gen_continuous_spec_k=K)


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def jax_spec_keys():
    jw = JaxWorker(JaxWorkerConfig(model="gpt2-small-test", dtype="float32",
                                   **WORKER_LANE))
    try:
        jw.handle_generate({"request_id": "a", "prompt_tokens": [3, 3, 3],
                            "max_new_tokens": 8})
        return set(jw.get_health()["generator"]["spec"])
    finally:
        jw.stop()


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_worker_serves_a_spec_lane_like_jax(jax_spec_keys, draft, capsys):
    cfg = WorkerConfig(port=0, node_id="spec_1", model="gpt2-small-test",
                       dtype="float32", device="cpu",
                       gen_spec_draft=draft, gen_mixed_step=True,
                       gen_mixed_token_budget=16, **WORKER_LANE)
    worker, srv = serve_worker(cfg)
    plain = ContinuousGenerator("gpt2-small-test", device="cpu",
                                **dict(KW, max_seq=None))
    try:
        if draft == "model":
            assert "randomly initialized" in capsys.readouterr().out
        for prompt in ([3, 3, 3], [1, 2, 3, 1, 2, 3, 1]):
            status, out = _post(srv.port, "/generate", {
                "request_id": "r", "prompt_tokens": prompt,
                "max_new_tokens": 12})
            assert status == 200
            assert out["tokens"] == plain.generate([prompt],
                                                   max_new_tokens=12)[0]
        for st in (_get(srv.port, "/health"), worker.get_health()):
            sp = st["generator"]["spec"]
            assert set(sp) == jax_spec_keys
            assert sp["ticks"] == sp["dispatches"] > 0
            assert sp["k"] == K and sp["draft"] == draft
        if draft == "model":
            assert sp["draft_dispatches"] > 0
            assert worker.generator._drafter.spec.name == "gpt2-small-test"
    finally:
        srv.stop()
        worker.stop()
        plain.stop()


@pytest.mark.parametrize("overrides", [
    dict(gen_kv_block_size=0),
    dict(gen_continuous_spec_k=63),
    dict(gen_spec_draft="ngrma"),
    dict(model="llama-small-test", gen_spec_draft="model"),
    dict(gen_spec_draft="model", gen_draft_model="gpt2-chaos-test"),
], ids=["no-paged-cache", "k-too-deep", "bad-drafter", "no-draft-model",
        "vocab-mismatch"])
def test_worker_misconfiguration_raises_the_jax_message(overrides):
    kw = dict(dict(model="gpt2-small-test", dtype="float32", **WORKER_LANE),
              **overrides)
    with pytest.raises(RuntimeError) as want:
        JaxWorker(JaxWorkerConfig(**kw)).stop()
    with pytest.raises(RuntimeError) as got:
        serve_worker(WorkerConfig(port=0, device="cpu", **kw))
    assert str(got.value) == str(want.value)


def test_worker_refuses_draft_weights_by_name(tmp_path, capsys):
    """gen_draft_path feeds the model drafter, as in the JAX worker: a
    path to nothing gives a random draft with the JAX warning, a
    checkpoint of the port's format gives the drafter its weights. The
    name is older than this behaviour: the worker once refused the
    option by name, and the test keeps its id."""
    lane = dict(port=0, model="gpt2-small-test", dtype="float32",
                device="cpu", gen_spec_draft="model", **WORKER_LANE)
    worker, srv = serve_worker(WorkerConfig(gen_draft_path="/nonexistent",
                                            **lane))
    try:
        assert "'gpt2-small-test' is randomly initialized (no " \
            "gen_draft_path)" in capsys.readouterr().out
        saved = worker.engine.params
    finally:
        srv.stop()
        worker.stop()
    save_params(str(tmp_path / "draft"), saved)
    worker, srv = serve_worker(WorkerConfig(
        gen_draft_path=str(tmp_path / "draft"), **lane))
    try:
        assert "randomly initialized" not in capsys.readouterr().out
        got = worker.generator._drafter.params
        assert torch.equal(got["blocks"][1]["mlp"]["proj"]["kernel"],
                           saved["blocks"][1]["mlp"]["proj"]["kernel"])
        status, out = _post(srv.port, "/generate", {
            "request_id": "r", "prompt_tokens": [3, 3, 3],
            "max_new_tokens": 12})
        assert status == 200 and len(out["tokens"]) == 12
        # The draft is the target: every proposal is accepted.
        sp = worker.get_health()["generator"]["spec"]
        assert sp["accepted_tokens"] == sp["proposed_tokens"] > 0
    finally:
        srv.stop()
        worker.stop()
