"""The port worker's batch lanes (``gen_scheduler`` "batch" and
"speculative", tpu_engine_torch.serving.worker) against the JAX worker's on
the same weights, on the CPU in f32 (gpt2-small-test):

- /generate through each lane's batcher (``gen_decode_fused`` off and
  on, against JAX's chunked and fused loops; greedy, seeded top_p, a
  repetition penalty with stops, EOS) gives the JAX lane's tokens, and a
  batch of items through ``_process_gen_batch`` (grouped by eos_id, a
  beam item alone, each row cut to its own budget) gives JAX's results;
- /generate/stream on a batch lane is one ``tokens`` event and the
  ``done`` event (an error: the terminal error event; a draining lane:
  503 before the 200);
- beam requests: width 4 served as JAX serves it; a width over 8, a beam
  with sampling controls, a non-finite length_penalty and a beam on a
  continuous or speculative lane are 400s with JAX's messages; the
  speculative lane's top_p/top_k/min_p/penalty requests are 400s before
  they join a batch or a stream commits;
- draft weights from ``gen_draft_path``: an HF directory written here
  (seeded) gives the JAX lane's tokens and spec counters, a checkpoint of
  the port's format with the target's own weights is a perfect draft;
- the guards that need the continuous scheduler, an encoder and the
  state_slab family refuse as JAX refuses;
- /health's generator block (JAX's keys; the ``spec`` block and its
  /metrics lines on the speculative lane), the /admin handlers that need
  a continuous scheduler, a reload reaching the batch lane, an
  int8-weight batch lane, the CLI flags, and a batch-lane worker_node in
  a process of its own with no jax in its sys.modules.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
from tpu_engine.serving import worker as jworker
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import WorkerConfig as JaxConfig
from tpu_engine.utils.metrics import render_prometheus as jax_render
from tpu_engine_torch.models import convert
from tpu_engine_torch.runtime.generator import Generator
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving import worker as tworker
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.checkpoint import SIDECAR, save_params
from tpu_engine_torch.utils.config import WorkerConfig
from tpu_engine_torch.utils.deadline import ShedError
from tpu_engine_torch.utils.metrics import render_prometheus

_ensure_builtin_models_imported()

REPO = Path(__file__).resolve().parent.parent
MODEL = "gpt2-small-test"
K = 3
REQUESTS = [
    {"prompt_tokens": [5, 9, 3, 17], "max_new_tokens": 12},
    {"prompt_tokens": [7, 1, 44, 2, 90, 13], "max_new_tokens": 10,
     "temperature": 0.8, "seed": 5, "top_p": 0.9},
    {"prompt_tokens": [3, 3, 3], "max_new_tokens": 12,
     "repetition_penalty": 1.2, "stop_tokens": [54, 11]},
    {"prompt_tokens": list(range(2, 22)), "max_new_tokens": 14,
     "eos_id": 54},
]


@pytest.fixture(scope="module")
def weights():
    jp = jcreate(MODEL).init(jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                       jcreate(MODEL).config, device="cpu",
                                       dtype="float32")


def _pair(weights, quantize=None, **lane):
    """A JAX worker and a port worker of one lane on the same weights."""
    jp, tp = weights
    jw = JaxWorker(JaxConfig(node_id="b0", model=MODEL, dtype="float32",
                             quantize=quantize, **lane),
                   engine=JaxEngine(MODEL, jp, dtype="float32",
                                    quantize=quantize))
    try:
        tw = WorkerNode(WorkerConfig(node_id="b0", model=MODEL,
                                     dtype="float32", device="cpu",
                                     quantize=quantize, **lane),
                        params=tp)
    except BaseException:
        jw.stop()
        raise
    if getattr(jw.generator, "draft_params", None) is not None \
            and not lane.get("gen_draft_path"):
        # Both random drafts as JAX drew its own (the port's seeded init
        # draws other numbers).
        tw.generator.draft_params = convert.params_from_jax(
            jax.tree.map(np.asarray, jw.generator.draft_params),
            tw.generator.dcfg, device="cpu", dtype="float32")
    return jw, tw


def _stop(*workers):
    for w in workers:
        w.stop()


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
def test_batch_lane_generate_matches_jax(weights, fused):
    jw, tw = _pair(weights, gen_scheduler="batch", gen_decode_fused=fused)
    try:
        assert isinstance(tw.generator, Generator)
        for i, req in enumerate(REQUESTS):
            body = dict(req, request_id=f"g{i}")
            want = jw.handle_generate(dict(body))
            got = tw.handle_generate(dict(body))
            assert got["tokens"] == want["tokens"]
            assert set(got) == set(want)
        # One batch of items: grouped by eos_id, the beam item alone, each
        # row cut to its own max_new_tokens.
        specs = [dict(REQUESTS[0], eos_id=-1),
                 dict(REQUESTS[1], max_new_tokens=5),
                 dict(REQUESTS[3]),
                 dict(REQUESTS[0], beam_width=3, max_new_tokens=6)]

        def items(mod):
            return [mod._GenItem(
                request_id=f"p{i}", prompt=s["prompt_tokens"],
                max_new_tokens=s["max_new_tokens"],
                eos_id=s.get("eos_id", -1),
                temperature=s.get("temperature", 0.0),
                seed=s.get("seed", 0), top_p=s.get("top_p", 1.0),
                beam_width=s.get("beam_width", 1))
                for i, s in enumerate(specs)]
        want = [r.tokens for r in jw._process_gen_batch(items(jworker))]
        got = [r.tokens for r in tw._process_gen_batch(items(tworker))]
        assert got == want
        assert len(got[1]) == 5
    finally:
        _stop(jw, tw)


def _events(chunks):
    return [json.loads(c[len(b"data: "):]) for c in chunks]


def test_batch_lane_stream_is_one_shot(weights, monkeypatch):
    jw, tw = _pair(weights, gen_scheduler="batch")
    try:
        body = dict(REQUESTS[2], request_id="s1")
        want = _events(jw.handle_generate_stream(dict(body)))
        got = _events(tw.handle_generate_stream(dict(body)))
        assert [sorted(e) for e in got] == [sorted(e) for e in want]
        assert len(got) == 2 and got[1]["done"]
        assert got[0]["tokens"] == got[1]["tokens"] == want[1]["tokens"]
        assert got[1]["tokens"] == tw.handle_generate(dict(body))["tokens"]
        # A fault inside the lane: the terminal error event, retryable.
        monkeypatch.setattr(tw.generator, "generate", lambda *a, **k: (
            _ for _ in ()).throw(RuntimeError("device lost")))
        (ev,) = _events(tw.handle_generate_stream(dict(body)))
        assert ev["done"] and ev["error"] == "device lost"
        assert ev["retryable"] and ev["tokens_emitted"] == 0
        # A draining lane sheds before the stream commits.
        tw.drain()
        with pytest.raises(ShedError):
            tw.handle_generate_stream(dict(body))
    finally:
        _stop(jw, tw)


def _message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


BEAM_BAD = [dict(beam_width=9), dict(beam_width=2, temperature=0.5),
            dict(beam_width=2, stop_tokens=[4]),
            dict(beam_width=2, length_penalty=math.nan),
            dict(beam_width=2, length_penalty=11.0)]


def test_beam_requests_on_the_batch_lane(weights):
    jw, tw = _pair(weights, gen_scheduler="batch")
    try:
        body = {"request_id": "bm", "prompt_tokens": [5, 9, 3, 17],
                "max_new_tokens": 10, "beam_width": 4,
                "length_penalty": 0.7}
        assert tw.handle_generate(dict(body))["tokens"] == \
            jw.handle_generate(dict(body))["tokens"]
        for bad in BEAM_BAD:
            req = dict(body, **bad)
            for call in ("handle_generate", "handle_generate_stream"):
                assert _message(lambda: getattr(tw, call)(dict(req))) == \
                    _message(lambda: getattr(jw, call)(dict(req)))
    finally:
        _stop(jw, tw)


@pytest.mark.parametrize("lane", [
    dict(), dict(gen_kv_block_size=16, gen_prefill_chunk=16),
    dict(gen_scheduler="speculative", gen_spec_k=K)],
    ids=["dense", "paged", "speculative"])
def test_beam_needs_the_batch_lane(weights, lane):
    jw, tw = _pair(weights, **lane)
    try:
        req = {"request_id": "bm", "prompt_tokens": [1, 2],
               "beam_width": 2}
        msg = _message(lambda: tw.handle_generate(dict(req)))
        assert msg == "beam_width > 1 needs gen_scheduler=batch"
        assert msg == _message(lambda: jw.handle_generate(dict(req)))
    finally:
        _stop(jw, tw)


def test_speculative_lane_matches_jax_and_refuses_filters(weights):
    jw, tw = _pair(weights, gen_scheduler="speculative", gen_spec_k=K)
    try:
        for i, req in enumerate((REQUESTS[0], REQUESTS[3],
                                 dict(REQUESTS[0], temperature=0.8,
                                      seed=4))):
            body = dict(req, request_id=f"q{i}")
            assert tw.handle_generate(dict(body))["tokens"] == \
                jw.handle_generate(dict(body))["tokens"]
        assert tw.get_health()["generator"]["spec"] == \
            jw.get_health()["generator"]["spec"]
        for bad in (dict(top_p=0.9), dict(top_k=4), dict(min_p=0.2),
                    dict(repetition_penalty=1.3)):
            req = dict(REQUESTS[0], request_id="bad", **bad)
            before = tw._gen_processor.get_metrics().as_dict()
            for call in ("handle_generate", "handle_generate_stream"):
                assert _message(lambda: getattr(tw, call)(dict(req))) == \
                    _message(lambda: getattr(jw, call)(dict(req)))
            # Refused before joining a batch.
            assert tw._gen_processor.get_metrics().as_dict() == before
    finally:
        _stop(jw, tw)


@pytest.fixture(scope="module")
def hf_draft(tmp_path_factory):
    """An HF GPT-2 directory at gpt2-small-test's geometry, seeded."""
    transformers = pytest.importorskip("transformers")
    cfg = jcreate(MODEL).config
    hf = transformers.GPT2Config(
        vocab_size=cfg.vocab, n_positions=cfg.max_seq, n_embd=cfg.d_model,
        n_layer=cfg.n_layers, n_head=cfg.n_heads, n_inner=cfg.d_ff,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(3)
    path = tmp_path_factory.mktemp("hf_draft")
    transformers.GPT2LMHeadModel(hf).eval().save_pretrained(str(path))
    return str(path)


def test_draft_weights_from_an_hf_directory(weights, hf_draft, capsys):
    lane = dict(gen_scheduler="speculative", gen_spec_k=K,
                gen_draft_model=MODEL, gen_draft_path=hf_draft)
    jw, tw = _pair(weights, **lane)
    try:
        assert "randomly initialized" not in capsys.readouterr().out
        for i, req in enumerate((REQUESTS[0], dict(REQUESTS[3],
                                                   temperature=0.8))):
            body = dict(req, request_id=f"h{i}")
            assert tw.handle_generate(dict(body))["tokens"] == \
                jw.handle_generate(dict(body))["tokens"]
        assert tw.generator.last_stats == jw.generator.last_stats
        assert tw.get_health()["generator"]["spec"] == \
            jw.get_health()["generator"]["spec"]
    finally:
        _stop(jw, tw)


def test_draft_weights_from_a_port_checkpoint(weights, tmp_path):
    """The target's own weights as the draft, saved in the port's format
    (the train command's <out>/params): every proposal is accepted."""
    _, tp = weights
    save_params(str(tmp_path / "params"), tp)
    (tmp_path / "params" / SIDECAR).write_text(json.dumps({"model": MODEL}))
    w = WorkerNode(WorkerConfig(
        node_id="d0", model=MODEL, dtype="float32", device="cpu",
        gen_scheduler="speculative", gen_spec_k=K,
        gen_draft_path=str(tmp_path / "params")), params=tp)
    try:
        got = w.handle_generate(dict(REQUESTS[0], request_id="p"))["tokens"]
        plain = Generator(MODEL, params=tp, dtype="float32", device="cpu")
        assert got == plain.generate([REQUESTS[0]["prompt_tokens"]],
                                     max_new_tokens=12)[0]
        assert w.generator.last_stats["mean_tokens_per_round"] > 0.9 * K
    finally:
        w.stop()


@pytest.mark.parametrize("scheduler", ["batch", "speculative"])
@pytest.mark.parametrize("overrides", [
    dict(gen_continuous_spec_k=2),
    dict(gen_kv_block_size=16, gen_kv_host_blocks=8),
    dict(gen_kv_quantize="int8"),
    dict(gen_kv_block_size=16, gen_prefix_fetch=True),
    dict(role="decode"),
    dict(model="ssd-small-test"),
], ids=["spec-k", "host-tier", "kv-quantize", "prefix-fetch", "role",
        "state-slab"])
def test_guards_carry_the_jax_message(weights, scheduler, overrides):
    kw = dict(dict(model=MODEL, dtype="float32", gen_scheduler=scheduler,
                   gen_spec_k=K), **overrides)
    with pytest.raises(RuntimeError) as want:
        JaxWorker(JaxConfig(**kw)).stop()
    with pytest.raises(RuntimeError) as got:
        WorkerNode(WorkerConfig(device="cpu", **kw)).stop()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("scheduler", ["batch", "speculative"])
def test_encoder_lane_does_not_generate(scheduler):
    kw = dict(model="bert-small-test", dtype="float32",
              gen_scheduler=scheduler)
    jw = JaxWorker(JaxConfig(**kw))
    tw = WorkerNode(WorkerConfig(device="cpu", **kw))
    try:
        assert tw.generator is None
        req = {"request_id": "e", "prompt_tokens": [1, 2]}
        assert _message(lambda: tw.handle_generate(dict(req))) == \
            _message(lambda: jw.handle_generate(dict(req)))
    finally:
        _stop(jw, tw)


def _spec_lines(render, health):
    text = render([health]).decode()
    return [ln for ln in text.splitlines() if "tpu_engine_spec_" in ln]


@pytest.mark.parametrize("scheduler", ["batch", "speculative"])
def test_health_metrics_and_admin_on_batch_lanes(weights, scheduler):
    jw, tw = _pair(weights, gen_scheduler=scheduler, gen_spec_k=K)
    try:
        body = dict(REQUESTS[0], request_id="m")
        jw.handle_generate(dict(body))
        tw.handle_generate(dict(body))
        jh, th = jw.get_health(), tw.get_health()
        assert set(th) == set(jh)
        assert set(th["generator"]) == set(jh["generator"])
        assert th["generator"]["prompt_buckets"] == \
            jh["generator"]["prompt_buckets"]
        assert tw.latency_histograms() == {} == jw.latency_histograms()
        assert _spec_lines(render_prometheus, th) == \
            _spec_lines(jax_render, jh)
        if scheduler == "speculative":
            assert th["generator"]["spec"]["lane"] == "batch"
            assert _spec_lines(render_prometheus, th)
        for call, arg in (("handle_migrate_export", {"request_id": "m"}),
                          ("handle_export_prefix", {"tokens": [1, 2]}),
                          ("handle_timeline", {})):
            assert getattr(tw, call)(dict(arg)) == \
                getattr(jw, call)(dict(arg))
        status = tw.handle_profile({"action": "status"})
        assert status == jw.handle_profile({"action": "status"})
        for w in (tw, jw):
            with pytest.raises(ValueError):
                w.set_role("prefill")
    finally:
        _stop(jw, tw)


def test_reload_reaches_the_batch_lane(weights):
    _, tp = weights
    w = WorkerNode(WorkerConfig(node_id="r0", model=MODEL, dtype="float32",
                                device="cpu", gen_scheduler="batch"),
                   params=tp)
    try:
        body = dict(REQUESTS[0], request_id="r")
        before = w.handle_generate(dict(body))["tokens"]
        new = convert.params_from_jax(
            jax.tree.map(np.asarray,
                         jcreate(MODEL).init(jax.random.PRNGKey(9))),
            jcreate(MODEL).config, device="cpu", dtype="float32")
        w.apply_weights(new)
        after = w.handle_generate(dict(body))["tokens"]
        fresh = Generator(MODEL, params=new, dtype="float32", device="cpu")
        assert after == fresh.generate([body["prompt_tokens"]],
                                       max_new_tokens=12)[0]
        assert after != before
        assert w._get_scorer() is w.generator
    finally:
        w.stop()


def test_int8_weight_batch_lane_matches_jax(weights):
    jw, tw = _pair(weights, quantize="int8", gen_scheduler="batch")
    try:
        assert tw.generator.params is tw.engine.params
        for i, req in enumerate(REQUESTS[:3]):
            body = dict(req, request_id=f"q{i}")
            assert tw.handle_generate(dict(body))["tokens"] == \
                jw.handle_generate(dict(body))["tokens"]
    finally:
        _stop(jw, tw)


@pytest.mark.parametrize("argv,fields", [
    ([], dict(gen_scheduler="continuous", gen_draft_path=None,
              gen_spec_k=4, gen_decode_fused=False)),
    (["--gen-scheduler", "batch", "--gen-decode-fused"],
     dict(gen_scheduler="batch", gen_decode_fused=True)),
    (["--gen-scheduler", "speculative", "--gen-spec-k", "3",
      "--gen-draft-model", "distilgpt2", "--gen-draft-path", "/d"],
     dict(gen_scheduler="speculative", gen_spec_k=3,
          gen_draft_model="distilgpt2", gen_draft_path="/d")),
], ids=["defaults", "batch-fused", "speculative"])
def test_cli_flags_reach_their_fields(argv, fields):
    a, node, model, path = cli.worker_node_args(["8001", "w1", MODEL,
                                                 *argv])
    cfg = cli.worker_config(a, node, model, path)
    for name, value in fields.items():
        assert getattr(cfg, name) == value
        assert getattr(JaxConfig(), name) == getattr(WorkerConfig(), name)


def test_batch_lane_worker_node_subprocess_imports_no_jax():
    """A batch lane from the worker_node command line, in a process of its
    own: /generate (fused), a beam request, a stream and /score, and
    neither jax nor the JAX package in its sys.modules."""
    code = (
        "import http.client, json, sys\n"
        "from tpu_engine_torch.serving import cli\n"
        "from tpu_engine_torch.serving.app import serve_worker\n"
        "a, node, model, path = cli.worker_node_args(['0', 'w1',"
        " 'gpt2-small-test', '--gen-scheduler', 'batch',"
        " '--gen-decode-fused', '--device', 'cpu', '--dtype', 'float32'])\n"
        "w, s = serve_worker(cli.worker_config(a, node, model, path))\n"
        "def post(path, body):\n"
        "    c = http.client.HTTPConnection('127.0.0.1', s.port,"
        " timeout=60)\n"
        "    c.request('POST', path, json.dumps(body))\n"
        "    r = c.getresponse()\n"
        "    return r.status, r.read()\n"
        "g = json.loads(post('/generate', {'request_id': 'a',"
        " 'prompt_tokens': [1, 2, 3], 'max_new_tokens': 6})[1])\n"
        "b = json.loads(post('/generate', {'request_id': 'b',"
        " 'prompt_tokens': [1, 2, 3], 'max_new_tokens': 6,"
        " 'beam_width': 2})[1])\n"
        "st, raw = post('/generate/stream', {'request_id': 'c',"
        " 'prompt_tokens': [1, 2, 3], 'max_new_tokens': 6})\n"
        "sc = json.loads(post('/score', {'request_id': 'd',"
        " 'prompt_tokens': [1, 2], 'completion_tokens': [3]})[1])\n"
        "s.stop(); w.stop()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'n': len(g['tokens']), 'beam': len(b['tokens']),"
        " 'events': raw.count(b'data: '), 'score': len(sc['logprobs']),"
        " 'fused': cli.worker_config(a, node, model,"
        " path).gen_decode_fused, 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "n": 6, "beam": 6, "events": 2, "score": 1, "fused": True,
        "bad": []}
