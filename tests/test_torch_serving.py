"""The port's worker over HTTP on the CPU (tpu_engine_torch.serving) against
the JAX package's generator and worker, with the same weights: /generate
and /generate/stream tokens equal the JAX mixed-step generator's; a
two-path lane's, an int8 lane's and the default (dense) lane's tokens
equal the JAX generator's of the same mode; /health and /stats carry the
JAX schemas (the idle /infer cache, batcher and stateless blocks
included); the --kv-quantize guard refuses as the JAX worker's does; an
expired deadline is a 503 with Retry-After, a bad deadline and a
misaddressed model a 400, and a deadline passing mid-generation cancels
the row, as in the JAX worker; and neither the package nor chip_smoke.py imports jax,
tpu_engine, optax or orbax (a serving subprocess's sys.modules, and an AST
scan of the sources)."""

import ast
import http.client
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.utils.config import WorkerConfig

_ensure_builtin_models_imported()

REPO = Path(__file__).resolve().parent.parent
LANE = dict(gen_kv_block_size=16, gen_mixed_step=True, gen_prefill_chunk=16,
            gen_mixed_token_budget=16)
# /health keys of the JAX worker, and generator stats, that the port's
# worker leaves out: none (the /infer cache, the batcher and the stateless
# block are carried idle).
HEALTH_LEFT_OUT = set()
GENERATOR_LEFT_OUT = set()
# The slice-2 lanes: two-path (no --mixed-step) and the int8 pool.
LANES = {"two-path": dict(gen_kv_block_size=16, gen_prefill_chunk=16,
                          gen_step_chunk=4),
         "int8-mixed": dict(LANE, gen_kv_quantize="int8"),
         "int8-two-path": dict(gen_kv_block_size=16, gen_prefill_chunk=16,
                               gen_step_chunk=4, gen_kv_quantize="int8")}
PROMPTS = [[5, 9, 3], [(i * 7) % 90 + 1 for i in range(40)]]


@pytest.fixture(scope="module")
def params():
    return jcreate("gpt2-small-test").init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def server(params):
    tparams = convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        tcreate("gpt2-small-test").config, device="cpu")
    cfg = WorkerConfig(port=0, node_id="torch_1", model="gpt2-small-test",
                       dtype="float32", device="cpu", **LANE)
    worker, srv = serve_worker(cfg, params=tparams)
    yield srv.port
    srv.stop()
    worker.stop()


@pytest.fixture(scope="module")
def jax_tokens(params):
    g = JaxGen(jcreate("gpt2-small-test"), params=params, dtype="float32",
               n_slots=8, kv_block_size=16, prefill_chunk=16,
               mixed_step=True, mixed_token_budget=16)
    try:
        yield [g.generate([p], max_new_tokens=6)[0] for p in PROMPTS]
    finally:
        g.stop()


def _request(port, method, path, body=None, headers=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, json.dumps(body) if body else None)
        resp = conn.getresponse()
        out = resp.status, resp.read()
        return (*out, dict(resp.getheaders())) if headers else out
    finally:
        conn.close()


@pytest.fixture(scope="module")
def jax_server():
    """The JAX worker of the same lane behind the JAX package's HTTP
    server, for wire comparisons."""
    from tpu_engine.serving.http import JsonHttpServer as JaxHttp

    jw = JaxWorker(JaxWorkerConfig(model="gpt2-small-test", **LANE))
    srv = JaxHttp(0)
    srv.route("POST", "/generate",
              lambda body: (200, jw.handle_generate(body)))
    srv.route("POST", "/generate/stream",
              lambda body: (200, jw.handle_generate_stream(body)))
    srv.start(background=True)
    try:
        yield srv.port
    finally:
        srv.stop()
        jw.stop()


def test_generate_matches_jax(server, jax_tokens):
    for i, (prompt, want) in enumerate(zip(PROMPTS, jax_tokens)):
        status, raw = _request(server, "POST", "/generate", {
            "request_id": f"r{i}", "prompt_tokens": prompt,
            "max_new_tokens": 6})
        assert status == 200
        body = json.loads(raw)
        assert set(body) == {"request_id", "tokens", "node_id",
                             "generate_time_us"}
        assert body["request_id"] == f"r{i}" and body["node_id"] == "torch_1"
        assert body["tokens"] == want


def test_generate_stream_matches_jax(server, jax_tokens):
    status, raw = _request(server, "POST", "/generate/stream", {
        "request_id": "s1", "prompt_tokens": PROMPTS[1],
        "max_new_tokens": 6})
    assert status == 200
    events = [json.loads(f[len(b"data: "):]) for f in raw.split(b"\n\n")
              if f]
    streamed = [t for ev in events[:-1] for t in ev["tokens"]]
    final = events[-1]
    assert final["done"] and final["tokens"] == streamed == jax_tokens[1]
    assert set(final) == {"done", "request_id", "tokens", "node_id",
                          "generate_time_us"}


def test_bad_request_is_400(server):
    status, _ = _request(server, "POST", "/generate", {"request_id": "x"})
    assert status == 400
    status, _ = _request(server, "POST", "/generate/stream", {
        "request_id": "x", "prompt_tokens": [1], "min_p": 2.0})
    assert status == 400


@pytest.mark.parametrize("path", ["/generate", "/generate/stream"])
def test_expired_deadline_is_503_like_jax(server, jax_server, path):
    body = {"request_id": "dl", "prompt_tokens": [5, 9, 3],
            "max_new_tokens": 4, "deadline_ms": 0}
    got = _request(server, "POST", path, body, headers=True)
    want = _request(jax_server, "POST", path, body, headers=True)
    assert got[0] == want[0] == 503
    assert got[2]["Retry-After"] == want[2]["Retry-After"] == "1"
    assert json.loads(got[1]) == json.loads(want[1]) == {
        "error": "deadline exceeded at admission",
        "kind": "deadline_exceeded"}
    body["deadline_ms"] = 60000
    assert _request(server, "POST", path, body)[0] == 200


@pytest.mark.parametrize("bad", [-5, float("nan"), "soon"])
def test_bad_deadline_is_400_like_jax(server, jax_server, bad):
    for path in ("/generate", "/generate/stream"):
        body = {"request_id": "bd", "prompt_tokens": [5, 9, 3],
                "max_new_tokens": 2, "deadline_ms": bad}
        assert _request(server, "POST", path, body)[0] == 400
        assert _request(jax_server, "POST", path, body)[0] == 400


def test_misaddressed_model_is_400_like_jax(server, jax_server):
    for path in ("/generate", "/generate/stream"):
        body = {"request_id": "m", "prompt_tokens": [5, 9, 3],
                "max_new_tokens": 2, "model": "llama"}
        got = _request(server, "POST", path, body)
        want = _request(jax_server, "POST", path, body)
        assert got[0] == want[0] == 400
        assert json.loads(got[1]) == json.loads(want[1]) == {
            "error": "this lane serves model 'gpt2-small-test', not "
                     "'llama'"}
        body["model"] = "gpt2-small-test"
        assert _request(server, "POST", path, body)[0] == 200


def _stream_until_expired(worker, module, monkeypatch):
    """Drive one /generate/stream through ``worker.handle_generate_stream``
    with a deadline that passes once the first tokens have streamed
    (``module``'s Deadline patched to hand out that one object). Returns
    (tokens streamed, terminal event)."""
    deadline = module.Deadline.after_ms(600000)
    monkeypatch.setattr(module.Deadline, "from_request",
                        classmethod(lambda cls, payload, *a: deadline))
    events = worker.handle_generate_stream({
        "request_id": "mid", "prompt_tokens": [5, 9, 3],
        "max_new_tokens": 60, "deadline_ms": 600000})
    streamed, final = [], None
    for frame in events:
        ev = json.loads(frame[len(b"data: "):])
        if ev.get("done"):
            final = ev
        else:
            streamed.extend(ev["tokens"])
            deadline.at = 0.0  # the deadline passes mid-generation
    return streamed, final


def test_deadline_mid_generation_cancels_like_jax(params, monkeypatch):
    """A row whose deadline passes mid-generation is cancelled between
    ticks: the stream ends with the JAX lane's terminal error event (not
    retryable, tokens_emitted = what streamed), the row's blocks return
    to the pool, and the blocking endpoint raises DeadlineExceeded."""
    import tpu_engine.serving.worker as jworker_mod
    import tpu_engine.utils.deadline as jdeadline
    import tpu_engine_torch.serving.worker as tworker_mod
    import tpu_engine_torch.utils.deadline as tdeadline
    from tpu_engine_torch.serving.worker import WorkerNode

    tparams = convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        tcreate("gpt2-small-test").config, device="cpu")
    tw = WorkerNode(WorkerConfig(model="gpt2-small-test", dtype="float32",
                                 device="cpu", **LANE), params=tparams)
    jw = JaxWorker(JaxWorkerConfig(model="gpt2-small-test", **LANE))
    try:
        finals = []
        for worker, mod in ((tw, tworker_mod), (jw, jworker_mod)):
            streamed, final = _stream_until_expired(worker, mod,
                                                    monkeypatch)
            assert 0 < len(streamed) < 60
            assert final["tokens_emitted"] == len(streamed)
            assert "deadline exceeded mid-generation" in final["error"]
            finals.append(final)
        keys = {"done", "error", "retryable", "request_id",
                "tokens_emitted"}
        assert set(finals[0]) == keys <= set(finals[1])
        assert finals[0]["retryable"] is finals[1]["retryable"] is False
        st = tw.get_stats()
        for _ in range(200):
            if not st["active"]:
                break
            time.sleep(0.05)
            st = tw.get_stats()
        assert st["active"] == 0 and st["deadline_cancelled"] == 1
        pool = st["kv_pool"]
        assert pool["blocks_free"] + pool["radix_nodes"] >= \
            pool["blocks_total"]
        expired = tdeadline.Deadline.after_ms(600000)
        fut = tw.generator.submit([5, 9, 3], max_new_tokens=60,
                                  deadline=expired)
        expired.at = 0.0
        with pytest.raises(tdeadline.DeadlineExceeded):
            fut.result(timeout=60)
        assert issubclass(jdeadline.DeadlineExceeded, jdeadline.ShedError)
    finally:
        tw.stop()
        jw.stop()


def test_health_and_stats_schemas_match_jax(server):
    jw = JaxWorker(JaxWorkerConfig(model="gpt2-small-test", **LANE))
    try:
        jhealth = jw.get_health()
    finally:
        jw.stop()
    status, raw = _request(server, "GET", "/health")
    assert status == 200
    health = json.loads(raw)
    assert set(health) == set(jhealth) - HEALTH_LEFT_OUT
    assert (set(health["generator"])
            == set(jhealth["generator"]) - GENERATOR_LEFT_OUT)
    assert set(health["generator"]["mixed"]) == set(
        jhealth["generator"]["mixed"])
    assert set(health["generator"]["kv_pool"]) == set(
        jhealth["generator"]["kv_pool"])
    status, raw = _request(server, "GET", "/stats")
    stats = json.loads(raw)
    assert status == 200 and stats["node_id"] == "torch_1"
    assert set(stats) - {"node_id"} == set(health["generator"])
    assert stats["mixed"]["ticks"] == stats["mixed"]["dispatches"]


@pytest.mark.parametrize("lane", sorted(LANES))
def test_slice2_lanes_match_jax(params, lane):
    """A two-path or int8 port worker over HTTP gives the JAX generator's
    tokens for the same mode and weights, and the JAX worker's /health
    generator schema for that lane."""
    kw = LANES[lane]
    tparams = convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        tcreate("gpt2-small-test").config, device="cpu")
    worker, srv = serve_worker(WorkerConfig(
        port=0, node_id="torch_2", model="gpt2-small-test",
        dtype="float32", device="cpu", **kw), params=tparams)
    g = JaxGen(jcreate("gpt2-small-test"), params=params, dtype="float32",
               n_slots=8, kv_block_size=16, prefill_chunk=16,
               step_chunk=kw.get("gen_step_chunk", 8),
               mixed_step=kw.get("gen_mixed_step", False),
               mixed_token_budget=kw.get("gen_mixed_token_budget", 0),
               kv_quantize=kw.get("gen_kv_quantize", ""))
    jw = JaxWorker(JaxWorkerConfig(model="gpt2-small-test", **kw))
    try:
        for i, prompt in enumerate(PROMPTS):
            status, raw = _request(srv.port, "POST", "/generate", {
                "request_id": f"{lane}-{i}", "prompt_tokens": prompt,
                "max_new_tokens": 6})
            assert status == 200
            want = g.generate([prompt], max_new_tokens=6)[0]
            assert json.loads(raw)["tokens"] == want
        jw.handle_generate({"request_id": "j", "prompt_tokens": [5, 9, 3],
                            "max_new_tokens": 2})
        status, raw = _request(srv.port, "GET", "/health")
        health = json.loads(raw)["generator"]
        jhealth = jw.get_health()["generator"]
        assert set(health) == set(jhealth) - GENERATOR_LEFT_OUT
        assert set(health["kv_pool"]) == set(jhealth["kv_pool"])
        if kw.get("gen_mixed_step"):
            assert health["mixed"]["ticks"] == health["mixed"]["dispatches"]
        else:
            assert health["chunks"] > 0
        if kw.get("gen_kv_quantize"):
            assert health["kv_pool"]["quantized"] == "int8"
    finally:
        srv.stop()
        worker.stop()
        g.stop()
        jw.stop()


def test_default_lane_is_dense_and_matches_jax(params):
    """A worker built with the default WorkerConfig (no --kv-block-size)
    runs the dense scheduler: /generate and /generate/stream give the JAX
    dense generator's tokens (the second /generate is a prefix-cache hit),
    and /health and /stats have the JAX worker's generator schema."""
    tparams = convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        tcreate("gpt2-small-test").config, device="cpu")
    worker, srv = serve_worker(WorkerConfig(
        port=0, node_id="torch_3", model="gpt2-small-test", dtype="float32",
        device="cpu"), params=tparams)
    g = JaxGen(jcreate("gpt2-small-test"), params=params, dtype="float32",
               n_slots=8, step_chunk=16)
    jw = JaxWorker(JaxWorkerConfig(model="gpt2-small-test"))
    try:
        assert worker.generator._paged is False
        for i, prompt in enumerate(PROMPTS + PROMPTS[:1]):
            status, raw = _request(srv.port, "POST", "/generate", {
                "request_id": f"dense-{i}", "prompt_tokens": prompt,
                "max_new_tokens": 6})
            assert status == 200
            want = g.generate([prompt], max_new_tokens=6)[0]
            assert json.loads(raw)["tokens"] == want
        status, raw = _request(srv.port, "POST", "/generate/stream", {
            "request_id": "dense-s", "prompt_tokens": PROMPTS[1],
            "max_new_tokens": 6})
        events = [json.loads(f[len(b"data: "):]) for f in raw.split(b"\n\n")
                  if f]
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        assert status == 200 and events[-1]["done"]
        assert events[-1]["tokens"] == streamed == g.generate(
            [PROMPTS[1]], max_new_tokens=6)[0]
        jw.handle_generate({"request_id": "j", "prompt_tokens": [5, 9, 3],
                            "max_new_tokens": 2})
        status, raw = _request(srv.port, "GET", "/health")
        health = json.loads(raw)
        jhealth = jw.get_health()
        assert set(health) == set(jhealth) - HEALTH_LEFT_OUT
        assert (set(health["generator"])
                == set(jhealth["generator"]) - GENERATOR_LEFT_OUT)
        assert "kv_pool" not in health["generator"]
        status, raw = _request(srv.port, "GET", "/stats")
        stats = json.loads(raw)
        assert set(stats) - {"node_id"} == set(health["generator"])
        assert stats["prefix_cache"]["hits"] >= 2
        assert stats["chunks"] > 0
        assert stats["prefix_cache"] == g.stats()["prefix_cache"]
    finally:
        srv.stop()
        worker.stop()
        g.stop()
        jw.stop()


def test_default_lane_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_worker(WorkerConfig(port=0, model="gpt2-small-test",
                                  dtype="float32"))


def test_kv_quantize_guard_matches_jax_worker():
    for kw, match in ((dict(gen_kv_quantize="int8"), "kv-quantize requires"),
                      (dict(gen_kv_block_size=16, gen_kv_quantize="fp8"),
                       "must be 'int8'")):
        with pytest.raises(RuntimeError, match=match):
            serve_worker(WorkerConfig(port=0, model="gpt2-small-test",
                                      dtype="float32", device="cpu", **kw))
        with pytest.raises(RuntimeError, match=match):
            JaxWorker(JaxWorkerConfig(model="gpt2-small-test", **kw))


def test_serving_subprocess_imports_no_jax():
    code = (
        "import json, sys, urllib.request\n"
        "from tpu_engine_torch.serving.app import serve_worker\n"
        "from tpu_engine_torch.utils.config import WorkerConfig\n"
        "lens = []\n"
        "for lane in (dict(gen_kv_block_size=16, gen_mixed_step=True,"
        " gen_prefill_chunk=16), {}):\n"
        "    w, s = serve_worker(WorkerConfig(port=0,"
        " model='gpt2-small-test', dtype='float32', device='cpu', **lane))\n"
        "    req = urllib.request.Request("
        "f'http://127.0.0.1:{s.port}/generate',"
        " data=json.dumps({'request_id': 'a', 'prompt_tokens': [1, 2],"
        " 'max_new_tokens': 3}).encode())\n"
        "    out = json.loads(urllib.request.urlopen(req, timeout=60)"
        ".read())\n"
        "    s.stop(); w.stop()\n"
        "    lens.append(len(out['tokens']))\n"
        "assert 'tpu_engine_torch.ops.flash' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'tokens': lens, 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "tokens": [3, 3], "bad": []}


def test_package_sources_import_no_jax():
    offenders = []
    sources = sorted((REPO / "tpu_engine_torch").rglob("*.py"))
    for path in sources + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "tpu_engine", "optax", "orbax"):
                    offenders.append(f"{path.relative_to(REPO)}: {n}")
    assert offenders == []
