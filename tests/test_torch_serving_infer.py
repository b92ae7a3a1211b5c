"""The port's /infer and /score over HTTP (tpu_engine_torch.serving) against
the JAX package's worker on the same weights, on the CPU.

- /infer, /score and /health carry the JAX worker's keys; outputs agree
  (f32, 1e-4 of the largest magnitude: %.6g on the wire, the same
  forward); ``cached`` flips on a repeat, with the reference's 50 us;
- concurrent identical misses coalesce into one dispatch; a leader's
  DeadlineExceeded retires the entry, other errors reach the followers;
- bad input_data, a wrong model and /generate on a stateless lane are
  400s with the JAX worker's messages; the stateless fences refuse with
  them at startup;
- the batch lane (--no-unified-stateless) answers the unified lane's
  bytes, up to the measured inference_time_us;
- _encode_output writes the JAX native encoder's bytes;
- worker_node's argv and model_from_path resolve as the JAX command's,
  and a real .onnx file refuses;
- an /infer lane's process imports neither jax nor tpu_engine."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    available_models as javailable,
    create_model as jcreate,
)
from tpu_engine.serving.app import model_from_path as jax_model_from_path
from tpu_engine.serving.app import serve_worker as jax_serve_worker
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import (
    available_models,
    model_from_path,
)
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.serving.worker import WorkerNode, _encode_output
from tpu_engine_torch.utils.config import WorkerConfig
from tpu_engine_torch.utils.deadline import DeadlineExceeded

_ensure_builtin_models_imported()

REPO = Path(__file__).resolve().parent.parent
MLP = dict(model="mlp", dtype="float32", batch_buckets=(1, 2, 4, 8),
           max_batch_size=8)
GPT = dict(model="gpt2-small-test", dtype="float32")


def _post(port, path, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _port_params(name):
    """The JAX worker's weights (its engine draws PRNGKey(0)) in the
    port's tree."""
    spec = jcreate(name)
    tree = jax.tree.map(np.asarray, spec.init(jax.random.PRNGKey(0)))
    return params_from_jax(tree, getattr(spec, "config", None),
                           device="cpu", dtype="float32")


@pytest.fixture(scope="module", params=["mlp", "gpt2-small-test"])
def pair(request):
    """(model, JAX worker's port, port worker's port, port worker): the
    same weights behind both HTTP servers."""
    name = request.param
    kw = MLP if name == "mlp" else GPT
    jw, jsrv = jax_serve_worker(JaxWorkerConfig(port=0, node_id="j1", **kw))
    tw, tsrv = serve_worker(WorkerConfig(port=0, node_id="t1", device="cpu",
                                         **kw), params=_port_params(name))
    try:
        yield name, jsrv.port, tsrv.port, tw
    finally:
        tsrv.stop()
        tw.stop()
        jsrv.stop()
        jw.stop()


def _infer(port, rid, data, **extra):
    status, raw = _post(port, "/infer", dict(extra, request_id=rid,
                                             input_data=data))
    assert status == 200, raw
    return json.loads(raw)


def test_infer_matches_jax_and_caches(pair):
    name, jport, tport, _tw = pair
    rng = np.random.default_rng(1)
    width = 16
    for i in range(3):
        data = ([float(x) for x in rng.integers(1, 255, width)]
                if name != "mlp" else rng.standard_normal(width).tolist())
        got = _infer(tport, f"r{i}", data)
        want = _infer(jport, f"r{i}", data)
        assert set(got) == set(want) == {"request_id", "output_data",
                                         "node_id", "cached",
                                         "inference_time_us"}
        assert got["cached"] is want["cached"] is False
        g, w = np.asarray(got["output_data"]), np.asarray(want["output_data"])
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        again = _infer(tport, f"r{i}-again", data)
        assert again["cached"] is True and again["inference_time_us"] == 50
        assert again["output_data"] == got["output_data"]
        assert again["node_id"] == "t1" and again["request_id"] == \
            f"r{i}-again"


def test_health_keys_match_jax(pair):
    name, jport, tport, _tw = pair
    _infer(jport, "h", [1.0, 2.0])
    _infer(tport, "h", [1.0, 2.0])
    _, jh = _get(jport, "/health")
    _, th = _get(tport, "/health")
    assert set(th) == set(jh)
    assert set(th["batch_processor"]) == set(jh["batch_processor"])
    assert th["model"] == jh["model"] == name
    assert th["cache_size"] >= 1 and th["total_requests"] >= 1
    if name == "mlp":  # the scheduler's dispatches fold into the batcher
        assert "generator" not in th
        assert th["batch_processor"]["total_batches"] >= 1
    else:
        assert set(th["generator"]["stateless"]) == set(
            jh["generator"]["stateless"])
        assert th["generator"]["stateless"]["infer_rows"] >= 1


def test_score_matches_jax(pair):
    name, jport, tport, _tw = pair
    body = {"request_id": "s1", "prompt_tokens": [5, 9, 3],
            "completion_tokens": [7, 1, 2, 40]}
    ts, traw = _post(tport, "/score", body)
    js, jraw = _post(jport, "/score", body)
    if name == "mlp":
        assert ts == js == 400
        assert json.loads(traw) == json.loads(jraw) == {
            "error": "model 'mlp' does not support scoring"}
        return
    assert ts == js == 200
    got, want = json.loads(traw), json.loads(jraw)
    assert set(got) == set(want)
    g, w = np.asarray(got["logprobs"]), np.asarray(want["logprobs"])
    assert g.shape == (4,) and np.all(np.abs(g - w) <= 1e-4 * np.abs(w))
    assert got["total_logprob"] == pytest.approx(want["total_logprob"],
                                                 rel=1e-4)
    for bad in ({"completion_tokens": []},
                {"prompt_tokens": [1] * 70, "completion_tokens": [2]}):
        ts, traw = _post(tport, "/score", dict(body, **bad))
        js, jraw = _post(jport, "/score", dict(body, **bad))
        assert ts == js == 400
        assert json.loads(traw) == json.loads(jraw)


def test_bad_requests_are_400s_like_jax(pair):
    name, jport, tport, _tw = pair
    for body in ({"request_id": "b", "input_data": "x"},
                 {"request_id": "b", "input_data": [1.0], "model": "other"},
                 {"request_id": "b"},
                 {"request_id": "b", "input_data": [1.0],
                  "deadline_ms": -1}):
        ts, traw = _post(tport, "/infer", body)
        js, jraw = _post(jport, "/infer", body)
        assert ts == js == 400, (body, traw, jraw)
        assert json.loads(traw) == json.loads(jraw)
    ts, traw = _post(tport, "/infer", {"request_id": "late",
                                       "input_data": [1.0],
                                       "deadline_ms": 0})
    assert ts == 503 and json.loads(traw)["kind"] == "deadline_exceeded"
    gen = {"request_id": "g", "prompt_tokens": [1, 2], "max_new_tokens": 2}
    ts, traw = _post(tport, "/generate", gen)
    js, jraw = _post(jport, "/generate", gen)
    if name == "mlp":
        assert ts == js == 400
        assert json.loads(traw) == json.loads(jraw)
    else:
        assert ts == js == 200


def test_concurrent_identical_misses_coalesce():
    w = WorkerNode(WorkerConfig(node_id="c1", device="cpu", **MLP))
    try:
        dispatch = w._dispatch_infer
        calls = []

        def slow(item, deadline):
            calls.append(item.request_id)
            time.sleep(0.3)  # the followers arrive while the leader runs
            return dispatch(item, deadline)

        w._dispatch_infer = slow
        outs = {}

        def fire(i):
            outs[i] = w.handle_infer({"request_id": f"c{i}",
                                      "input_data": [4.0, 2.0]})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(calls) == 1
        assert len({json.dumps(o["output_data"]) for o in outs.values()}) == 1
        assert all(o["cached"] is False for o in outs.values())
        assert w.generator.stats()["stateless"]["infer_rows"] == 1
        assert w.get_health()["cache_hits"] == 0

        # Another error reaches every follower unchanged ...
        def failing(item, deadline):
            time.sleep(0.2)
            raise ValueError("bad input for this model")

        w._dispatch_infer = failing
        errs = []

        def fire_bad(i):
            try:
                w.handle_infer({"request_id": f"e{i}",
                                "input_data": [9.0, 9.0]})
            except ValueError as exc:
                errs.append(exc)

        threads = [threading.Thread(target=fire_bad, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(errs) == 4 and len({id(e) for e in errs}) == 1

        # ... but a leader's spent deadline does not: a follower leads anew.
        first = []

        def leader_expires(item, deadline):
            if not first:
                first.append(item.request_id)
                time.sleep(0.2)
                raise DeadlineExceeded("the leader's deadline")
            return dispatch(item, deadline)

        w._dispatch_infer = leader_expires
        res = {}

        def fire_dl(i):
            try:
                res[i] = w.handle_infer({"request_id": f"d{i}",
                                         "input_data": [7.0, 1.0]})
            except DeadlineExceeded as exc:
                res[i] = exc

        threads = [threading.Thread(target=fire_dl, args=(i,))
                   for i in range(3)]
        threads[0].start()
        time.sleep(0.05)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert isinstance(res[0], DeadlineExceeded)
        assert all(isinstance(res[i], dict) for i in (1, 2))
        assert res[1]["output_data"] == res[2]["output_data"]
    finally:
        w.stop()


def test_batch_lane_equals_unified_lane():
    params = _port_params("mlp")
    lanes = [WorkerNode(WorkerConfig(node_id="u", device="cpu",
                                     unified_stateless=u, **MLP),
                        params=params) for u in (True, False)]
    try:
        unified, legacy = lanes
        assert unified.generator is not None and legacy.generator is None
        for i, data in enumerate(([1.0, 2.0, 3.0], [0.5] * 16, [9.0])):
            a = unified.handle_infer_raw({"request_id": f"x{i}",
                                          "input_data": data})
            b = legacy.handle_infer_raw({"request_id": f"x{i}",
                                         "input_data": data})
            # The same bytes up to the measured inference_time_us.
            assert a.split(b', "inference_time_us"')[0] == \
                b.split(b', "inference_time_us"')[0]
        ha, hb = unified.get_health(), legacy.get_health()
        assert set(ha) == set(hb)
        assert ha["batch_processor"]["total_batches"] == \
            hb["batch_processor"]["total_batches"] == 3
        assert "generator" not in hb and legacy.generator is None
    finally:
        for w in lanes:
            w.stop()
    gparams = _port_params("gpt2-small-test")
    lanes = [WorkerNode(WorkerConfig(node_id="g", device="cpu",
                                     unified_stateless=u, **GPT),
                        params=gparams) for u in (True, False)]
    try:
        body = {"request_id": "s", "prompt_tokens": [3, 4],
                "completion_tokens": [5, 6]}
        a, b = (w.handle_score(dict(body)) for w in lanes)
        assert a["logprobs"] == b["logprobs"]
        assert "stateless" in lanes[0].get_health()["generator"]
        assert "stateless" not in lanes[1].get_health()["generator"]
    finally:
        for w in lanes:
            w.stop()


def test_apply_weights_clears_the_cache():
    w = WorkerNode(WorkerConfig(node_id="r", device="cpu", **MLP))
    try:
        first = w.handle_infer({"request_id": "a", "input_data": [1.0]})
        doubled = {k: {"kernel": v["kernel"] * 2, "bias": v["bias"]}
                   for k, v in w.engine.params.items()}
        assert w.apply_weights(doubled)["ok"]
        again = w.handle_infer({"request_id": "b", "input_data": [1.0]})
        assert again["cached"] is False
        assert again["output_data"] != first["output_data"]
    finally:
        w.stop()


@pytest.mark.parametrize("knobs", [
    dict(gen_continuous_spec_k=4), dict(gen_kv_quantize="int8"),
    dict(gen_kv_block_size=16, gen_kv_blocks=64),
    dict(gen_mixed_step=True),
    dict(gen_continuous_spec_k=4, gen_kv_block_size=16)],
    ids=["spec-k", "kv-quantize", "kv-blocks", "mixed-step",
         "spec-k-before-kv"])
def test_stateless_fences_match_jax_worker(knobs):
    with pytest.raises(RuntimeError) as want:
        JaxWorker(JaxWorkerConfig(**MLP, **knobs)).stop()
    with pytest.raises(RuntimeError) as got:
        WorkerNode(WorkerConfig(device="cpu", **MLP, **knobs)).stop()
    assert str(got.value) == str(want.value)


# -- the wire encoder ---------------------------------------------------------

def test_encode_output_is_the_native_encoders_bytes():
    from tpu_engine.core import native

    if not native.available():
        pytest.skip("the JAX package's native core does not load here")
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(1000).astype(np.float32) * 10.0 ** k
              for k in (-30, -7, -3, 0, 3, 7, 30)]
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, 3e38,
                         -3.4028235e38, 1e-5, 123456.5, 1234567.0, 0.1],
                        np.float32)
    for arr in arrays + [specials, specials[:1], np.zeros(0, np.float32)]:
        assert _encode_output(arr) == native.json_encode_f32(arr)


# -- the command line and model names -----------------------------------------

@pytest.mark.parametrize("arg", [
    "models/resnet50-v2-7.onnx", "resnet50", "resnet50-v1", "mlp",
    "/srv/models/GPT2.onnx", "llama", "bert-base.onnx", "tiny_mlp.bin",
    "resnet50_v1.onnx", "nothing-known"])
def test_model_from_path_matches_jax(arg):
    assert set(available_models()) == set(javailable())
    try:
        want = jax_model_from_path(arg)
    except ValueError:
        with pytest.raises(ValueError):
            model_from_path(arg)
        return
    assert model_from_path(arg) == want


def test_worker_node_argv_resolves_as_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("MODEL_PATH", raising=False)
    a, node, model, path = cli.worker_node_args(
        ["8001", "worker_1", "models/resnet50-v2-7.onnx"])
    assert (a.port, node, model, path) == (8001, "worker_1", "resnet50",
                                           None)
    a, node, model, _ = cli.worker_node_args(["8002"])
    assert (node, model) == ("worker_8002", "resnet50")
    assert not a.no_unified_stateless and a.max_batch_size == 32
    monkeypatch.setenv("MODEL_PATH", "models/mlp.onnx")
    _, _, model, _ = cli.worker_node_args(["8003", "w3",
                                           "--no-unified-stateless"])
    assert model == "mlp"
    # An existing .onnx file is served as its graph (as JAX: model
    # "onnx"); this one holds no graph, which the parser refuses.
    onnx = tmp_path / "resnet50-v2-7.onnx"
    onnx.write_bytes(b"\x08\x07")
    _, _, model, path = cli.worker_node_args(["8004", "w4", str(onnx)])
    assert (model, path) == ("onnx", str(onnx))
    with pytest.raises(ValueError, match="no data input"):
        WorkerNode(WorkerConfig(model_path=str(onnx), device="cpu", **MLP))
    defaults = WorkerConfig()
    assert defaults.model == JaxWorkerConfig().model == "resnet50"
    for field in ("cache_capacity", "max_batch_size", "batch_timeout_ms",
                  "batch_linger_ms", "fake_cached_latency_us",
                  "pipeline_depth", "batch_buckets", "unified_stateless"):
        assert getattr(defaults, field) == getattr(JaxWorkerConfig(), field)


def test_infer_lane_subprocess_imports_no_jax():
    code = (
        "import json, sys, urllib.request\n"
        "from tpu_engine_torch.serving import cli\n"
        "from tpu_engine_torch.serving.app import serve_worker\n"
        "from tpu_engine_torch.utils.config import WorkerConfig\n"
        "outs = []\n"
        "for unified in (True, False):\n"
        "    w, s = serve_worker(WorkerConfig(port=0, model='mlp',"
        " dtype='bfloat16', device='cpu', unified_stateless=unified),"
        " warmup=True)\n"
        "    for rid in ('a', 'b'):\n"
        "        req = urllib.request.Request("
        "f'http://127.0.0.1:{s.port}/infer', data=json.dumps("
        "{'request_id': rid, 'input_data': [1.0, 2.0, 3.0]}).encode())\n"
        "        out = json.loads(urllib.request.urlopen(req, timeout=60)"
        ".read())\n"
        "        outs.append(out['cached'])\n"
        "    s.stop(); w.stop()\n"
        "w = cli.worker_node_args(['8001', 'w1',"
        " 'models/resnet50-v2-7.onnx'])\n"
        "import tpu_engine_torch.models.resnet\n"
        "mods = ['tpu_engine_torch.runtime.engine',"
        " 'tpu_engine_torch.core.lru_cache',"
        " 'tpu_engine_torch.runtime.batch_processor',"
        " 'tpu_engine_torch.models.mlp']\n"
        "assert all(m in sys.modules for m in mods)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'cached': outs, 'model': w[2], 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "cached": [False, True, False, True], "model": "resnet50",
        "bad": []}
