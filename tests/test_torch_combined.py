"""The port's combined server (``serving.app.serve_combined``: in-process
lanes behind the gateway and the C++ front) beside the JAX package's, on
the CPU, with the same weights carried across by ``models.convert``: the
same request sequence gives the same answers, counters and routing; the
admin routes, the multi-model fleet, the decoder lanes' streams and the
in-process handoff; the front's edge cases; and the ``serve`` command's
argv against the JAX command's."""

import http.client
import json
import re
import socket
import threading
import time

import jax
import numpy as np
import pytest

from tpu_engine.models.registry import _ensure_builtin_models_imported
from tpu_engine.serving import app as japp
from tpu_engine.serving import cli as jcli
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.core import native
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import serve_combined, stop_combined
from tpu_engine_torch.serving.http import JsonHttpServer
from tpu_engine_torch.utils.checkpoint import save_params
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

_ensure_builtin_models_imported()

MLP = dict(dtype="float32", batch_buckets=(1, 2, 4, 8), max_batch_size=8)
GPT = dict(dtype="float32", gen_kv_block_size=16, gen_mixed_step=True,
           gen_prefill_chunk=16, gen_mixed_token_budget=16)
# A short breaker timeout so a healed lane's breaker half-opens in the test.
GW = dict(breaker_timeout_s=0.5)
# Miss outputs, port against JAX: max |diff| over max |JAX| (f32).
MISS_TOL = 1e-4


def _call(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Content-Type")
    finally:
        conn.close()


def _json(port, method, path, body=None):
    status, raw, _ = _call(port, method, path, body)
    return status, json.loads(raw)


def _checkpoint(tmp_path_factory, name: str, jax_params) -> str:
    """The JAX lanes' weights as a checkpoint of the port's format."""
    spec = create_model(name)
    tree = params_from_jax(jax.tree.map(np.asarray, jax_params),
                           getattr(spec, "config", None), device="cpu",
                           dtype="float32")
    return save_params(str(tmp_path_factory.mktemp(name) / "params"), tree)


class Pair:
    """A JAX and a port combined server over the same weights."""

    def __init__(self, tmp_path_factory, model: str, jkw: dict, tkw: dict,
                 gw: dict, **serve_kw):
        self.jgw, self.jworkers, self.jsrv = japp.serve_combined(
            model=model, port=0,
            worker_config=JaxWorkerConfig(model=model, **jkw),
            gateway_config=JaxGatewayConfig(port=0, **gw), **serve_kw)
        try:
            self.ckpt = _checkpoint(tmp_path_factory, model,
                                    self.jworkers[0].engine.params)
            self.gw, self.workers, self.srv = serve_combined(
                model=model, port=0,
                worker_config=WorkerConfig(model_path=self.ckpt,
                                           device="cpu", **tkw),
                gateway_config=GatewayConfig(port=0, **gw), **serve_kw)
        except BaseException:
            self.stop_jax()
            raise

    def stop_jax(self):
        self.jsrv.stop()
        self.jgw.stop()
        for w in self.jworkers:
            w.stop()

    def stop(self):
        stop_combined(self.gw, self.workers, self.srv)
        self.stop_jax()

    def both(self, method, path, body=None):
        """(JAX's, the port's) (status, body bytes, content type)."""
        return (_call(self.jsrv.port, method, path, body),
                _call(self.srv.port, method, path, body))


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    pair = Pair(tmp_path_factory, "mlp", MLP, MLP, GW, lanes=2,
                native_front=True)
    yield pair
    pair.stop()


def _envelope(raw: bytes) -> tuple:
    """(the body with its output_data fragment cut out, the fragment)."""
    a = raw.index(b'"output_data": ') + len(b'"output_data": ')
    b = raw.index(b', "node_id"')
    return raw[:a] + raw[b:], raw[a:b]


INPUTS = [np.random.default_rng(i).standard_normal(16).tolist()
          for i in range(4)]


def _infer_sequence(pair, tag: str, n: int = 16) -> list:
    """``n`` sequential /infer requests over the four inputs, fresh
    request ids, sent to both stacks; returns the decoded port answers."""
    frags = ({}, {})
    answers = []
    for i in range(n):
        body = {"request_id": f"{tag}{i}", "input_data": INPUTS[i % 4]}
        (js, jraw, _), (ts, traw, _) = pair.both("POST", "/infer", body)
        assert js == ts == 200, (jraw, traw)
        jenv, jfrag = _envelope(jraw)
        tenv, tfrag = _envelope(traw)
        if b'"cached": false' in tenv:  # a miss: its own compute time
            jenv = re.sub(rb'"inference_time_us": \d+', b"", jenv)
            tenv = re.sub(rb'"inference_time_us": \d+', b"", tenv)
        assert tenv == jenv  # byte for byte around the fragment
        got, want = json.loads(tfrag), json.loads(jfrag)
        assert np.abs(np.subtract(got, want)).max() \
            <= MISS_TOL * np.abs(want).max()
        ans = json.loads(traw)
        key = (ans["node_id"], i % 4)
        for stack, frag in zip(frags, (jfrag, tfrag)):
            # Every hit, C++ or Python, is its miss's fragment exactly.
            assert stack.setdefault(key, frag) == frag
        answers.append(ans)
    return answers


def test_infer_hits_and_health_match_jax(mlp):
    answers = _infer_sequence(mlp, "seq")
    ring_of = mlp.gw._ring.get_node
    assert all(a["node_id"] == ring_of(a["request_id"]) for a in answers)
    assert sum(a["cached"] for a in answers) >= 8
    hits = {w.node_id: mlp.srv.lane_counters(w.node_id)[1]
            for w in mlp.workers}
    jhits = {w.node_id: mlp.jsrv.lane_counters(w.node_id)[1]
             for w in mlp.jworkers}
    assert hits == jhits and sum(hits.values()) > 0
    (_, jraw, _), (_, traw, _) = mlp.both("GET", "/health")
    jh, th = json.loads(jraw), json.loads(traw)
    assert set(th) == set(jh)
    for k in ("healthy", "node_id", "total_requests", "cache_hits",
              "cache_size"):
        assert th[k] == jh[k], k
    assert th["total_requests"] == len(answers)
    assert th["cache_hits"] == sum(a["cached"] for a in answers)
    assert set(th["lanes"]) == set(jh["lanes"]) == {"worker_1", "worker_2"}
    for lane, h in th["lanes"].items():
        assert set(h) == set(jh["lanes"][lane])
        for k in ("total_requests", "cache_hits", "cache_size"):
            assert h[k] == jh["lanes"][lane][k], (lane, k)
    (_, jraw, _), (_, traw, _) = mlp.both("GET", "/stats")
    js, ts = json.loads(jraw), json.loads(traw)
    for k in ("total_workers", "total_requests", "failovers",
              "circuit_breakers"):
        assert ts[k] == js[k], k
    for node in ("worker_1", "worker_2"):
        (_, jraw, _), (_, traw, _) = mlp.both("GET", f"/health/{node}")
        assert json.loads(traw)["cache_hits"] == \
            json.loads(jraw)["cache_hits"]


def _lane_rids(pair, lane: str, n: int, tag: str) -> list:
    return [r for r in (f"{tag}{i}" for i in range(400))
            if pair.gw._ring.get_node(r) == lane][:n]


def _send(pair, rids, inp) -> list:
    out = []
    for rid in rids:
        (js, jraw, _), (ts, traw, _) = pair.both(
            "POST", "/infer", {"request_id": rid, "input_data": inp})
        assert js == ts == 200
        j, t = json.loads(jraw), json.loads(traw)
        assert (t["node_id"], t["cached"]) == (j["node_id"], j["cached"])
        out.append(t)
    return out


def test_admin_fault_stops_cpp_hits_and_heal_resumes(mlp):
    inp = INPUTS[0]
    rids = _lane_rids(mlp, "worker_1", 12, "fault")
    _send(mlp, rids[:2], inp)  # cached on worker_1
    before = mlp.srv.lane_counters("worker_1")[1]
    for port in (mlp.jsrv.port, mlp.srv.port):
        status, body = _json(port, "POST", "/admin/fault",
                             {"node": "worker_1", "action": "fail"})
        assert status == 200 and body == {"ok": True, "nodes": ["worker_1"],
                                          "action": "fail"}
    failed = _send(mlp, rids[2:8], inp)
    assert {a["node_id"] for a in failed} == {"worker_2"}
    assert mlp.srv.lane_counters("worker_1")[1] == before
    _, h = _json(mlp.srv.port, "GET", "/health/worker_1")
    assert h["healthy"] is False
    assert _json(mlp.srv.port, "GET", "/health")[1]["healthy"] is False
    for port in (mlp.jsrv.port, mlp.srv.port):
        _json(port, "POST", "/admin/fault",
              {"node": "worker_1", "action": "heal"})
    time.sleep(0.6)  # the breaker's timeout: it half-opens
    healed = _send(mlp, rids[8:12], inp)
    assert all(a["node_id"] == "worker_1" and a["cached"] for a in healed)
    assert mlp.srv.lane_counters("worker_1")[1] == before + 4
    assert _json(mlp.srv.port, "GET", "/health")[1]["healthy"] is True
    status, body = _json(mlp.srv.port, "POST", "/admin/fault",
                         {"node": "nope", "action": "fail"})
    assert status == 404


def test_admin_drain_and_the_lane_listeners(mlp):
    inp = INPUTS[1]
    rids = _lane_rids(mlp, "worker_2", 8, "drain")
    _send(mlp, rids[:2], inp)
    before = mlp.srv.lane_counters("worker_2")[1]
    for port in (mlp.jsrv.port, mlp.srv.port):
        status, body = _json(port, "POST", "/admin/drain",
                             {"node": "worker_2", "action": "drain"})
        assert body == {"ok": True, "action": "drain",
                        "nodes": ["worker_2"], "removed": False}
    drained = _send(mlp, rids[2:5], inp)
    assert {a["node_id"] for a in drained} == {"worker_1"}
    assert mlp.srv.lane_counters("worker_2")[1] == before
    w2 = next(w for w in mlp.workers if w.node_id == "worker_2")
    heard = []
    w2.on_fault_change(heard.append)
    # heal leaves a draining lane disabled; undrain leaves a faulted one.
    w2.inject_fault()
    w2.heal()
    w2.inject_fault()
    w2.undrain()
    assert heard == [False, False, False]
    w2.heal()
    assert heard[-1] is True
    w2._fault_listeners.remove(heard.append)
    _json(mlp.jsrv.port, "POST", "/admin/drain",
          {"node": "worker_2", "action": "undrain"})
    back = _send(mlp, rids[5:8], inp)
    assert all(a["node_id"] == "worker_2" and a["cached"] for a in back)
    assert mlp.srv.lane_counters("worker_2")[1] == before + 3
    status, body = _json(mlp.srv.port, "POST", "/admin/drain",
                         {"node": "nope"})
    assert body == {"ok": False, "status": "unknown-lane", "node": "nope"}
    assert _json(mlp.srv.port, "POST", "/admin/drain",
                 {"action": "bogus"})[0] == 400


def test_metrics_trace_and_unrouted_paths_through_the_cpp_front(mlp):
    _send(mlp, ["trace0"], INPUTS[3])
    (js, jraw, jct), (ts, traw, tct) = mlp.both("GET", "/metrics")
    assert js == ts == 200 and tct == jct == "text/plain; version=0.0.4"
    assert b"tpu_engine_" in traw
    assert _call(mlp.srv.port, "GET", "/trace")[0] == 200
    events = _json(mlp.srv.port, "GET", "/trace/export")[1]["traceEvents"]
    assert any(e.get("name") == "infer" for e in events)
    assert _call(mlp.srv.port, "POST", "/admin/fleet", {})[0] == 404
    timeline = _json(mlp.srv.port, "GET", "/admin/timeline")[1]
    assert set(timeline["lanes"]) == {"worker_1", "worker_2"}
    status, prof = _json(mlp.srv.port, "GET", "/admin/profile")
    assert status == 200 and prof["node_id"] == "worker_1"
    status, body = _json(mlp.srv.port, "GET", "/admin/slo")
    assert status == 200 and "no objectives configured" in body["error"]
    status, body = _json(mlp.srv.port, "GET", "/admin/trace/trace0")
    assert status == 200 and body["request_id"] == "trace0"
    status, body = _json(mlp.srv.port, "POST", "/infer",
                         {"request_id": "bad"})
    assert status == 400


def test_admin_reload_swaps_every_lane(mlp, tmp_path):
    from tpu_engine_torch.runtime.engine import InferenceEngine
    from tpu_engine_torch.utils.checkpoint import load_params

    old = load_params(mlp.ckpt, device="cpu")
    new = {k: {kk: vv * 0.5 for kk, vv in v.items()}
           for k, v in old.items()}
    path = save_params(str(tmp_path / "halved"), new)
    status, body = _json(mlp.srv.port, "POST", "/admin/reload",
                         {"model_path": path})
    assert status == 200 and body["ok"]
    assert [o["node_id"] for o in body["reloaded"]] == ["worker_1",
                                                        "worker_2"]
    assert all(w.cache.size() == 0 for w in mlp.workers)
    engine = InferenceEngine("mlp", params=new, device="cpu",
                             dtype="float32", batch_buckets=(1,))
    want = engine.batch_predict(np.asarray([INPUTS[2]], np.float32))[0]
    for i in range(3):
        status, got = _json(mlp.srv.port, "POST", "/infer",
                            {"request_id": f"reload{i}",
                             "input_data": INPUTS[2]})
        assert status == 200 and (i > 0 or got["cached"] is False)
        np.testing.assert_allclose(got["output_data"], want, rtol=1e-5,
                                   atol=1e-5)
    status, body = _json(mlp.srv.port, "POST", "/admin/reload",
                         {"model_path": str(tmp_path / "nothing")})
    assert status == 400
    assert _json(mlp.srv.port, "POST", "/admin/reload",
                 {"model_path": path, "node": "nope"})[0] == 404
    _json(mlp.srv.port, "POST", "/admin/reload",
          {"model_path": mlp.ckpt})


def test_cpp_front_oversized_body_rejected(mlp):
    with socket.create_connection(("127.0.0.1", mlp.srv.port),
                                  timeout=10) as s:
        s.sendall(b"POST /infer HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 99999999999\r\n\r\n")
        data = s.recv(4096)
    assert b" 413 " in data.split(b"\r\n", 1)[0]


def test_cpp_front_unterminated_header_rejected(mlp):
    with socket.create_connection(("127.0.0.1", mlp.srv.port),
                                  timeout=10) as s:
        try:
            for _ in range(8):  # 512 KiB of header with no CRLF
                s.sendall(b"X" * (1 << 16))
        except (BrokenPipeError, ConnectionResetError):
            pass
        s.settimeout(10)
        try:
            data = s.recv(4096)
            assert data == b"" or b" 431 " in data.split(b"\r\n", 1)[0]
        except ConnectionResetError:
            pass


def _short_request(port: int, payload: bytes) -> int:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(b"POST /infer HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                  b"Content-Length: " + str(len(payload)).encode()
                  + b"\r\n\r\n" + payload)
        data = b""
        while b"\r\n" not in data:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        return int(data.split(b" ", 2)[1])


@pytest.mark.slow
def test_cpp_front_connection_churn(mlp):
    port = mlp.srv.port
    payload = json.dumps({"request_id": "churn",
                          "input_data": INPUTS[3]}).encode()
    keep = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    keep.request("POST", "/infer", payload,
                 {"Content-Type": "application/json"})
    assert keep.getresponse().read()
    errors = []

    def churn(n):
        for _ in range(n):
            try:
                status = _short_request(port, payload)
                if status != 200:
                    errors.append(status)
            except Exception as exc:
                errors.append(repr(exc))

    threads = [threading.Thread(target=churn, args=(1100,))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    keep.request("POST", "/infer", payload,
                 {"Content-Type": "application/json"})
    assert json.loads(keep.getresponse().read())["cached"] is True
    keep.close()


# -- several models ------------------------------------------------------------

def test_multi_model_routes_by_model_and_refuses_the_cpp_front():
    model = "mlp,gpt2-small-test"
    with pytest.raises(RuntimeError, match="single-model"):
        serve_combined(model=model, lanes=2, port=0, native_front=True,
                       worker_config=WorkerConfig(device="cpu", **MLP))
    with pytest.raises(RuntimeError, match="single-model"):
        japp.serve_combined(model=model, lanes=2, port=0, native_front=True,
                            worker_config=JaxWorkerConfig(**MLP))
    jgw, jws, jsrv = japp.serve_combined(
        model=model, lanes=2, port=0, worker_config=JaxWorkerConfig(**MLP))
    gw, ws, srv = serve_combined(model=model, lanes=2, port=0,
                                 worker_config=WorkerConfig(device="cpu",
                                                            **MLP))
    try:
        assert isinstance(srv, JsonHttpServer)
        assert gw.default_model == jgw.default_model == "mlp"
        assert [w.engine.spec.name for w in ws] == ["mlp", "gpt2-small-test"]
        gen = {"prompt_tokens": [3, 4, 5], "max_new_tokens": 2}
        cases = [("/infer", {"request_id": f"m{i}", "model": "mlp",
                             "input_data": INPUTS[0]}) for i in range(4)]
        cases += [("/generate", dict(gen, request_id=f"g{i}",
                                     model="gpt2-small-test"))
                  for i in range(4)]
        cases += [("/generate", dict(gen, request_id="nomodel")),
                  ("/infer", {"request_id": "x", "model": "nope",
                              "input_data": [1.0]}),
                  ("/score", {"request_id": "s", "model": "gpt2-small-test",
                              "prompt_tokens": [1, 2],
                              "completion_tokens": [3]})]
        for path, body in cases:
            js, jb = _json(jsrv.port, "POST", path, body)
            ts, tb = _json(srv.port, "POST", path, body)
            assert ts == js, (path, body, tb, jb)
            if ts == 200:
                assert tb["node_id"] == jb["node_id"], (path, body)
                want = "worker_1" if body.get("model") == "mlp" \
                    else "worker_2"
                assert tb["node_id"] == want
        status, body = _json(srv.port, "POST", "/admin/reload",
                             {"model_path": "x"})
        assert status == 400 and "multiple models" in body["error"]
    finally:
        stop_combined(gw, ws, srv)
        jsrv.stop()
        for w in jws:
            w.stop()


# -- decoder lanes ---------------------------------------------------------------

def _stream_tokens(raw: bytes) -> tuple:
    events = [json.loads(line[len(b"data: "):])
              for line in raw.split(b"\n") if line.startswith(b"data: ")]
    toks = [t for e in events if "tokens" in e and not e.get("done")
            for t in e["tokens"]]
    return toks, events[-1]


PROMPTS = [[5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 9, 5, 3, 7, 1, 4, 8, 2, 6],
           [11, 3, 7, 2], [4, 4, 8, 15, 16, 23, 42, 8, 4, 4, 8, 15, 16, 23,
                            42, 8, 4, 2, 6, 1, 9, 3]]


@pytest.mark.parametrize("split", [False, True], ids=["mixed", "disagg"])
def test_decoder_lanes_stream_jax_tokens(tmp_path_factory, split):
    """gpt2-small-test on paged mixed lanes: greedy streams through the
    combined front equal JAX's; split into a prefill and a decode lane
    with disagg, each stream is handed off in process (its done event on
    the decode lane, zero tokens prefilled there) and still equals JAX's."""
    gw = dict(GW, disagg=True) if split else GW
    extra = dict(lane_roles=["prefill", "decode"]) if split else {}
    pair = Pair(tmp_path_factory, "gpt2-small-test", GPT, GPT, gw, lanes=2,
                native_front=True, **extra)
    try:
        for i, prompt in enumerate(PROMPTS):
            body = {"request_id": f"s{i}", "prompt_tokens": prompt,
                    "max_new_tokens": 8}
            (js, jraw, _), (ts, traw, _) = pair.both(
                "POST", "/generate/stream", body)
            assert js == ts == 200
            jt, jdone = _stream_tokens(jraw)
            tt, tdone = _stream_tokens(traw)
            assert tt == jt == tdone["tokens"] == jdone["tokens"]
            assert len(tt) == 8
            if split:
                assert tdone["node_id"] == "worker_2"
            _, blocking = _json(pair.srv.port, "POST", "/generate", body)
            assert blocking["tokens"] == tt
        stats = _json(pair.srv.port, "GET", "/stats")[1]
        assert set(stats["kv_pool"]) == {"worker_1", "worker_2"}
        assert set(stats["mixed"]) <= {"worker_1", "worker_2"}
        if split:
            ho = stats["handoff"]
            assert ho["handoffs_spliced"] == 2 * len(PROMPTS)
            assert ho["roles"] == {"worker_1": "prefill",
                                   "worker_2": "decode"}
            d = _json(pair.srv.port, "GET", "/health/worker_2")[1]
            assert d["generator"]["kv_pool"]["prefilled_tokens"] == 0
            # A role flip rides the drain, as JAX's does.
            flip = {"node": "worker_2", "role": "both"}
            (js, jraw, _), (ts, traw, _) = pair.both("POST", "/admin/role",
                                                     flip)
            assert js == ts == 200
            assert json.loads(traw) == json.loads(jraw)
            roles = _json(pair.srv.port, "GET", "/stats")[1]["handoff"]
            assert roles["roles"]["worker_2"] == "both"
            assert _call(pair.srv.port, "POST", "/admin/role",
                         {"node": "nope", "role": "both"})[0] == 404
    finally:
        pair.stop()


def test_prefix_fetch_in_process(tmp_path_factory):
    """--prefix-fetch in combined mode: the gateway's directory hints the
    owner lane, and the serving lane fetches the owner's chain by calling
    it directly (no HTTP); the tokens equal a lane's own."""
    gpt = dict(GPT, gen_prefix_fetch=True)
    gw_kw = dict(GW, prefix_directory=True, affinity_block_size=16)
    gw, ws, srv = serve_combined(
        model="gpt2-small-test", lanes=2, port=0,
        worker_config=WorkerConfig(device="cpu", **gpt),
        gateway_config=GatewayConfig(port=0, **gw_kw))
    try:
        ring = gw._ring
        rid_of = {n: next(f"p{n}{i}" for i in range(400)
                          if ring.get_node(f"p{n}{i}") == n)
                  for n in ("worker_1", "worker_2")}
        shared = [int(t) for t in
                  np.random.default_rng(5).integers(1, 200, 48)]
        owner = {"request_id": rid_of["worker_1"], "max_new_tokens": 4,
                 "prompt_tokens": shared + [7, 8]}
        status, first = _json(srv.port, "POST", "/generate", owner)
        assert status == 200 and first["node_id"] == "worker_1"
        other = {"request_id": rid_of["worker_2"], "max_new_tokens": 4,
                 "prompt_tokens": shared + [9]}
        status, got = _json(srv.port, "POST", "/generate", other)
        assert status == 200 and got["node_id"] == "worker_2"
        pf = _json(srv.port, "GET", "/health/worker_2")[1]["generator"][
            "prefix_fetch"]
        assert pf["attempted"] == pf["spliced"] == 1
        assert pf["prefill_tokens_skipped_remote"] >= 32
        stats = _json(srv.port, "GET", "/stats")[1]
        assert stats["prefix_directory"]["hints_attached"] == 1
        assert stats["prefix_fetch"]["worker_2"]["spliced"] == 1
        # The same request alone on worker_1 (its own prefix cache).
        again = dict(other, request_id=next(
            f"q{i}" for i in range(400)
            if ring.get_node(f"q{i}") == "worker_1"))
        assert _json(srv.port, "POST", "/generate", again)[1]["tokens"] \
            == got["tokens"]
    finally:
        stop_combined(gw, ws, srv)


# -- no fallback -------------------------------------------------------------------

def test_a_failed_build_raises_and_only_off_serves_python(monkeypatch):
    def broken():
        raise RuntimeError("building libtpucore_torch failed: g++: error")

    monkeypatch.setattr(native, "load", broken)
    for front in (None, True):
        with pytest.raises(RuntimeError, match="g\\+\\+: error"):
            serve_combined(model="mlp", lanes=1, port=0, native_front=front,
                           worker_config=WorkerConfig(device="cpu", **MLP))
    gw, ws, srv = serve_combined(
        model="mlp", port=0, native_front=False, warmup=True,
        worker_config=WorkerConfig(device="cpu", **MLP))
    try:
        assert isinstance(srv, JsonHttpServer)
        assert [w.node_id for w in ws] == ["worker_1"]  # lanes=0: one CPU
        status, body = _json(srv.port, "POST", "/infer",
                             {"request_id": "r", "input_data": INPUTS[0]})
        assert status == 200 and body["node_id"] == "worker_1"
    finally:
        stop_combined(gw, ws, srv)


# -- the serve command ---------------------------------------------------------------

SERVE_ARGV = {
    "defaults": [],
    "one-shot": ["--model", "resnet50", "--lanes", "2", "--native-front",
                 "on", "--port", "8123", "--cache-capacity", "64",
                 "--batch-buckets", "1,4,16", "--batch-timeout-ms", "5",
                 "--pipeline-depth", "2", "--max-queue-depth", "9",
                 "--warmup"],
    "decoder": ["--model", "llama", "--lanes", "2", "--lane-roles",
                "prefill,decode", "--disagg", "--kv-block-size", "16",
                "--mixed-step", "--native-front", "on",
                "--default-deadline-ms", "60000", "--retry-backoff-ms", "5",
                "--gen-prefill-chunk", "64", "--mixed-token-budget", "128",
                "--kv-blocks", "300", "--kv-quantize", "int8"],
    "resilience": ["--model", "gpt2-small-test,mlp", "--native-front",
                   "off", "--retry-budget", "0.1", "--hedge",
                   "--hedge-quantile", "0.9", "--hedge-min-ms", "20",
                   "--breaker-timeout", "2", "--failover-streams",
                   "--migrate-streams", "--migrate-timeout", "3",
                   "--drain-timeout", "4", "--health-probe-interval", "0.5",
                   "--overload-control", "--overload-max-inflight", "8",
                   "--tenant-rate", "5", "--tenant-burst", "7",
                   "--priority-admission", "--adaptive-depth", "--brownout",
                   "--brownout-clamp-tokens", "12"],
    "prefix-and-trace": ["--model", "gpt2-small-test", "--kv-block-size",
                         "32", "--prefix-affinity", "--prefix-fetch",
                         "--prefix-fetch-timeout", "2",
                         "--affinity-prefix-blocks", "2",
                         "--affinity-max-imbalance", "3", "--prefix-sharing",
                         "off", "--kv-host-blocks", "8", "--spec-k", "3",
                         "--spec-draft", "model", "--gen-draft-model",
                         "distilgpt2", "--trace-stitch",
                         "--trace-ledger-capacity", "64",
                         "--slo-ttft-p99-ms", "500", "--slo-itl-p99-ms",
                         "100", "--slo-target", "0.95", "--slo-window-s",
                         "30", "--flight-recorder", "32", "--profile-dir",
                         "p", "--flight-dump-dir", "d", "--quantize", "int8",
                         "--role", "decode", "--no-unified-stateless",
                         "--shape-buckets", "32x32x3,64x64x3"],
    "batch-lane": ["--model", "gpt2-small-test", "--gen-scheduler",
                   "speculative", "--gen-spec-k", "3", "--gen-draft-path",
                   "dp", "--gen-decode-fused", "--state-rows", "4",
                   "--gen-prefix-cache-mb", "8", "--handoff-timeout", "9"],
}


class _Captured(Exception):
    pass


def _jax_serve_kwargs(monkeypatch, argv) -> dict:
    seen = {}

    def capture(**kw):
        seen.update(kw)
        raise _Captured

    monkeypatch.setattr(japp, "serve_combined", capture)
    with pytest.raises(_Captured):
        jcli.main(["serve", *argv])
    return seen


def _fields(cfg) -> dict:
    return None if cfg is None else dict(cfg.__dict__)


@pytest.mark.parametrize("case", sorted(SERVE_ARGV))
def test_serve_argv_maps_onto_the_jax_fields(monkeypatch, case):
    argv = SERVE_ARGV[case]
    want = _jax_serve_kwargs(monkeypatch, argv)
    got = cli.serve_args(argv)
    for k in ("model", "lanes", "port", "warmup", "native_front",
              "lane_roles"):
        assert got[k] == want[k], k
    assert want["mesh"] is None
    for k in ("worker_config", "gateway_config"):
        g, w = _fields(got[k]), _fields(want[k])
        assert (g is None) == (w is None), k
        if g is not None:
            shared = set(g) & set(w)
            assert {f: g[f] for f in shared} == {f: w[f] for f in shared}, k
    assert set(_fields(got["worker_config"])) - set(
        _fields(want["worker_config"])) == {"device", "seed"}


@pytest.mark.parametrize("argv", [
    ["--mesh", "data=1"], ["--tp", "2"], ["--scheduler-stall-s", "5"],
    ["--autoscale"], ["--autoscale-max-lanes", "3"], ["--autoscale-slo-feed"],
], ids=lambda a: a[0])
def test_serve_unported_flags_refuse_by_name(argv):
    with pytest.raises(NotImplementedError, match=argv[0]):
        cli.serve_args(argv)
    with pytest.raises(NotImplementedError, match=argv[0]):
        cli.main(["serve", *argv])
