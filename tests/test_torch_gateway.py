"""The port's gateway (tpu_engine_torch.serving.gateway, app.serve_gateway,
cli gateway) against the JAX package's Gateway, both in front of the same
port workers on the CPU, with the same lane strings ("127.0.0.1:<port>"):

- 50 request_ids land on the same workers, the ring owners, and /stats
  is equal after the same traffic;
- with a lane's server stopped both fail over to the same lane (ring
  order), its breaker opens after 5 failures, and with a 0.2 s timeout a
  restarted server heals it through HALF_OPEN to CLOSED on both, /stats
  equal at every step; a drained lane fails over with no penalty;
- an expired deadline is the same 503 deadline_exceeded at both, an
  all-draining ring the same 503 overloaded, a dead ring the same 500,
  the retry budget's the same 500, and a request naming another model
  probes every lane with no penalty;
- /generate, /score and a /generate/stream relayed one at a time give the
  same bytes through both, up to the measured times (generate_time_us and
  score_time_us masked); a retryable in-band stream error penalises the
  lane's breaker at both;
- each JAX gateway flag the port lacks and in-process lanes refuse by
  name; the gateway command's process serves /infer and imports no jax
  and no tpu_engine.
Comparisons are exact except where a measured time is masked."""

import concurrent.futures
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpu_engine.serving.app import serve_gateway as jax_serve_gateway
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine_torch.core.consistent_hash import ConsistentHash
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import (
    serve_gateway,
    serve_worker,
    worker_server,
)
from tpu_engine_torch.serving.gateway import Gateway
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

REPO = Path(__file__).resolve().parent.parent
MLP = dict(model="mlp", dtype="float32", batch_buckets=(1, 2, 4, 8),
           max_batch_size=8, device="cpu")
GEN = dict(model="gpt2-small-test", dtype="float32", gen_kv_block_size=16,
           gen_mixed_step=True, gen_prefill_chunk=16,
           gen_mixed_token_budget=16, device="cpu")


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, None if body is None
                     else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


class Fleet:
    """Port workers over HTTP whose servers can be stopped and served
    again on the same port."""

    def __init__(self, n, kw):
        self.workers, self.servers = [], []
        for i in range(n):
            w, s = serve_worker(WorkerConfig(port=0, node_id=f"w{i}", **kw))
            self.workers.append(w)
            self.servers.append(s)
        self.urls = [f"127.0.0.1:{s.port}" for s in self.servers]
        self.node = {u: w.node_id for u, w in zip(self.urls, self.workers)}

    def stop_server(self, i):
        self.servers[i].stop(drain_s=0)

    def restart_server(self, i):
        port = int(self.urls[i].rsplit(":", 1)[1])
        self.servers[i] = worker_server(self.workers[i], port)
        self.servers[i].start()

    def close(self):
        for w, s in zip(self.workers, self.servers):
            s.stop(drain_s=0)
            w.stop()


@pytest.fixture(scope="module")
def fleet():
    f = Fleet(3, MLP)
    try:
        yield f
    finally:
        f.close()


@pytest.fixture(scope="module")
def decoder():
    f = Fleet(1, GEN)
    try:
        yield f
    finally:
        f.close()


def _gateways(urls, **kw):
    return (JaxGateway(list(urls), JaxGatewayConfig(**kw)),
            Gateway(list(urls), GatewayConfig(**kw)))


def _owned(urls, lane, n, prefix):
    ring = ConsistentHash()
    for u in urls:
        ring.add_node(u)
    rids = (f"{prefix}{i}" for i in range(100_000))
    return [r for r in rids if ring.get_node(r) == lane][:n]


def _infer_nodes(gw, rids):
    return [gw.route_request({"request_id": r, "input_data": [1.0, 2.0,
                                                               3.0]})
            ["node_id"] for r in rids]


def test_placement_and_stats_match_jax(fleet):
    jgw, tgw = _gateways(fleet.urls)
    rids = [f"req_{i}" for i in range(50)]
    ring = ConsistentHash()
    for u in fleet.urls:
        ring.add_node(u)
    want = [fleet.node[ring.get_node(r)] for r in rids]
    assert _infer_nodes(jgw, rids) == _infer_nodes(tgw, rids) == want
    assert tgw.worker_names() == jgw.worker_names()
    assert tgw.get_stats() == jgw.get_stats()
    assert tgw.get_stats()["total_requests"] == 50


def test_failover_trip_and_heal_match_jax(fleet):
    jgw, tgw = _gateways(fleet.urls, breaker_timeout_s=0.2)
    victim = fleet.urls[1]
    order = tgw.worker_names()
    assert order == jgw.worker_names()
    heir = next(u for u in order if u != victim)
    rids = _owned(fleet.urls, victim, 7, "v")
    fleet.stop_server(1)
    try:
        for gw in (jgw, tgw):
            assert _infer_nodes(gw, rids[:5]) == [fleet.node[heir]] * 5
        js, ts = jgw.get_stats(), tgw.get_stats()
        assert ts == js and ts["failovers"] == 5
        br = {b["node"]: b for b in ts["circuit_breakers"]}[victim]
        assert (br["state"], br["failures"]) == ("OPEN", 5)
    finally:
        fleet.restart_server(1)
    time.sleep(0.3)  # past the 0.2 s breaker timeout
    states = []
    for rid in rids[5:]:
        for gw in (jgw, tgw):
            assert _infer_nodes(gw, [rid]) == [fleet.node[victim]]
        js, ts = jgw.get_stats(), tgw.get_stats()
        assert ts == js
        states.append({b["node"]: b for b in ts["circuit_breakers"]}
                      [victim]["state"])
    assert states == ["HALF_OPEN", "CLOSED"]


def test_drained_lane_fails_over_without_penalty(fleet):
    jgw, tgw = _gateways(fleet.urls)
    victim = fleet.urls[2]
    heir = next(u for u in tgw.worker_names() if u != victim)
    rids = _owned(fleet.urls, victim, 3, "d")
    port = fleet.servers[2].port
    shed0 = fleet.workers[2].get_health().get("admission",
                                              {}).get("shed_draining", 0)
    assert _call(port, "POST", "/admin/drain", {"action": "drain"})[0] == 200
    try:
        for gw in (jgw, tgw):
            assert _infer_nodes(gw, rids) == [fleet.node[heir]] * 3
        js, ts = jgw.get_stats(), tgw.get_stats()
        assert ts == js
        assert ts["resilience"]["shed_overloaded"] == 3
        assert all(b["state"] == "CLOSED" and b["failures"] == 0
                   for b in ts["circuit_breakers"])
        adm = fleet.workers[2].get_health()["admission"]
        assert adm["draining"] and adm["shed_draining"] == shed0 + 6
    finally:
        _call(port, "POST", "/admin/drain", {"action": "undrain"})


@pytest.fixture(scope="module")
def servers(fleet):
    """(JAX gateway port, port gateway port) over HTTP, in front of the
    fleet."""
    jgw, jsrv = jax_serve_gateway(list(fleet.urls),
                                  JaxGatewayConfig(port=0))
    tgw, tsrv = serve_gateway(list(fleet.urls), GatewayConfig(port=0))
    try:
        yield jsrv.port, tsrv.port
    finally:
        tsrv.stop()
        jsrv.stop()
        jgw.stop()


def test_sheds_answer_503_like_jax(fleet, servers):
    jport, tport = servers
    body = {"request_id": "late", "input_data": [1.0], "deadline_ms": 0}
    j, t = _call(jport, "POST", "/infer", body), \
        _call(tport, "POST", "/infer", body)
    assert j == t == (503, b'{"error": "deadline exceeded at gateway '
                           b'admission", "kind": "deadline_exceeded"}', "1")
    ports = [s.port for s in fleet.servers]
    for p in ports:
        _call(p, "POST", "/admin/drain", {"action": "drain"})
    try:
        body = {"request_id": "busy", "input_data": [1.0]}
        j, t = _call(jport, "POST", "/infer", body), \
            _call(tport, "POST", "/infer", body)
        assert j == t and j[0] == 503
        assert json.loads(t[1]) == {
            "error": "all lanes shed the request (overloaded or draining)",
            "kind": "overloaded"}
    finally:
        for p in ports:
            _call(p, "POST", "/admin/drain", {"action": "undrain"})
    j, t = _call(jport, "GET", "/stats"), _call(tport, "GET", "/stats")
    assert j == t and json.loads(t[1])["resilience"]["deadline_rejected"] \
        == 1


def _dead_urls(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    urls = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    return urls


@pytest.mark.parametrize("kw,error", [
    ({}, "All workers failed or unavailable"),
    (dict(retry_budget_ratio=0.0, retry_budget_min=0),
     "retry budget exhausted (retries capped at 0% of recent requests)")],
    ids=["dead-ring", "retry-budget"])
def test_fault_bodies_match_jax(kw, error):
    urls = _dead_urls(2)
    jgw, jsrv = jax_serve_gateway(urls, JaxGatewayConfig(port=0, **kw))
    tgw, tsrv = serve_gateway(urls, GatewayConfig(port=0, **kw))
    try:
        body = {"request_id": "r", "input_data": [1.0]}
        j, t = _call(jsrv.port, "POST", "/infer", body), \
            _call(tsrv.port, "POST", "/infer", body)
        assert j == t == (500, json.dumps({"error": error}).encode(), None)
        assert tgw.get_stats() == jgw.get_stats()
    finally:
        tsrv.stop()
        jsrv.stop()
        jgw.stop()


def test_model_field_probes_the_ring_like_jax(fleet):
    jgw, tgw = _gateways(fleet.urls)
    for gw in (jgw, tgw):
        with pytest.raises(Exception,
                           match="All workers failed or unavailable"):
            gw.route_request({"request_id": "m", "input_data": [1.0],
                              "model": "resnet50"})
        out = gw.route_request({"request_id": "m", "input_data": [1.0],
                                "model": "mlp"})
        assert out["node_id"] in fleet.node.values()
    ts = tgw.get_stats()
    assert ts == jgw.get_stats() and ts["failovers"] == 1
    assert all(b["failures"] == 0 for b in ts["circuit_breakers"])


def _mask_times(raw):
    return re.sub(rb'"(generate|score)_time_us": \d+', rb'"\1_time_us": N',
                  raw)


def test_generation_relay_matches_jax(decoder):
    jgw, jsrv = jax_serve_gateway(list(decoder.urls),
                                  JaxGatewayConfig(port=0))
    tgw, tsrv = serve_gateway(list(decoder.urls), GatewayConfig(port=0))
    try:
        for path, body in (
                ("/generate/stream", {"request_id": "s",
                                      "prompt_tokens": [5, 9, 3, 7],
                                      "max_new_tokens": 10}),
                ("/generate", {"request_id": "g", "prompt_tokens": [4, 2],
                               "max_new_tokens": 6}),
                ("/score", {"request_id": "c", "prompt_tokens": [1, 2, 3],
                            "completion_tokens": [4, 5]})):
            j = _call(jsrv.port, "POST", path, body)
            t = _call(tsrv.port, "POST", path, body)
            assert j[0] == t[0] == 200, (path, j, t)
            assert _mask_times(j[1]) == _mask_times(t[1]), path
            if path == "/generate/stream":
                frames = [f for f in t[1].split(b"\n\n") if f]
                done = json.loads(frames[-1][len(b"data: "):])
                assert len(frames) > 2 and done["done"]
                assert len(done["tokens"]) == 10
        # A retryable in-band error event penalises the serving lane.
        gen = decoder.workers[0].generator
        submit = gen.submit

        def failing(prompt, stream=None, **kw):
            fut = concurrent.futures.Future()
            fut.set_exception(RuntimeError("device fault"))
            stream.put(None)
            return fut

        gen.submit = failing
        try:
            for port in (jsrv.port, tsrv.port):
                status, raw, _ = _call(port, "POST", "/generate/stream",
                                       {"request_id": "f",
                                        "prompt_tokens": [1]})
                assert status == 200 and b'"retryable": true' in raw
        finally:
            gen.submit = submit
        js, ts = jgw.get_stats(), tgw.get_stats()
        assert ts == js and ts["circuit_breakers"][0]["failures"] == 1
    finally:
        tsrv.stop()
        jsrv.stop()
        jgw.stop()


@pytest.mark.parametrize("flag,value,_repeat", cli._UNPORTED_GATEWAY_FLAGS,
                         ids=[f[0] for f in cli._UNPORTED_GATEWAY_FLAGS])
def test_unported_gateway_flag_refuses_by_name(flag, value, _repeat):
    assert f'"{flag}"' in (REPO / "tpu_engine/serving/cli.py").read_text()
    argv = ["127.0.0.1:8001", flag] + (["1"] if value else [])
    with pytest.raises(NotImplementedError, match=re.escape(flag)):
        cli.gateway_config(argv)


# The JAX gateway command's flags of migration, disaggregation, prefix
# affinity and the prefix directory: (flag, argv value, the
# GatewayConfig field and the value it takes).
PORTED_GATEWAY_FLAGS = (
    ("--migrate-streams", None, "migrate_streams", True),
    ("--migrate-timeout", "7.5", "migrate_timeout_s", 7.5),
    ("--prefix-affinity", None, "prefix_affinity", True),
    ("--affinity-block-size", "8", "affinity_block_size", 8),
    ("--affinity-prefix-blocks", "2", "affinity_prefix_blocks", 2),
    ("--affinity-max-imbalance", "3", "affinity_max_imbalance", 3),
    ("--prefix-directory", None, "prefix_directory", True),
    ("--prefix-dir-capacity", "64", "prefix_directory_capacity", 64),
    ("--disagg", None, "disagg", True),
    ("--handoff-timeout", "12", "handoff_timeout_s", 12.0),
)


@pytest.mark.parametrize("flag,value,field,want", PORTED_GATEWAY_FLAGS,
                         ids=[f[0] for f in PORTED_GATEWAY_FLAGS])
def test_gateway_flag_reaches_its_config_field(flag, value, field, want):
    """Each flag is the JAX command's, sets the field JAX's sets, and the
    field keeps JAX's default without it."""
    jax_cli = (REPO / "tpu_engine/serving/cli.py").read_text()
    assert f'"{flag}"' in jax_cli and f'gw_kw["{field}"]' in jax_cli
    argv = ["127.0.0.1:8001", flag] + ([value] if value else [])
    cfg = cli.gateway_config(argv)[1]
    assert getattr(cfg, field) == want
    assert type(getattr(cfg, field)) is type(want)
    assert (getattr(GatewayConfig(), field)
            == getattr(JaxGatewayConfig(), field))
    # Every other field keeps its default.
    assert cfg == GatewayConfig(**{field: want})


# The worker flags of the handoff family: (flag, argv value, the
# WorkerConfig field and the value it takes).
PORTED_WORKER_FLAGS = (
    ("--role", "decode", "role", "decode"),
    ("--prefix-fetch", None, "gen_prefix_fetch", True),
    ("--prefix-fetch-timeout", "2.5", "gen_prefix_fetch_timeout_s", 2.5),
    ("--prefix-fetch-inflight", "4", "gen_prefix_fetch_inflight", 4),
)


@pytest.mark.parametrize("flag,value,field,want", PORTED_WORKER_FLAGS,
                         ids=[f[0] for f in PORTED_WORKER_FLAGS])
@pytest.mark.parametrize("command", ["worker", "worker_node"])
def test_worker_flag_reaches_its_config_field(command, flag, value, field,
                                              want):
    from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig

    jax_cli = (REPO / "tpu_engine/serving/cli.py").read_text()
    assert f'"{flag}"' in jax_cli
    extra = [flag] + ([value] if value else [])
    if command == "worker_node":
        a, node_id, model, path = cli.worker_node_args(
            ["8001", "w1", "gpt2-small-test", "--kv-block-size", "16"]
            + extra)
    else:
        import argparse

        p = argparse.ArgumentParser()
        for name in ("port", "node_id", "model"):
            p.add_argument(name)
        cli._add_worker_flags(p)
        a = p.parse_args(["8001", "w1", "gpt2-small-test"] + extra)
        a.port = int(a.port)
        node_id, model, path = a.node_id, a.model, None
    cfg = cli.worker_config(a, node_id, model, path)
    assert getattr(cfg, field) == want
    assert (getattr(WorkerConfig(), field)
            == getattr(JaxWorkerConfig(), field))


def test_gateway_argv_and_in_process_lanes():
    workers, cfg = cli.gateway_config(
        ["127.0.0.1:8001", "127.0.0.1:8002", "--port", "8100",
         "--breaker-timeout", "0.5", "--drain-timeout", "2",
         "--retry-budget", "0.1"])
    assert workers == ["127.0.0.1:8001", "127.0.0.1:8002"]
    assert (cfg.port, cfg.breaker_timeout_s, cfg.drain_timeout_s,
            cfg.retry_budget_ratio) == (8100, 0.5, 2.0, 0.1)
    assert cli.gateway_config(["h:1"])[1] == GatewayConfig()
    assert cli.main(["gateway"]) == 1
    # An in-process lane joins the ring under its node_id, typed by its
    # model, beside an HTTP lane (untyped).
    from tpu_engine_torch.serving.clients import LocalWorkerClient
    from tpu_engine_torch.serving.worker import WorkerNode

    lane = WorkerNode(WorkerConfig(model="mlp", node_id="lane_a",
                                   device="cpu", dtype="float32"))
    try:
        gw = Gateway([lane, "127.0.0.1:8001"])
        assert sorted(gw.worker_names()) == ["127.0.0.1:8001", "lane_a"]
        assert isinstance(gw.lane_clients()["lane_a"], LocalWorkerClient)
        assert gw.default_model == "mlp"
        assert gw.breaker_for("lane_a") is not None
        got = gw.route_request({"request_id": "r", "model": "mlp",
                                "input_data": [0.5] * 8})
        assert got["node_id"] == "lane_a" and got["cached"] is False
        gw.remove_worker("lane_a")
        assert gw.worker_names() == ["127.0.0.1:8001"]
        assert gw.default_model is None
    finally:
        lane.stop()


def test_remove_worker_drains_within_its_bound(fleet):
    urls = list(fleet.urls) + _dead_urls(1)
    jgw, tgw = _gateways(urls, drain_timeout_s=1.0)
    for gw in (jgw, tgw):
        gw.remove_worker(urls[-1], drain=True)  # dead: counted, removed
        gw.remove_worker(urls[0], drain=True)
        assert gw.worker_names() == jgw.worker_names()
    assert tgw.get_stats() == jgw.get_stats()
    assert tgw.get_stats()["migration"]["drain_failures"] == 1
    assert fleet.workers[0].draining
    _call(fleet.servers[0].port, "POST", "/admin/drain",
          {"action": "undrain"})


def test_gateway_command_serves_and_imports_no_jax(fleet):
    port = _dead_urls(1)[0].rsplit(":", 1)[1]
    code = (
        "import json, os, signal, sys, threading, time, urllib.request\n"
        "from tpu_engine_torch.serving import cli\n"
        "def probe():\n"
        "    body = json.dumps({'request_id': 'p', 'input_data': [1.0]})\n"
        "    for _ in range(300):\n"
        "        try:\n"
        "            out = json.loads(urllib.request.urlopen(\n"
        f"                'http://127.0.0.1:{port}/infer',\n"
        "                data=body.encode(), timeout=10).read())\n"
        "            break\n"
        "        except OSError:\n"
        "            time.sleep(0.05)\n"
        "    bad = sorted(m for m in sys.modules if m == 'jax' or m =="
        " 'tpu_engine' or m.startswith(('jax.', 'tpu_engine.')))\n"
        "    print(json.dumps({'node': out['node_id'], 'bad': bad}),"
        " flush=True)\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "threading.Thread(target=probe, daemon=True).start()\n"
        f"sys.exit(cli.main(['gateway', {fleet.urls[0]!r}, "
        f"{fleet.urls[1]!r}, '--port', '{port}']))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert "Ready!" in lines
    out = json.loads(lines[-1])
    assert out["bad"] == [] and out["node"] in ("w0", "w1")
