"""The topology-aware ring of the port (``core.consistent_hash`` weights,
``serving.gateway`` topology labels) and the ``--tp`` command lines,
against the JAX package on the same inputs, on the CPU:

- the weighted ring equals JAX's ``ConsistentHash`` on 10,000 keys at
  weights {1, 2, 4}, through re-weights and removals; weight 1 is the
  reference ring;
- in-process tp lanes label the ring at membership, HTTP lanes through
  their ``/health`` (the disagg read at add and the prober's sweeps);
  ``/stats`` grows JAX's ``topology`` block, an unlabelled fleet's stays
  without it; malformed labels normalize as JAX's do, never raising;
- ``worker --tp`` and ``serve --tp`` reach the WorkerConfig fields the
  JAX commands set, and ``serve_combined`` builds tp lanes.
"""

import time

import pytest

from tpu_engine.core.consistent_hash import ConsistentHash as JaxRing
from tpu_engine.models.registry import _ensure_builtin_models_imported
from tpu_engine.serving import app as japp
from tpu_engine.serving import cli as jcli
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.core.consistent_hash import ConsistentHash
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.gateway import Gateway
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

_ensure_builtin_models_imported()

KEYS = [f"req-{i}" for i in range(10_000)]


def _both_rings(vnodes=150):
    return ConsistentHash(vnodes), JaxRing(vnodes)


def _same_ring(port, jax_ring, keys=KEYS):
    assert [port.get_node(k) for k in keys] == [jax_ring.get_node(k)
                                                for k in keys]
    assert port.get_all_nodes() == jax_ring.get_all_nodes()
    for n in ("a", "b", "c"):
        assert port.node_weight(n) == jax_ring.node_weight(n)


STEPS = {
    "weights-1-2-4": [],
    "reweight-down": [("reweight_node", "c", 1)],
    "reweight-up": [("reweight_node", "a", 4), ("add_node", "b", 3)],
    "remove": [("remove_node", "b")],
    "remove-readd": [("remove_node", "c"), ("add_node", "c", 2)],
}


@pytest.mark.parametrize("steps", list(STEPS))
def test_weighted_ring_equals_jax(steps):
    port, jring = _both_rings()
    for ring in (port, jring):
        ring.add_node("a")
        ring.add_node("b", weight=2)
        ring.add_node("c", weight=4)
    for op, *args in STEPS[steps]:
        assert getattr(port, op)(*args) == getattr(jring, op)(*args)
    _same_ring(port, jring)
    dist = port.get_distribution(KEYS[:4000])
    assert dist == jring.get_distribution(KEYS[:4000])


def test_weight_one_is_the_reference_ring():
    weighted, plain = _both_rings()
    weighted.add_node("x", weight=1)
    weighted.add_node("y", weight=1)
    plain.add_node("x")
    plain.add_node("y")
    assert [weighted.get_node(k) for k in KEYS[:2000]] == [
        plain.get_node(k) for k in KEYS[:2000]]
    assert not weighted.reweight_node("ghost", 3)
    assert weighted.node_weight("ghost") == 0
    assert weighted.size() == 2


# -- the gateway ---------------------------------------------------------------

class _Spec:
    name = "gpt2-small-test"


class _Engine:
    spec = _Spec()


class _FakeWorker:
    """An in-process lane as both gateways read it at membership."""

    def __init__(self, node_id, tp, jax_side):
        self.node_id = node_id
        self.engine = _Engine()
        cfg = JaxWorkerConfig if jax_side else WorkerConfig
        self.config = cfg(node_id=node_id, tp=tp)


def _gateways(lanes, **cfg):
    port = Gateway([_FakeWorker(n, tp, False) for n, tp in lanes],
                   GatewayConfig(**cfg))
    jgw = JaxGateway([_FakeWorker(n, tp, True) for n, tp in lanes],
                     JaxGatewayConfig(**cfg))
    return port, jgw


def test_local_tp_lanes_label_the_ring_like_jax():
    port, jgw = _gateways([("w_tp4", 4), ("w_one", 1), ("w_tp2", 2)],
                          virtual_nodes=50)
    try:
        got, want = port.get_stats(), jgw.get_stats()
        assert got["topology"] == want["topology"]
        assert got["topology"]["ring_weights"] == {"w_tp4": 4, "w_one": 1,
                                                   "w_tp2": 2}
        _keys = KEYS[:3000]
        assert [port._ring.get_node(k) for k in _keys] == [
            jgw._ring.get_node(k) for k in _keys]
        assert port._ring.get_distribution(_keys)["w_tp4"] > \
            port._ring.get_distribution(_keys)["w_one"]
        port.remove_worker("w_tp4")
        jgw.remove_worker("w_tp4")
        assert port.get_stats()["topology"] == jgw.get_stats()["topology"]
        port.remove_worker("w_tp2")
        jgw.remove_worker("w_tp2")
        assert "topology" not in port.get_stats()
        assert "topology" not in jgw.get_stats()
    finally:
        port.stop()
        jgw.stop()


LABELS = [None, "tp=4", {"devices": "four"}, {"devices": 2, "tp": None},
          {"tp": 1}, {"tp": 2}, {"devices": 4},
          {"tp": 4, "devices": 4, "mesh_shape": {"model": 4}},
          {"tp": 2, "devices": 2, "mesh_shape": "2"}, {"tp": [2]}, 7,
          {"devices": 0}, {"tp": "3"}]


@pytest.mark.parametrize("label", LABELS, ids=lambda v: repr(v))
def test_normalize_topology_matches_jax(label):
    assert Gateway._normalize_topology(label) == \
        JaxGateway._normalize_topology(label)


def test_prober_label_reweights_every_ring_like_jax():
    port, jgw = _gateways([], virtual_nodes=50)
    try:
        for gw in (port, jgw):
            gw._clients["lane_a"] = object()
            gw._breakers["lane_a"] = gw._make_breaker()
            gw._ring.add_node("lane_a")
            gw._prefill_ring.add_node("lane_a")
        seq = [{"tp": 4, "devices": 4}, {"tp": 4, "devices": 4}, "garbage",
               {"tp": 2}, None]
        for label in seq:
            port._apply_topology("lane_a", label)
            jgw._apply_topology("lane_a", label)
            assert port._ring.node_weight("lane_a") == \
                jgw._ring.node_weight("lane_a")
            assert port._prefill_ring.node_weight("lane_a") == \
                jgw._prefill_ring.node_weight("lane_a")
            assert port.get_stats().get("topology") == \
                jgw.get_stats().get("topology")
        # A label for a lane that left is dropped, as in JAX.
        port._apply_topology("ghost", {"tp": 2})
        assert "topology" not in port.get_stats()
    finally:
        port.stop()
        jgw.stop()


def test_unlabelled_fleet_stats_unchanged():
    port, jgw = _gateways([("w1", 1), ("w2", 1)])
    try:
        got, want = port.get_stats(), jgw.get_stats()
        assert "topology" not in got and "topology" not in want
        assert sorted(got) == sorted(want)
        assert port._ring.node_weight("w1") == 1
    finally:
        port.stop()
        jgw.stop()


@pytest.fixture(scope="module")
def tp_http_lane():
    """A tp 2 port worker behind its HTTP server (ranks on the CPU)."""
    from tpu_engine_torch.serving.app import serve_worker

    worker, server = serve_worker(WorkerConfig(
        port=0, node_id="w_http", model="gpt2-small-test",
        gen_kv_block_size=16, gen_mixed_step=True, tp=2, device="cpu",
        dtype="float32"))
    yield f"127.0.0.1:{server.port}"
    server.stop()
    worker.stop()


def test_http_lane_labelled_by_the_prober(tp_http_lane):
    gw = Gateway([tp_http_lane], GatewayConfig(health_probe_interval_s=0.05,
                                               virtual_nodes=50))
    try:
        deadline = time.monotonic() + 30
        while "topology" not in gw.get_stats():
            assert time.monotonic() < deadline, "the prober set no label"
            time.sleep(0.05)
        topo = gw.get_stats()["topology"]
        assert topo["lanes"][tp_http_lane] == {
            "tp": 2, "devices": 2, "mesh_shape": {"model": 2}}
        assert topo["ring_weights"] == {tp_http_lane: 2}
        assert topo["updates"] == 1
        out = gw.route_generate({"request_id": "h1",
                                 "prompt_tokens": [3, 4, 5],
                                 "max_new_tokens": 3})
        assert len(out["tokens"]) == 3
    finally:
        gw.stop()


def test_http_lane_labelled_at_a_disagg_add(tp_http_lane):
    gw = Gateway([tp_http_lane], GatewayConfig(disagg=True,
                                               virtual_nodes=50))
    try:
        assert gw.get_stats()["topology"]["ring_weights"] == {
            tp_http_lane: 2}
        assert gw._prefill_ring.node_weight(tp_http_lane) == 2
    finally:
        gw.stop()


# -- the command lines and the combined server ----------------------------------

class _Captured(Exception):
    pass


def test_serve_tp_maps_onto_the_jax_fields(monkeypatch):
    argv = ["--model", "gpt2-small-test", "--tp", "2", "--kv-block-size",
            "16", "--mixed-step"]
    seen = {}

    def capture(**kw):
        seen.update(kw)
        raise _Captured

    monkeypatch.setattr(japp, "serve_combined", capture)
    with pytest.raises(_Captured):
        jcli.main(["serve", *argv])
    got = cli.serve_args(argv)["worker_config"]
    want = seen["worker_config"]
    assert got.tp == want.tp == 2
    assert got.tp_device_offset == want.tp_device_offset == 0
    shared = set(got.__dict__) & set(want.__dict__)
    assert {f: got.__dict__[f] for f in shared} == {
        f: want.__dict__[f] for f in shared}
    # --mesh, which refused here until mesh serving was ported, reaches
    # serve_combined's mesh argument as the JAX command passes it.
    seen.clear()
    with pytest.raises(_Captured):
        jcli.main(["serve", "--mesh", "data=1", *argv])
    assert cli.serve_args(["--mesh", "data=1", *argv])["mesh"] == \
        seen["mesh"] == "data=1"


def test_worker_tp_flag_reaches_the_config():
    p = cli.argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8001)
    cli._add_worker_flags(p)
    a = p.parse_args(["--tp", "2", "--kv-block-size", "16"])
    assert cli.worker_config(a, "w1", "gpt2-small-test").tp == 2
    assert cli.worker_config(p.parse_args([]), "w1",
                             "gpt2-small-test").tp == 1


def test_serve_combined_builds_tp_lanes():
    from tpu_engine_torch.serving.app import serve_combined, stop_combined

    gw, workers, server = serve_combined(
        model="gpt2-small-test", lanes=2, port=0, native_front=False,
        worker_config=WorkerConfig(tp=2, device="cpu", dtype="float32",
                                   gen_kv_block_size=16,
                                   gen_mixed_step=True))
    try:
        assert [w.generator._tp_group.size for w in workers] == [2, 2]
        assert gw.get_stats()["topology"]["ring_weights"] == {
            "worker_1": 2, "worker_2": 2}
        h = workers[0].get_health()
        assert h["topology"]["tp"] == 2
        out = workers[1].handle_generate({"request_id": "c1",
                                          "prompt_tokens": [1, 2, 3],
                                          "max_new_tokens": 4})
        assert len(out["tokens"]) == 4
    finally:
        stop_combined(gw, workers, server)
