"""The decode loop's stall watchdog in the port (``WorkerConfig.
scheduler_stall_s``, ``--scheduler-stall-s``) on the CPU, against the JAX
package's:

- the counterpart of ``tests/test_failover.py::
  test_scheduler_liveness_flips_health``: /health carries the loop's tick
  age, and with a threshold a stale loop reads ``healthy: false,
  scheduler_stalled: true``;
- the port's and JAX's /health on the same lane configuration, with the
  watchdog off (no key added) and tripped, have the same keys, top level
  and generator block;
- the brownout's ``tick_age`` component divides the age by the
  threshold (2 s without one), as JAX's does on the same stats;
- the gateway's prober ejects a wedged lane (its prefill busy for 123 s
  against a 60 s threshold), streams complete on the peer, and the lane
  is restored once the wedge clears;
- ``--scheduler-stall-s`` reaches the WorkerConfig on ``worker_node`` as
  JAX's command sets it.
"""

import time

import pytest

from tpu_engine.serving import app as japp
from tpu_engine.serving import cli as jcli
from tpu_engine.serving.worker import WorkerNode as JaxWorker
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.gateway import Gateway, _parse_sse
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

LANE = dict(model="gpt2-small-test", dtype="float32", gen_step_chunk=2,
            gen_kv_block_size=16, gen_prefill_chunk=16)


@pytest.fixture(scope="module")
def lanes():
    """Two port lanes on one weight tree, and a JAX lane of the same
    configuration."""
    w0 = WorkerNode(WorkerConfig(node_id="s0", device="cpu", **LANE))
    w1 = WorkerNode(WorkerConfig(node_id="s1", device="cpu", **LANE),
                    params=w0.engine.params)
    jw = JaxWorker(JaxWorkerConfig(node_id="s0", **LANE))
    yield w0, w1, jw
    for w in (w0, w1, jw):
        w.stop()


def _stalled_health(worker) -> dict:
    """/health with a 1e-9 s threshold; the loop ticks continuously and
    its age is rounded to 1 ms, so a read in the tick's first half
    millisecond may still read healthy: read again after a pause."""
    worker.config.scheduler_stall_s = 1e-9
    try:
        time.sleep(0.01)
        h = worker.get_health()
        for _ in range(5):
            if not h["healthy"]:
                break
            time.sleep(0.05)
            h = worker.get_health()
        return h
    finally:
        worker.config.scheduler_stall_s = 0.0


def test_scheduler_liveness_flips_health(lanes):
    worker = lanes[0]
    h = worker.get_health()
    assert h["generator"]["last_tick_age_s"] >= 0.0
    assert h["healthy"] is True and "scheduler_stalled" not in h
    worker.config.scheduler_stall_s = 3600.0
    try:
        assert worker.get_health()["healthy"] is True
    finally:
        worker.config.scheduler_stall_s = 0.0
    h = _stalled_health(worker)
    assert h["healthy"] is False and h["scheduler_stalled"] is True
    assert worker.get_health()["healthy"] is True


def test_health_schema_matches_jax_with_the_watchdog_off_and_tripped(lanes):
    port, _, jax_lane = lanes
    th, jh = port.get_health(), jax_lane.get_health()
    assert list(th) == list(jh) and "scheduler_stalled" not in th
    assert set(th["generator"]) == set(jh["generator"])
    th, jh = _stalled_health(port), _stalled_health(jax_lane)
    assert list(th) == list(jh)
    assert (th["healthy"], th["scheduler_stalled"]) \
        == (jh["healthy"], jh["scheduler_stalled"]) == (False, True)
    assert set(th["generator"]) == set(jh["generator"])


@pytest.mark.parametrize("stall", [0.0, 4.0, 0.5])
def test_brownout_tick_age_divides_by_the_threshold(lanes, monkeypatch,
                                                    stall):
    port, _, jax_lane = lanes
    comps = []
    for w in (port, jax_lane):
        monkeypatch.setattr(w.config, "scheduler_stall_s", stall)
        monkeypatch.setattr(w.generator, "stats",
                            lambda: {"last_tick_age_s": 1.5})
        comps.append(w._brownout_signals())
    assert comps[0]["tick_age"] == comps[1]["tick_age"] \
        == 1.5 / (stall or 2.0)
    assert set(comps[0]) == set(comps[1])


def _stream(gw, rid: str) -> dict:
    out = {"tokens": []}
    for frame in gw.route_generate_stream(
            {"request_id": rid, "prompt_tokens": [5, 9, 3, 17],
             "max_new_tokens": 6}):
        evt = _parse_sse(frame)
        if evt is None:
            continue
        if evt.get("done"):
            out.update(evt)
            break
        out["tokens"].extend(evt.get("tokens", ()))
    return out


def _wait(pred, timeout: float = 20.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_prober_ejects_a_stalled_lane_and_restores_it(lanes):
    w0, w1, _ = lanes
    gw = Gateway([w0, w1], GatewayConfig(health_probe_interval_s=0.05))
    try:
        rids = [r for r in (f"st{i}" for i in range(200))
                if gw._ring.get_node(r) == "s0"][:3]
        w0.config.scheduler_stall_s = 60.0
        gen = w0.generator
        gen._prefill_busy_since = time.monotonic() - 123.0  # wedged
        try:
            h = w0.get_health()
            assert h["healthy"] is False and h["scheduler_stalled"] is True
            assert _wait(lambda: gw.ejected_lanes() == ["s0"])
            assert gw.failover.get("prober_ejections") == 1
            for rid in rids:
                done = _stream(gw, rid)
                assert done.get("node_id") == "s1", done
                assert len(done["tokens"]) == 6
        finally:
            gen._prefill_busy_since = None
            w0.config.scheduler_stall_s = 0.0
        assert _wait(lambda: gw.ejected_lanes() == [])
        assert gw.failover.get("prober_restores") == 1
        assert gw.failover.get("prober_ejections") == 1
        assert _stream(gw, rids[0])["node_id"] == "s0"
        prober = [s["attrs"]["action"] for s in gw.tracer.snapshot()
                  if s["op"] == "prober"]
        assert prober == ["eject", "restore"]
    finally:
        gw.stop()


class _Captured(Exception):
    pass


@pytest.mark.parametrize("value", ["2.5", "0"])
def test_worker_node_stall_flag_reaches_the_config(monkeypatch, value):
    seen = {}

    def capture(config, *args, **kwargs):
        seen["config"] = config
        raise _Captured

    monkeypatch.setattr(japp, "serve_worker", capture)
    argv = ["8001", "w1", "gpt2-small-test", "--scheduler-stall-s", value]
    with pytest.raises(_Captured):
        jcli.main(["worker_node", *argv])
    a, node_id, model, path = cli.worker_node_args(argv)
    cfg = cli.worker_config(a, node_id, model, path)
    assert cfg.scheduler_stall_s == seen["config"].scheduler_stall_s \
        == float(value)
    a, node_id, model, path = cli.worker_node_args(argv[:3])
    assert cli.worker_config(a, node_id, model, path).scheduler_stall_s \
        == JaxWorkerConfig().scheduler_stall_s == 0.0
