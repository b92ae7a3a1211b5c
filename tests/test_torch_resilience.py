"""The port's resilience policies (tpu_engine_torch.serving.resilience,
utils.deadline, utils.config.GatewayConfig) against the JAX package's:

- AdmissionController driven through the same operation sequences raises
  the same exception classes with the same kinds and messages (numbers
  of milliseconds masked), answers the same drain statuses and gives the
  same as_dict(), active, depth and wait_idle after every step;
- RetryBudget gives the same answers and stats() over the same sequence
  under a seeded random.Random;
- the counters' FIELDS, the shed kinds, Deadline.from_request at JAX's
  default (no default deadline) and the ported GatewayConfig fields'
  defaults are JAX's;
- the settings only JAX's serve command sets (a default deadline, the
  failover backoff and its jitter, the shed Retry-After) have JAX's
  effect on the port's gateway;
- every gateway feature the port lacks refuses by name (tiered and
  adaptive admission, and the overload, hedging, stream failover and
  prober fields are ported: tests/test_torch_overload.py and
  tests/test_torch_failover.py).
All comparisons are exact."""

import dataclasses
import http.client
import random
import re
import socket
import time

import pytest

from tpu_engine.serving import resilience as jres
from tpu_engine.serving.gateway import Gateway as JaxGateway
from tpu_engine.utils import deadline as jdl
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine_torch.serving import resilience as tres
from tpu_engine_torch.serving.gateway import Gateway
from tpu_engine_torch.utils import deadline as tdl
from tpu_engine_torch.utils.config import GatewayConfig

# SLO objectives and trace stitching are ported:
# tests/test_torch_observability.py; stream migration, disaggregated
# serving, prefix affinity and the prefix directory:
# tests/test_torch_disagg.py, test_torch_affinity.py,
# test_torch_fleet_prefix.py and test_torch_migration.py.
REFUSED = {"autoscale": True}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # compared across the packages
        return (type(exc).__name__, getattr(exc, "kind", None),
                re.sub(r"\d+", "N", str(exc)))


def _deadlines(offset_s):
    at = time.monotonic() + offset_s
    return tdl.Deadline(at), jdl.Deadline(at)


def _ops(rng, n):
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            ops.append(("admit", rng.choice((None, -1.0, 30.0))))
        elif r < 0.6:
            ops.append(("release",))
        elif r < 0.7:
            ops.append(("drain",))
        elif r < 0.8:
            ops.append(("undrain",))
        else:
            ops.append(("check", rng.choice((None, -1.0, 30.0)),
                        rng.choice((None, 0.001, 60.0))))
    return ops


def _apply(ctl, op, deadline):
    if op[0] == "admit":
        return lambda: ctl.admit(deadline)
    if op[0] == "check":
        return lambda: ctl.check_deadline(deadline, op[2])
    return getattr(ctl, op[0])


@pytest.mark.parametrize("max_depth", [0, 1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_admission_controller_matches_jax(max_depth, seed):
    port = tres.AdmissionController(max_depth, node_id="w1")
    ref = jres.AdmissionController(max_depth, node_id="w1")
    for op in _ops(random.Random(seed), 120):
        td, jd = (None, None) if op[0] not in ("admit", "check") \
            or op[1] is None else _deadlines(op[1])
        got = _outcome(_apply(port, op, td))
        want = _outcome(_apply(ref, op, jd))
        assert got == want, op
        assert port.as_dict() == ref.as_dict(), op
        assert (port.active, port.depth, port.draining) == \
            (ref.active, ref.depth, ref.draining), op
    assert port.wait_idle(0.01) == ref.wait_idle(0.01)


def test_drain_statuses_and_wait_idle_match_jax():
    for ctl in (tres.AdmissionController(2, "w"),
                jres.AdmissionController(2, "w")):
        assert [ctl.drain(), ctl.drain(), ctl.undrain(), ctl.undrain()] \
            == ["draining", "already-draining", "undrained", "not-draining"]
        assert ctl.wait_idle(0.01) is True
        ctl.admit()
        assert ctl.wait_idle(0.01) is False
        ctl.release()
        assert ctl.wait_idle(0.01) is True
        assert ctl.active  # max_depth set


@pytest.mark.parametrize("ratio,minimum", [(None, 10), (0.0, 0), (0.1, 2),
                                           (0.5, 0)])
def test_retry_budget_matches_jax(ratio, minimum):
    port = tres.RetryBudget(ratio, minimum, window_s=60.0)
    ref = jres.RetryBudget(ratio, minimum, window_s=60.0)
    rng = random.Random(7)
    assert port.enabled == ref.enabled
    for _ in range(300):
        if rng.random() < 0.6:
            port.record_request()
            ref.record_request()
        else:
            assert port.try_acquire() == ref.try_acquire()
        assert port.stats() == ref.stats()


def test_counter_fields_and_kinds_match_jax():
    assert tres.ResilienceCounters.FIELDS == jres.ResilienceCounters.FIELDS
    assert tres.MigrationCounters.FIELDS == jres.MigrationCounters.FIELDS
    c = tres.ResilienceCounters()
    assert not c.any_nonzero()
    c.bump("retries", 2)
    assert c.get("retries") == 2 and c.any_nonzero()
    for name in ("ShedError", "DeadlineExceeded", "Overloaded"):
        port, ref = getattr(tdl, name), getattr(jdl, name)
        assert port.kind == ref.kind
        assert port.retry_after_s == ref.retry_after_s
    assert issubclass(tdl.Overloaded, tdl.ShedError)
    assert tdl.ShedError.lane_suspect is False


def test_deadline_from_request_with_default_matches_jax():
    """At JAX's default (none) and at a set default: a request without
    deadline_ms has the default's deadline, one with it its own
    (remaining budgets agree within 50 ms of wall time)."""
    assert JaxGatewayConfig().default_deadline_ms is None
    for default in (None, 250.0):
        for payload in ({}, {"deadline_ms": 40}, {"deadline_ms": 0},
                        {"deadline_ms": 250.0}):
            port = tdl.Deadline.from_request(payload, default)
            ref = jdl.Deadline.from_request(payload, default_ms=default)
            assert (port is None) == (ref is None)
            if port is not None:
                assert abs(port.remaining_ms() - ref.remaining_ms()) < 50
        assert tdl.Deadline.from_request({}) is None
    for bad in (-1, float("nan")):
        with pytest.raises(ValueError, match="deadline_ms"):
            tdl.Deadline.from_request({"deadline_ms": bad})
        with pytest.raises(ValueError, match="deadline_ms"):
            jdl.Deadline.from_request({"deadline_ms": bad}, 100.0)


def test_ported_gateway_fields_have_jax_defaults():
    jax_defaults = {f.name: f.default
                    for f in dataclasses.fields(JaxGatewayConfig)}
    for f in dataclasses.fields(GatewayConfig):
        assert f.name in jax_defaults, f.name
        assert f.default == jax_defaults[f.name], f.name


def _dead_urls(n):
    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    urls = [f"127.0.0.1:{sk.getsockname()[1]}" for sk in socks]
    for sk in socks:
        sk.close()
    return urls


def _route_outcome(gw, payload):
    """(exception class, kind, Retry-After, elapsed s) of one /infer route
    on ``gw``, and its resilience counters."""
    t0 = time.perf_counter()
    try:
        gw.route_request(dict(payload))
        out = ("ok", None, None)
    except Exception as exc:
        out = (type(exc).__name__, getattr(exc, "kind", None),
               getattr(exc, "retry_after_s", None))
    return out, time.perf_counter() - t0, gw.get_stats().get("resilience")


def _effect_default_deadline_ms():
    """A request without deadline_ms gets the default: 0 ms sheds it at
    admission (no lane is tried); one that carries its own budget is
    routed (and fails on the dead lane); the block appears."""
    urls = _dead_urls(1)
    for cls, mod in ((JaxGateway, jdl), (Gateway, tdl)):
        gw = cls(urls, (JaxGatewayConfig if cls is JaxGateway
                        else GatewayConfig)(default_deadline_ms=0.0))
        shed, _, res = _route_outcome(gw, {"request_id": "r",
                                           "input_data": [1.0]})
        routed, _, res2 = _route_outcome(gw, {"request_id": "r",
                                              "input_data": [1.0],
                                              "deadline_ms": 5000})
        yield shed, routed, res, res2


def _effect_retry_backoff_base_ms():
    """Each failover attempt waits min(base * 2^attempt, max): three dead
    lanes, base 40 ms, no jitter: 40 + 80 ms of waits, two counted."""
    urls = _dead_urls(3)
    kw = dict(retry_backoff_base_ms=40.0, retry_jitter=0.0)
    for cls, cfg in ((JaxGateway, JaxGatewayConfig), (Gateway,
                                                      GatewayConfig)):
        out, elapsed, res = _route_outcome(cls(urls, cfg(**kw)),
                                           {"request_id": "r",
                                            "input_data": [1.0]})
        assert 0.12 <= elapsed < 2.0, elapsed
        yield out, res


def _effect_retry_backoff_max_ms():
    """The cap: base 60 ms, max 70 ms, three dead lanes: 60 + 70 ms."""
    urls = _dead_urls(3)
    kw = dict(retry_backoff_base_ms=60.0, retry_backoff_max_ms=70.0,
              retry_jitter=0.0)
    for cls, cfg in ((JaxGateway, JaxGatewayConfig), (Gateway,
                                                      GatewayConfig)):
        out, elapsed, res = _route_outcome(cls(urls, cfg(**kw)),
                                           {"request_id": "r",
                                            "input_data": [1.0]})
        assert 0.13 <= elapsed < 2.0, elapsed
        yield out, res
    for attempt in range(8):
        yield (tres.backoff_delay(attempt, 60.0, 70.0, 0.0),
               jres.backoff_delay(attempt, 60.0, 70.0, 0.0))


def _effect_retry_jitter():
    """backoff_delay equals JAX's under one seeded random.Random, across
    bases, caps, attempts and jitters (clamped to [0, 1])."""
    trng, jrng = random.Random(11), random.Random(11)
    for base in (0.0, 5.0, 40.0):
        for cap in (10.0, 1000.0):
            for jitter in (-0.5, 0.0, 0.25, 0.5, 1.0, 3.0):
                for attempt in (-1, 0, 1, 2, 6):
                    yield (tres.backoff_delay(attempt, base, cap, jitter,
                                              trng),
                           jres.backoff_delay(attempt, base, cap, jitter,
                                              jrng))


def _effect_shed_retry_after_s():
    """A gateway shed's Retry-After is the setting; with overload control
    it is the base scaled by the pressure; over HTTP the header rounds it
    up."""
    from tpu_engine_torch.serving.app import serve_gateway

    urls = _dead_urls(1)
    kw = dict(shed_retry_after_s=3.0, default_deadline_ms=0.0)
    for cls, cfg in ((JaxGateway, JaxGatewayConfig), (Gateway,
                                                      GatewayConfig)):
        for extra in ({}, dict(overload_control=True)):
            out, _, _ = _route_outcome(cls(urls, cfg(**kw, **extra)),
                                       {"request_id": "r",
                                        "input_data": [1.0]})
            yield out
    gw, srv = serve_gateway(urls, GatewayConfig(port=0, **kw))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", "/infer", body=b'{"request_id": "r", '
                     b'"input_data": [1.0]}')
        resp = conn.getresponse()
        resp.read()
        conn.close()
        yield (resp.status, resp.getheader("Retry-After")), (503, "3")
    finally:
        srv.stop()
        gw.stop()


SERVE_ONLY = {"default_deadline_ms": _effect_default_deadline_ms,
              "retry_backoff_base_ms": _effect_retry_backoff_base_ms,
              "retry_backoff_max_ms": _effect_retry_backoff_max_ms,
              "retry_jitter": _effect_retry_jitter,
              "shed_retry_after_s": _effect_shed_retry_after_s}


@pytest.mark.parametrize("field", sorted(SERVE_ONLY))
def test_serve_only_gateway_setting_refuses_by_name(field):
    """The settings that only the serve command sets, once refused by
    name, now ported: each field has JAX's default, and its effect on the
    port's gateway is JAX's (the JAX outcome first, the port's second, in
    each pair the effect yields)."""
    assert getattr(GatewayConfig(), field) == getattr(JaxGatewayConfig(),
                                                      field)
    results = list(SERVE_ONLY[field]())
    assert results
    if field in ("default_deadline_ms", "retry_backoff_base_ms"):
        jax_side, port_side = results
        assert port_side == jax_side
        assert port_side[-1] is not None  # the resilience block shows
        if field == "retry_backoff_base_ms":
            assert port_side[1]["backoff_waits"] == 2
            assert port_side[1]["retries"] == 2
        else:
            assert port_side[0][:2] == ("DeadlineExceeded",
                                        "deadline_exceeded")
            assert port_side[2]["deadline_rejected"] == 1
    elif field == "retry_backoff_max_ms":
        (jout, jres_), (tout, tres_), *delays = results
        assert (tout, tres_) == (jout, jres_) and tres_["backoff_waits"] == 2
        assert all(a == b for a, b in delays)
        assert delays[1][0] == 0.07
    elif field == "retry_jitter":
        assert all(a == b for a, b in results)
        assert len({a for a, _ in results}) > 20
    else:
        *sheds, header = results
        assert sheds[:2] == sheds[2:]  # JAX's, then the port's
        assert sheds[0][2] == 3.0 and sheds[1][2] >= 3.0
        assert header[0] == header[1]


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_unported_gateway_feature_refuses_by_name(field):
    assert getattr(JaxGatewayConfig(), field) in (False, 0.0)
    with pytest.raises(NotImplementedError, match=field):
        GatewayConfig(**{field: REFUSED[field]})
