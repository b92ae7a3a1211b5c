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
- every gateway feature the port lacks, and the settings only JAX's
  serve command sets, refuse by name (tiered and adaptive admission, and
  the overload, hedging, stream failover and prober fields are ported:
  tests/test_torch_overload.py and tests/test_torch_failover.py).
All comparisons are exact."""

import dataclasses
import random
import re
import time

import pytest

from tpu_engine.serving import resilience as jres
from tpu_engine.utils import deadline as jdl
from tpu_engine.utils.config import GatewayConfig as JaxGatewayConfig
from tpu_engine_torch.serving import resilience as tres
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
    """The port has JAX's default: a request without deadline_ms has no
    deadline (remaining budgets agree within 50 ms of wall time)."""
    default = JaxGatewayConfig().default_deadline_ms
    assert default is None
    for payload in ({}, {"deadline_ms": 40}, {"deadline_ms": 0},
                    {"deadline_ms": 250.0}):
        port = tdl.Deadline.from_request(payload)
        ref = jdl.Deadline.from_request(payload, default_ms=default)
        assert (port is None) == (ref is None)
        if port is not None:
            assert abs(port.remaining_ms() - ref.remaining_ms()) < 50
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


# Settings only JAX's serve command sets (ROADMAP.md §A 16.7), each with
# a value that would switch it on, and JAX's default, which the port's
# gateway keeps: no default deadline, immediate failover, Retry-After 1.
SERVE_ONLY = {"default_deadline_ms": (250.0, None),
              "retry_backoff_base_ms": (10.0, 0.0),
              "retry_backoff_max_ms": (50.0, 1000.0),
              "retry_jitter": (0.0, 0.5),
              "shed_retry_after_s": (3.0, 1.0)}


@pytest.mark.parametrize("field", sorted(SERVE_ONLY))
def test_serve_only_gateway_setting_refuses_by_name(field):
    on, default = SERVE_ONLY[field]
    assert getattr(JaxGatewayConfig(), field) == default
    with pytest.raises(TypeError, match=field):
        GatewayConfig(**{field: on})


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_unported_gateway_feature_refuses_by_name(field):
    assert getattr(JaxGatewayConfig(), field) in (False, 0.0)
    with pytest.raises(NotImplementedError, match=field):
        GatewayConfig(**{field: REFUSED[field]})
