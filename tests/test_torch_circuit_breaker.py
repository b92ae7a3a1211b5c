"""The port's circuit breaker (tpu_engine_torch.core.circuit_breaker)
against the JAX package's on one fake clock: scripted and seeded random
sequences of successes, failures, admission checks and clock steps give
the same allow_request answers, state_name(), failure_count and
success_count after every step (exact)."""

import random

import pytest

from tpu_engine.core.circuit_breaker import CircuitBreaker as JaxBreaker
from tpu_engine_torch.core.circuit_breaker import CircuitBreaker

SCRIPTS = {
    # Five consecutive failures open; the timeout half-opens; two
    # successes close.
    "trip-and-heal": ["fail"] * 5 + ["allow", ("tick", 29.9), "allow",
                                     ("tick", 0.1), "allow", "ok", "ok",
                                     "allow"],
    # A success while CLOSED resets the consecutive count.
    "reset-by-success": ["fail"] * 4 + ["ok"] + ["fail"] * 4 + ["allow"],
    # A failure while HALF_OPEN reopens at once.
    "half-open-failure": ["fail"] * 5 + [("tick", 31), "allow", "ok",
                                         "fail", "allow", ("tick", 30),
                                         "allow", "ok", "ok"],
    # Failures while OPEN push the timeout out.
    "open-failures": ["fail"] * 6 + [("tick", 20), "fail", ("tick", 20),
                                     "allow", ("tick", 10), "allow"],
}


def _step(br, op):
    if op == "fail":
        br.record_failure()
    elif op == "ok":
        br.record_success()
    elif op == "allow":
        return br.allow_request()
    return None


def _run(script, thresholds):
    now = [100.0]
    port = CircuitBreaker(*thresholds, clock=lambda: now[0])
    ref = JaxBreaker(*thresholds, clock=lambda: now[0])
    for op in script:
        if isinstance(op, tuple):
            now[0] += op[1]
            continue
        assert _step(port, op) == _step(ref, op), op
        assert (port.state_name(), port.failure_count, port.success_count) \
            == (ref.state_name(), ref.failure_count, ref.success_count), op
        assert port.state.value == ref.state.value


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_sequences_match_jax(name):
    _run(SCRIPTS[name], (5, 2, 30.0))


@pytest.mark.parametrize("thresholds", [(5, 2, 30.0), (1, 1, 0.2),
                                        (3, 4, 5.0)])
@pytest.mark.parametrize("seed", range(3))
def test_random_sequences_match_jax(thresholds, seed):
    rng = random.Random(seed)
    ops = []
    for _ in range(400):
        r = rng.random()
        ops.append("fail" if r < 0.35 else "ok" if r < 0.6 else "allow"
                   if r < 0.85 else ("tick", rng.choice((0.1, 1, 10, 40))))
    _run(ops, thresholds)


def test_defaults_are_the_reference_gateways():
    port, ref = CircuitBreaker(), JaxBreaker()
    assert (port._failure_threshold, port._success_threshold,
            port._timeout) == (ref._failure_threshold,
                               ref._success_threshold, ref._timeout) \
        == (5, 2, 30.0)
    assert port.state_name() == ref.state_name() == "CLOSED"
