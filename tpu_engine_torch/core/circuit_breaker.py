"""Per-lane circuit breaker (the port's copy of
``tpu_engine/core/circuit_breaker.py``): CLOSED -> OPEN after
``failure_threshold`` consecutive failures (a success while CLOSED resets
the count), OPEN -> HALF_OPEN once ``timeout_seconds`` have passed since
the last failure, HALF_OPEN -> CLOSED after ``success_threshold``
successes, and any failure while HALF_OPEN reopens. The clock is
injectable."""

from __future__ import annotations

import enum
import threading
import time


class CircuitState(enum.Enum):
    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"


class CircuitBreaker:
    """Thread-safe breaker; the defaults are the reference gateway's (5
    failures, 2 successes, 30 s)."""

    def __init__(self, failure_threshold: int = 5,
                 success_threshold: int = 2, timeout_seconds: float = 30.0,
                 clock=time.monotonic):
        self._failure_threshold = int(failure_threshold)
        self._success_threshold = int(success_threshold)
        self._timeout = float(timeout_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._failure_count = 0
        self._success_count = 0
        self._last_failure_time = clock()

    def allow_request(self) -> bool:
        with self._lock:
            if self._state is CircuitState.OPEN:
                if self._clock() - self._last_failure_time >= self._timeout:
                    self._state = CircuitState.HALF_OPEN
                    self._success_count = 0
                    return True
                return False
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state is CircuitState.HALF_OPEN:
                self._success_count += 1
                if self._success_count >= self._success_threshold:
                    self._state = CircuitState.CLOSED
                    self._failure_count = 0
            else:
                self._failure_count = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failure_count += 1
            self._last_failure_time = self._clock()
            if (self._failure_count >= self._failure_threshold
                    or self._state is CircuitState.HALF_OPEN):
                self._state = CircuitState.OPEN

    # Read without the lock: one reference or int each, for /stats.

    @property
    def state(self) -> CircuitState:
        return self._state

    @property
    def failure_count(self) -> int:
        return self._failure_count

    @property
    def success_count(self) -> int:
        return self._success_count

    def state_name(self) -> str:
        return self._state.value
