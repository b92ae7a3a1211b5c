"""Per-request deadlines (the port's copy of what it needs from
``tpu_engine/utils/deadline.py``).

Wire form: an optional ``"deadline_ms"`` request field, the remaining
budget in milliseconds at the hop that wrote it. An absent field means no
deadline. A request whose deadline has passed at admission is refused
with 503 and ``Retry-After``; a row whose deadline passes mid-generation
is cancelled between ticks and its future resolves with
``DeadlineExceeded``. A lane that refuses work it could not serve in time,
is draining or is at its queue depth raises ``Overloaded``: the lane is
healthy, so a gateway fails over without a breaker penalty.

The ``kind`` strings are the JAX package's letter for letter: a gateway
reads them off a 503 body to tell a shed from a fault.
"""

from __future__ import annotations

import time
from typing import Optional


class ShedError(Exception):
    """A request refused by policy, not failed by a fault: the client
    should back off and retry later. The HTTP layer renders it as 503
    with a ``Retry-After`` header and a machine-readable ``kind``."""

    retry_after_s: float = 1.0
    kind: str = "shed"
    # A deadline that ran out while a lane held the request unanswered
    # (the hang signature): the gateway still penalises the lane.
    lane_suspect: bool = False


class DeadlineExceeded(ShedError):
    """The request's deadline expired (at admission or mid-flight)."""

    kind = "deadline_exceeded"


class Overloaded(ShedError):
    """Admission refused the request: queue depth reached, the lane
    draining, or a budget below the lane's service-time estimate."""

    kind = "overloaded"


class Deadline:
    """Absolute monotonic deadline."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after_ms(cls, budget_ms: float) -> "Deadline":
        return cls(time.monotonic() + float(budget_ms) / 1000.0)

    @classmethod
    def from_request(cls, payload: dict,
                     default_ms: Optional[float] = None
                     ) -> Optional["Deadline"]:
        """Deadline from a request dict's ``deadline_ms`` (the budget left
        at this hop), else from ``default_ms``, else None. A negative or
        NaN value is a client error (ValueError, wire 400)."""
        raw = payload.get("deadline_ms")
        if raw is None:
            if default_ms is None:
                return None
            return cls.after_ms(default_ms)
        budget = float(raw)
        if budget != budget or budget < 0:  # NaN or negative
            raise ValueError(f"deadline_ms must be >= 0, got {raw!r}")
        return cls.after_ms(budget)

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0


def clamp_timeout(deadline: Optional[Deadline],
                  timeout_s: Optional[float]) -> Optional[float]:
    """The tighter of a fixed timeout and the deadline's remaining budget
    (floored at 0, so a blocking wait fails fast)."""
    if deadline is None:
        return timeout_s
    rem = max(0.0, deadline.remaining_s())
    return rem if timeout_s is None else min(timeout_s, rem)
