"""Per-request deadlines (the port's copy of what it needs from
``tpu_engine/utils/deadline.py``).

Wire form: an optional ``"deadline_ms"`` request field, the remaining
budget in milliseconds at the hop that wrote it. An absent field means no
deadline. A request whose deadline has passed at admission is refused
with 503 and ``Retry-After``; a row whose deadline passes mid-generation
is cancelled between ticks and its future resolves with
``DeadlineExceeded``.
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


class DeadlineExceeded(ShedError):
    """The request's deadline expired (at admission or mid-flight)."""

    kind = "deadline_exceeded"


class Deadline:
    """Absolute monotonic deadline."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after_ms(cls, budget_ms: float) -> "Deadline":
        return cls(time.monotonic() + float(budget_ms) / 1000.0)

    @classmethod
    def from_request(cls, payload: dict) -> Optional["Deadline"]:
        """Deadline from a request dict's ``deadline_ms``, else None. A
        negative or NaN value is a client error (ValueError, wire 400)."""
        raw = payload.get("deadline_ms")
        if raw is None:
            return None
        budget = float(raw)
        if budget != budget or budget < 0:  # NaN or negative
            raise ValueError(f"deadline_ms must be >= 0, got {raw!r}")
        return cls.after_ms(budget)

    def expired(self) -> bool:
        return time.monotonic() >= self.at
