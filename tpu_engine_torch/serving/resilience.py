"""Resilience policies of the serving layer (the port's copy of what it
uses from ``tpu_engine/serving/resilience.py``): the global retry
budget, the gateway's decision counters and the worker's admission
controller.

- ``RetryBudget``: retries allowed while the retries of a sliding window
  stay under ``ratio * requests + min_retries``; ``ratio=None`` is
  unlimited.
- ``ResilienceCounters`` (and ``MigrationCounters``, whose
  ``drain_failures`` counts bounded drains that timed out): every
  decision counted, under the JAX package's field names, so ``/stats``
  blocks carry its keys.
- ``AdmissionController``: the worker's bounded in-flight depth, the
  deadline-aware early rejection of the miss path and the drain
  (lame-duck) mode. Tiered and adaptive admission (``tier_fracs``,
  ``limiter``) are not ported and refuse by name.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Optional

from tpu_engine_torch.utils.deadline import (
    Deadline,
    DeadlineExceeded,
    Overloaded,
)


class RetryBudget:
    """Global retry budget over a sliding window of ``window_s`` seconds;
    ``ratio=None`` disables it. Thread-safe."""

    def __init__(self, ratio: Optional[float], min_retries: int = 10,
                 window_s: float = 10.0):
        self.ratio = None if ratio is None else max(0.0, float(ratio))
        self.min_retries = max(0, int(min_retries))
        self.window_s = float(window_s)
        self._requests: Deque[float] = collections.deque()
        self._retries: Deque[float] = collections.deque()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.ratio is not None

    def _gc(self, now: float) -> None:
        horizon = now - self.window_s
        for dq in (self._requests, self._retries):
            while dq and dq[0] < horizon:
                dq.popleft()

    def record_request(self) -> None:
        if self.ratio is None:
            return
        now = time.monotonic()
        with self._lock:
            self._gc(now)
            self._requests.append(now)

    def try_acquire(self) -> bool:
        """True (and the retry recorded) while the budget allows one more
        retry; False: the caller must not retry."""
        if self.ratio is None:
            return True
        now = time.monotonic()
        with self._lock:
            self._gc(now)
            allowed = self.ratio * len(self._requests) + self.min_retries
            if len(self._retries) + 1 > allowed:
                return False
            self._retries.append(now)
            return True

    def stats(self) -> dict:
        with self._lock:
            return {"window_requests": len(self._requests),
                    "window_retries": len(self._retries),
                    "ratio": self.ratio}


class ResilienceCounters:
    """The gateway's resilience decisions, counted; ``any_nonzero`` gates
    the ``/stats`` ``resilience`` block."""

    FIELDS = ("deadline_rejected", "deadline_expired", "retries",
              "retry_budget_exhausted", "backoff_waits", "hedges",
              "hedge_wins", "hedge_losses", "shed_overloaded")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {f: 0 for f in self.FIELDS}

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._c[field] += n

    def get(self, field: str) -> int:
        with self._lock:
            return self._c[field]

    def any_nonzero(self) -> bool:
        with self._lock:
            return any(self._c.values())

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._c)


class MigrationCounters(ResilienceCounters):
    """The ``/stats`` ``migration`` block's fields. Stream migration is
    not ported, so only ``drain_failures`` (a bounded drain that timed
    out or failed during ``remove_worker(drain=True)``) ever moves."""

    FIELDS = ("migrations_attempted", "streams_migrated",
              "migration_fallbacks", "export_refusals",
              "destination_unavailable", "import_dispatch_failed",
              "tokens_migrated", "drain_failures")


class AdmissionController:
    """Worker-side admission: bounded in-flight depth (``max_depth`` 0 =
    unbounded), deadline-aware early rejection and the drain mode.

    ``admit(deadline)`` raises ``Overloaded`` when draining or at depth
    and ``DeadlineExceeded`` when the deadline has passed; a successful
    admit is paired with ``release()``. ``check_deadline`` is the miss
    path's early rejection against the lane's service-time estimate."""

    def __init__(self, max_depth: int = 0, node_id: str = "?",
                 tier_fracs: Optional[tuple] = None, limiter=None):
        if tier_fracs is not None:
            raise NotImplementedError(
                "priority-tiered admission (tier_fracs, "
                "serving/overload.py) is not yet ported to "
                "tpu_engine_torch")
        if limiter is not None:
            raise NotImplementedError(
                "adaptive admission (limiter, AIMDLimit in "
                "serving/overload.py) is not yet ported to "
                "tpu_engine_torch")
        self.max_depth = max(0, int(max_depth))
        self.node_id = node_id
        self._depth = 0
        self._draining = False
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self.shed_overloaded = 0
        self.shed_deadline = 0
        self.shed_draining = 0

    # -- drain (lame-duck) ----------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> str:
        """Refuse new admissions; ``"draining"``, or
        ``"already-draining"`` on a repeat."""
        with self._lock:
            if self._draining:
                return "already-draining"
            self._draining = True
            return "draining"

    def undrain(self) -> str:
        """``"undrained"``, or ``"not-draining"`` when there was no
        drain to lift."""
        with self._lock:
            if not self._draining:
                return "not-draining"
            self._draining = False
            return "undrained"

    def wait_idle(self, timeout_s: float = 10.0) -> bool:
        """Block until nothing is in flight (True) or ``timeout_s``
        passes (False)."""
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self._depth > 0:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._idle.wait(timeout=rem)
            return True

    # -- admission ------------------------------------------------------------

    def admit(self, deadline: Optional[Deadline] = None) -> None:
        with self._lock:
            if self._draining:
                self.shed_draining += 1
                raise Overloaded(
                    f"lane {self.node_id} is draining (lame-duck)")
            if self.max_depth and self._depth >= self.max_depth:
                self.shed_overloaded += 1
                raise Overloaded(f"lane {self.node_id} at max queue depth "
                                 f"{self.max_depth}")
            if deadline is not None and deadline.expired():
                self.shed_deadline += 1
                raise DeadlineExceeded("deadline exceeded at admission")
            self._depth += 1

    def check_deadline(self, deadline: Optional[Deadline],
                       est_service_s: Optional[float] = None) -> None:
        """Early rejection before a miss enters a batch: a spent budget
        is ``DeadlineExceeded``; a live budget under the lane's estimate
        is ``Overloaded`` (another lane may answer it from its cache)."""
        if deadline is None:
            return
        rem = deadline.remaining_s()
        if rem <= 0:
            with self._lock:
                self.shed_deadline += 1
            raise DeadlineExceeded("deadline expired before dispatch")
        if est_service_s is not None and rem < est_service_s:
            with self._lock:
                self.shed_deadline += 1
            raise Overloaded(
                f"lane {self.node_id} cannot meet the deadline "
                f"(remaining {rem * 1e3:.0f} ms < estimated service "
                f"{est_service_s * 1e3:.0f} ms)")

    def release(self) -> None:
        with self._idle:
            self._depth = max(0, self._depth - 1)
            if self._depth == 0:
                self._idle.notify_all()

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def active(self) -> bool:
        """Whether there is anything to report: gates ``/health``'s
        ``admission`` block."""
        return bool(self.max_depth or self._draining or self.shed_overloaded
                    or self.shed_deadline or self.shed_draining)

    def as_dict(self) -> dict:
        with self._lock:
            return {"draining": self._draining,
                    "queue_depth": self._depth,
                    "max_queue_depth": self.max_depth,
                    "shed_overloaded": self.shed_overloaded,
                    "shed_deadline": self.shed_deadline,
                    "shed_draining": self.shed_draining}
