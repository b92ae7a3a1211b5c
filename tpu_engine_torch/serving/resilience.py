"""Resilience policies of the serving layer (the port's copy of what it
uses from ``tpu_engine/serving/resilience.py``): the global retry
budget, the hedge quantiles, the gateway's decision counters, the health
prober's state machine and the worker's admission controller.

- ``backoff_delay``: the wait before a failover attempt, exponential
  with jitter (0 with no base: immediate failover).
- ``RetryBudget``: retries allowed while the retries of a sliding window
  stay under ``ratio * requests + min_retries``; ``ratio=None`` is
  unlimited.
- ``LatencyTracker``: sliding-window latency quantiles (hedged dispatch's
  threshold, the AIMD limiter's baseline).
- ``ResilienceCounters``, ``FailoverCounters`` (stream resumes and the
  prober's ejections), ``MigrationCounters`` (migrate-mode drains and
  bounded drains that timed out), ``HandoffCounters`` (disaggregated
  serving), ``AffinityCounters`` (prefix-affinity routing) and
  ``PrefixDirCounters`` (the fleet prefix directory): every decision
  counted, under the JAX package's field names, so ``/stats`` blocks
  carry its keys; ``SPAN_FIELDS`` are the fields each paired with a
  gateway marker span.
- ``ProbeStateMachine``: ``fail_threshold`` consecutive failed probes
  eject a lane, any success restores it.
- ``AdmissionController``: the worker's bounded in-flight depth (static,
  or an ``AIMDLimit``'s), priority-tiered admission (``tier_fracs``), the
  deadline-aware early rejection of the miss path and the drain
  (lame-duck) mode.
"""

from __future__ import annotations

import bisect
import collections
import random
import threading
import time
from typing import Deque, Optional

from tpu_engine_torch.utils.deadline import (
    Deadline,
    DeadlineExceeded,
    Overloaded,
)


def tier_cap(limit: int, frac: float) -> int:
    """The tier-admission rule: a tier may occupy up to its fraction of
    the concurrency limit, floored at one slot. Shared by the worker's
    AdmissionController and the gateway's in-flight gauge
    (``overload.tier_limit``), so both shed at the same thresholds."""
    return max(1, int(limit * frac))


def backoff_delay(attempt: int, base_ms: float, max_ms: float,
                  jitter: float = 0.5,
                  rng: Optional[random.Random] = None) -> float:
    """Seconds to wait before failover attempt ``attempt`` (0-based):
    ``min(base * 2^attempt, max)`` spread uniformly over [1 - jitter,
    1 + jitter] of itself (jitter clamped to [0, 1], one ``random()``
    draw from ``rng`` or the module's generator). ``base_ms <= 0`` is 0.0,
    immediate failover."""
    if base_ms <= 0:
        return 0.0
    d_ms = min(float(base_ms) * (2.0 ** max(0, int(attempt))),
               float(max_ms))
    j = min(max(float(jitter), 0.0), 1.0)
    if j > 0:
        d_ms *= 1.0 - j + 2.0 * j * (rng or random).random()
    return d_ms / 1000.0


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


class LatencyTracker:
    """Latency quantiles over the last ``window`` samples (a sorted shadow
    list beside the ring)."""

    def __init__(self, window: int = 512):
        self.window = max(8, int(window))
        self._ring: Deque[float] = collections.deque()
        self._sorted: list = []
        self._lock = threading.Lock()

    def record(self, latency_s: float) -> None:
        v = float(latency_s)
        with self._lock:
            self._ring.append(v)
            bisect.insort(self._sorted, v)
            if len(self._ring) > self.window:
                old = self._ring.popleft()
                del self._sorted[bisect.bisect_left(self._sorted, old)]

    def __len__(self) -> int:
        return len(self._ring)

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile of the window, or None with no samples."""
        with self._lock:
            if not self._sorted:
                return None
            idx = min(len(self._sorted) - 1,
                      int(q * (len(self._sorted) - 1) + 0.5))
            return self._sorted[idx]


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


class FailoverCounters(ResilienceCounters):
    """Crash-tolerant streaming's decisions (the ``/stats`` ``failover``
    block): stream failures, resumes attempted, succeeded and failed,
    tokens replayed into resumes, and the prober's ejections and
    restores."""

    FIELDS = ("stream_failures", "resumes_attempted", "resumes_succeeded",
              "resumes_failed", "tokens_replayed", "prober_ejections",
              "prober_restores")


class MigrationCounters(ResilienceCounters):
    """Live stream migration's decisions (the ``/stats`` ``migration``
    block). Each field of ``SPAN_FIELDS`` pairs one to one with a gateway
    ``migration`` marker span; ``tokens_migrated`` (tokens carried across
    a splice) is a value with no span. ``drain_failures``: bounded drains
    that timed out or failed during ``remove_worker(drain=True)`` or a
    role flip (the membership change proceeds)."""

    FIELDS = ("migrations_attempted", "streams_migrated",
              "migration_fallbacks", "export_refusals",
              "destination_unavailable", "import_dispatch_failed",
              "tokens_migrated", "drain_failures")

    SPAN_FIELDS = ("migrations_attempted", "streams_migrated",
                   "migration_fallbacks", "export_refusals",
                   "destination_unavailable", "import_dispatch_failed",
                   "drain_failures")


class HandoffCounters(ResilienceCounters):
    """Disaggregated serving's decisions (the ``/stats`` ``handoff``
    block); each field of ``SPAN_FIELDS`` pairs one to one with a gateway
    ``kv_handoff`` marker span, ``tokens_handed_off`` is a value with no
    span. ``prefill_routed``: fresh generate dispatches sent to a
    prefill-capable lane (``prefill_unavailable``: none admitted, ring
    order took over). ``handoffs_attempted`` then exactly one of
    ``handoffs_spliced`` (the decode lane adopted the chain),
    ``export_refusals``, ``destination_unavailable``, ``dispatch_failed``
    (the source row decodes locally, or the relay replays) or
    ``handoff_fallbacks`` (exported but not spliced: the replay resume
    finished the stream). ``holds_cancelled``: source holds released;
    ``role_flips``: /admin/role flips."""

    FIELDS = ("prefill_routed", "prefill_unavailable",
              "handoffs_attempted", "handoffs_spliced",
              "export_refusals", "destination_unavailable",
              "dispatch_failed", "handoff_fallbacks", "holds_cancelled",
              "tokens_handed_off", "role_flips")

    SPAN_FIELDS = ("prefill_routed", "prefill_unavailable",
                   "handoffs_attempted", "handoffs_spliced",
                   "export_refusals", "destination_unavailable",
                   "dispatch_failed", "handoff_fallbacks",
                   "holds_cancelled", "role_flips")


class AffinityCounters(ResilienceCounters):
    """Prefix-affinity routing's decisions (the ``/stats`` ``affinity``
    block), each with an ``affinity`` marker span: ``affinity_routed``
    dispatches went to the fingerprint's lane; the others say why ring
    order took over (no full block to fingerprint, the lane ejected or
    its breaker open, it ran too hot, or a resume skipped it)."""

    FIELDS = ("affinity_routed", "no_fingerprint", "ejected_fallbacks",
              "imbalance_fallbacks", "resume_skips")


class PrefixDirCounters(ResilienceCounters):
    """The fleet prefix directory's decisions (the ``/stats``
    ``prefix_directory`` block); each field of ``SPAN_FIELDS`` pairs one
    to one with a gateway ``prefix_dir`` marker span. ``seeded``: prober
    sweeps that recorded entries from a lane's /health summaries (one
    span a sweep); ``recorded``: completions that made a lane the owner;
    ``invalidations``: a lane's entries voided (removal, eject, restore);
    ``hints_attached``; ``lookup_misses``. ``evictions`` (LRU drops) is a
    value with no span."""

    FIELDS = ("seeded", "recorded", "evictions", "invalidations",
              "hints_attached", "lookup_misses")

    SPAN_FIELDS = ("seeded", "recorded", "invalidations",
                   "hints_attached", "lookup_misses")


class ProbeStateMachine:
    """Per-lane eject/restore decisions from probe outcomes:
    ``fail_threshold`` consecutive failures eject a lane (once), any
    success restores an ejected lane and zeroes its failure run."""

    def __init__(self, fail_threshold: int = 3):
        self.fail_threshold = max(1, int(fail_threshold))
        self._fails: dict = {}     # lane -> consecutive probe failures
        self._ejected: set = set()
        self._lock = threading.Lock()

    def record(self, lane: str, ok: bool) -> Optional[str]:
        """One probe outcome: ``"eject"``, ``"restore"`` or None."""
        with self._lock:
            if ok:
                self._fails[lane] = 0
                if lane in self._ejected:
                    self._ejected.discard(lane)
                    return "restore"
                return None
            n = self._fails.get(lane, 0) + 1
            self._fails[lane] = n
            if n >= self.fail_threshold and lane not in self._ejected:
                self._ejected.add(lane)
                return "eject"
            return None

    def ejected(self, lane: str) -> bool:
        with self._lock:
            return lane in self._ejected

    def forget(self, lane: str) -> None:
        """Drop a removed lane's state (a later lane of that name starts
        clean)."""
        with self._lock:
            self._fails.pop(lane, None)
            self._ejected.discard(lane)


class AdmissionController:
    """Worker-side admission: bounded in-flight depth (``max_depth`` 0 =
    unbounded), deadline-aware early rejection and the drain mode.

    ``admit(deadline, tier)`` raises ``Overloaded`` when draining, at the
    limit or past the tier's share of it, and ``DeadlineExceeded`` when
    the deadline has passed; a successful admit is paired with
    ``release()``. ``check_deadline`` is the miss path's early rejection
    against the lane's service-time estimate.

    ``tier_fracs`` turns on tiered admission: tier t (below the top)
    admits only while depth < ``tier_cap(limit, fracs[t])``. ``limiter``
    (an ``AIMDLimit``) replaces the static ``max_depth``. Each
    overload-class shed counts in ``shed_overloaded`` and in its cause
    (``shed_depth``, ``shed_tier``, ``shed_adaptive``), which the raised
    ``Overloaded`` names as its ``cause``."""

    def __init__(self, max_depth: int = 0, node_id: str = "?",
                 tier_fracs: Optional[tuple] = None, limiter=None):
        self.max_depth = max(0, int(max_depth))
        self.node_id = node_id
        self._tier_fracs = tier_fracs
        self.limiter = limiter
        self._depth = 0
        self._draining = False
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self.shed_overloaded = 0
        self.shed_deadline = 0
        self.shed_draining = 0
        self.shed_depth = 0
        self.shed_tier = 0
        self.shed_adaptive = 0

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

    def effective_limit(self) -> int:
        """The limit in force: the adaptive limiter's, else the static
        cap (0 = unbounded)."""
        if self.limiter is not None:
            return self.limiter.limit
        return self.max_depth

    def admit(self, deadline: Optional[Deadline] = None,
              tier: Optional[int] = None) -> None:
        """``tier``: the request's priority tier (None, or no
        ``tier_fracs``: admitted against the full limit)."""
        limit = self.effective_limit()
        with self._lock:
            if self._draining:
                self.shed_draining += 1
                raise Overloaded(
                    f"lane {self.node_id} is draining (lame-duck)")
            if limit and self._depth >= limit:
                self.shed_overloaded += 1
                if self.limiter is not None:
                    self.shed_adaptive += 1
                    exc = Overloaded(
                        f"lane {self.node_id} at adaptive queue depth "
                        f"limit {limit}")
                    exc.cause = "adaptive"
                else:
                    self.shed_depth += 1
                    exc = Overloaded(
                        f"lane {self.node_id} at max queue depth "
                        f"{self.max_depth}")
                    exc.cause = "depth"
                raise exc
            if (limit and tier is not None and self._tier_fracs
                    and 0 <= tier < len(self._tier_fracs) - 1):
                cap = tier_cap(limit, self._tier_fracs[tier])
                if self._depth >= cap:
                    self.shed_overloaded += 1
                    self.shed_tier += 1
                    exc = Overloaded(
                        f"lane {self.node_id} shedding priority tier "
                        f"{tier} at depth {self._depth}/{limit}")
                    exc.cause = "tier"
                    raise exc
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
                    or self.shed_deadline or self.shed_draining
                    or self._tier_fracs is not None
                    or self.limiter is not None)

    def as_dict(self) -> dict:
        with self._lock:
            out = {"draining": self._draining,
                   "queue_depth": self._depth,
                   "max_queue_depth": self.max_depth,
                   "shed_overloaded": self.shed_overloaded,
                   "shed_deadline": self.shed_deadline,
                   "shed_draining": self.shed_draining}
            # The per-cause split only with an overload feature on: a
            # plain max_queue_depth lane keeps its key set.
            if self._tier_fracs is not None or self.limiter is not None:
                out["shed_depth"] = self.shed_depth
                out["shed_tier"] = self.shed_tier
                out["shed_adaptive"] = self.shed_adaptive
                if self.limiter is not None:
                    out["adaptive"] = self.limiter.as_dict()
            return out
