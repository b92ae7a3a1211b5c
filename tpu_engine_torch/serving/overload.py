"""Overload control (the port's copy of ``tpu_engine/serving/overload.py``):
the decisions that keep goodput flat when offered load exceeds capacity.
Pure host logic with the JAX module's clocks (``time.monotonic``) and
arithmetic; the gateway and the worker own the wiring and the control
loop. All of it is off by default.

- **Priority tiers** (``parse_priority``, ``tier_limit``): a request's
  optional ``"priority"`` field (``interactive`` > ``batch`` >
  ``background``); under pressure each tier admits only up to its
  fraction of the concurrency limit, so the lowest tier sheds first.
- **Per-tenant token bucket** (``TenantRateLimiter``): one tenant's burst
  cannot starve another's; a refusal carries the bucket's refill time.
- **AIMD concurrency limit** (``AIMDLimit``): additive increase while
  latency stays within ``tolerance`` x the window's 0.1-quantile,
  multiplicative decrease (once per ``cooldown_s``) past it.
- **Load-derived Retry-After** (``load_retry_after``): monotone in the
  measured pressure, never below the configured base.
- **Staged brownout** (``BrownoutController``): a ladder walked with
  hysteresis over saturation signals: shrink the mixed token budget,
  suspend speculative drafting, defer host-tier swap-ins, clamp low-tier
  token budgets; restored in reverse as pressure clears.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional, Tuple

from tpu_engine_torch.serving.resilience import (
    LatencyTracker,
    ResilienceCounters,
    tier_cap,
)

# -- priority tiers -----------------------------------------------------------

# Higher number = higher priority = shed last. Background sheds once the
# lane or gateway is 70% full, batch at 85%, interactive only at the
# full limit.
PRIORITY_TIERS: Dict[str, int] = {"background": 0, "batch": 1,
                                  "interactive": 2}
TIER_NAMES: Tuple[str, ...] = ("background", "batch", "interactive")
TOP_TIER: int = PRIORITY_TIERS["interactive"]
TIER_ADMIT_FRAC: Tuple[float, ...] = (0.70, 0.85, 1.0)


def parse_priority(payload: dict, default: str = "interactive") -> int:
    """The request's priority tier: an absent field is ``default`` (old
    clients are never deprioritized); an unknown value is a ValueError
    (wire 400)."""
    raw = payload.get("priority", default)
    tier = PRIORITY_TIERS.get(str(raw))
    if tier is None:
        raise ValueError(
            f"priority must be one of {sorted(PRIORITY_TIERS)}, got {raw!r}")
    return tier


def tier_limit(limit: int, tier: int) -> int:
    """Admitted-depth ceiling of ``tier`` under a concurrency ``limit``
    (``tier_cap`` over the tier table)."""
    return tier_cap(limit, TIER_ADMIT_FRAC[max(0, min(tier, TOP_TIER))])


def load_retry_after(base_s: float, pressure: float,
                     max_s: float = 30.0) -> float:
    """Client back-off under ``pressure`` (0 idle, 1 at the limit, > 1
    over it): ``base * (1 + pressure)`` clamped to ``max_s``."""
    p = max(0.0, float(pressure))
    return min(float(max_s), float(base_s) * (1.0 + p))


# -- per-tenant token bucket --------------------------------------------------

class TenantRateLimiter:
    """Per-tenant token buckets: ``rate`` requests/s sustained, ``burst``
    tokens deep (0 = 2x rate, at least 1). Buckets refill lazily from
    monotonic time; tenants idle past ``idle_evict_s`` are forgotten (a
    full bucket holds nothing worth keeping)."""

    def __init__(self, rate: float, burst: float = 0.0,
                 idle_evict_s: float = 300.0):
        self.rate = max(1e-6, float(rate))
        self.burst = float(burst) if burst > 0 else max(1.0, 2.0 * self.rate)
        self.idle_evict_s = float(idle_evict_s)
        self._buckets: Dict[str, list] = {}  # tenant -> [tokens, last_ts]
        self._lock = threading.Lock()

    def allow(self, tenant: str) -> Tuple[bool, float]:
        """Draw one token for ``tenant``: ``(admitted, retry_after_s)``,
        the hint being the time until one token refills (0.0 when
        admitted)."""
        now = time.monotonic()
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = [self.burst, now]
                if len(self._buckets) % 64 == 0:
                    self._evict_idle(now)
            tokens = min(self.burst, b[0] + (now - b[1]) * self.rate)
            b[1] = now
            if tokens >= 1.0:
                b[0] = tokens - 1.0
                return True, 0.0
            b[0] = tokens
            return False, (1.0 - tokens) / self.rate

    def _evict_idle(self, now: float) -> None:
        """Caller holds the lock."""
        horizon = now - self.idle_evict_s
        for t in [t for t, b in self._buckets.items() if b[1] < horizon]:
            del self._buckets[t]

    def tenants(self) -> int:
        with self._lock:
            return len(self._buckets)


# -- AIMD adaptive concurrency ------------------------------------------------

class AIMDLimit:
    """Adaptive concurrency limit: ``+1/limit`` per observation within
    ``tolerance`` x the window's 0.1-quantile, ``x decrease`` (at most
    once per ``cooldown_s``) past it, within [min_limit, max_limit].
    Nothing moves before ``min_samples`` observations."""

    def __init__(self, min_limit: int = 1, max_limit: int = 64,
                 start: Optional[int] = None, tolerance: float = 2.0,
                 decrease: float = 0.7, window: int = 256,
                 min_samples: int = 10, cooldown_s: float = 1.0):
        self.min_limit = max(1, int(min_limit))
        self.max_limit = max(self.min_limit, int(max_limit))
        self.tolerance = max(1.0, float(tolerance))
        self.decrease = min(0.99, max(0.1, float(decrease)))
        self.min_samples = max(2, int(min_samples))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._tracker = LatencyTracker(window)
        self._limit = float(min(self.max_limit,
                                max(self.min_limit,
                                    start if start is not None
                                    else (self.min_limit
                                          + self.max_limit) // 2)))
        # -inf: no decrease has happened, so none is cooling down (the
        # monotonic clock counts from boot).
        self._last_decrease = -float("inf")
        self._increases = 0
        self._decreases = 0
        self._lock = threading.Lock()

    def observe(self, latency_s: float) -> None:
        baseline = self._tracker.quantile(0.1)
        n = len(self._tracker)
        self._tracker.record(latency_s)
        if baseline is None or n < self.min_samples:
            return
        with self._lock:
            if latency_s > self.tolerance * baseline:
                now = time.monotonic()
                if now - self._last_decrease >= self.cooldown_s:
                    self._limit = max(float(self.min_limit),
                                      self._limit * self.decrease)
                    self._last_decrease = now
                    self._decreases += 1
            else:
                self._limit = min(float(self.max_limit),
                                  self._limit + 1.0 / max(1.0, self._limit))
                self._increases += 1

    @property
    def limit(self) -> int:
        with self._lock:
            return int(self._limit)

    def as_dict(self) -> dict:
        with self._lock:
            return {"limit": int(self._limit),
                    "min": self.min_limit, "max": self.max_limit,
                    "increases": self._increases,
                    "decreases": self._decreases}


# -- staged brownout ----------------------------------------------------------

# The ladder in engagement order; each stage keeps the earlier stages'
# measures: 1 budget (shrink the mixed per-tick token budget), 2 spec_off
# (suspend speculative drafting), 3 swap_defer (defer host-tier
# swap-ins), 4 clamp (clamp max_new_tokens below the top tier).
BROWNOUT_STAGES: Tuple[str, ...] = ("normal", "budget", "spec_off",
                                    "swap_defer", "clamp")
BROWNOUT_MAX_STAGE: int = len(BROWNOUT_STAGES) - 1
# Mixed-step token budget multiplier while stage >= 1.
BROWNOUT_BUDGET_FRAC: float = 0.5


class BrownoutController:
    """The ladder's state machine. ``evaluate`` takes named saturation
    components normalized so 1.0 is the red line; pressure is their max.
    One stage up after ``up_hold`` consecutive evaluations at or above
    ``high``, one down after ``down_hold`` at or below ``low``; anything
    between resets both runs and holds the stage."""

    def __init__(self, high: float = 0.85, low: float = 0.5,
                 up_hold: int = 2, down_hold: int = 4,
                 max_stage: int = BROWNOUT_MAX_STAGE):
        if not 0.0 <= low < high:
            raise ValueError(f"need 0 <= low < high, got low={low} "
                             f"high={high}")
        self.high = float(high)
        self.low = float(low)
        self.up_hold = max(1, int(up_hold))
        self.down_hold = max(1, int(down_hold))
        self.max_stage = max(1, min(int(max_stage), BROWNOUT_MAX_STAGE))
        self._stage = 0
        self._over = 0
        self._under = 0
        self._escalations = 0
        self._restores = 0
        self._pressure = 0.0
        self._binding = ""
        self._lock = threading.Lock()

    def evaluate(self, components: Dict[str, float]) -> Optional[str]:
        """One control-loop sample: ``"escalate"`` or ``"restore"`` when
        the stage moved, else None."""
        pressure, binding = 0.0, ""
        for name, v in components.items():
            v = max(0.0, float(v))
            if v > pressure:
                pressure, binding = v, name
        with self._lock:
            self._pressure = pressure
            self._binding = binding
            if pressure >= self.high:
                self._under = 0
                self._over += 1
                if self._over >= self.up_hold and self._stage < self.max_stage:
                    self._stage += 1
                    self._over = 0
                    self._escalations += 1
                    return "escalate"
            elif pressure <= self.low:
                self._over = 0
                self._under += 1
                if self._under >= self.down_hold and self._stage > 0:
                    self._stage -= 1
                    self._under = 0
                    self._restores += 1
                    return "restore"
            else:
                self._over = 0
                self._under = 0
            return None

    @property
    def stage(self) -> int:
        with self._lock:
            return self._stage

    def as_dict(self) -> dict:
        with self._lock:
            return {"stage": self._stage,
                    "stage_name": BROWNOUT_STAGES[self._stage],
                    "pressure": round(self._pressure, 4),
                    "binding_signal": self._binding,
                    "escalations": self._escalations,
                    "restores": self._restores}


# -- counters -----------------------------------------------------------------

class OverloadCounters(ResilienceCounters):
    """The gateway's overload decisions (the ``/stats`` ``overload``
    block): ``rate_limited`` (the tenant's bucket refused), ``shed_tier``
    (a below-top tier refused past its fraction of the in-flight gauge),
    ``shed_depth`` (the gauge at its full limit refused even the top
    tier)."""

    FIELDS = ("rate_limited", "shed_tier", "shed_depth")


class SheddingStats:
    """Sliding-window shed rate, the Retry-After pressure when no
    in-flight gauge is configured: sheds / requests over ``window_s``."""

    def __init__(self, window_s: float = 10.0):
        self.window_s = float(window_s)
        self._requests: Deque[float] = collections.deque()
        self._sheds: Deque[float] = collections.deque()
        self._lock = threading.Lock()

    def _gc(self, now: float) -> None:
        horizon = now - self.window_s
        for dq in (self._requests, self._sheds):
            while dq and dq[0] < horizon:
                dq.popleft()

    def record(self, shed: bool) -> None:
        now = time.monotonic()
        with self._lock:
            self._gc(now)
            self._requests.append(now)
            if shed:
                self._sheds.append(now)

    def pressure(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._gc(now)
            if not self._requests:
                return 0.0
            return len(self._sheds) / len(self._requests)
