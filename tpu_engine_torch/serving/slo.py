"""SLO burn-rate accounting over the existing latency histograms (the
port's own copy of ``tpu_engine/serving/slo.py``).

The reference has no latency objectives at all — its benchmark prints
means and walks away. The serving layer already *measures* everything an
objective needs: TTFT and inter-token latency feed per-lane
``LatencyHistogram``s (``tpu_engine_ttft/itl_seconds``) and every
request-level span feeds the per-op histograms in ``SpanRecorder``. This
module adds the *accounting*: declarative objectives
(``--slo-ttft-p99-ms`` / ``--slo-itl-p99-ms`` / ``--slo-completion-p99-ms``)
are evaluated against those histograms — no new measurement path, no new
per-request work — and a sliding window turns them into the SRE-standard
error-budget burn rate.

Math (documented in DESIGN.md "Observability plane"):

- An objective is (threshold_ms, target) — "``target`` of samples must
  finish under ``threshold_ms``". The error budget is ``1 - target``.
- ``violations`` = samples above the largest histogram bucket boundary
  ≤ the threshold (bucket quantization: the effective threshold is that
  boundary; with the default log-spaced buckets it is within ~2.5x and
  the /admin/slo payload reports the boundary actually used).
- Burn rate = (windowed violation fraction) / (error budget): 1.0 means
  the fleet is burning budget exactly at the sustainable rate; 2.0 means
  the budget exhausts in half the period; 0 = no violations.

Bounded state: one (ts, count, violations) tuple per objective per
status() call, pruned to the window — the tracker samples when scraped
(/admin/slo, /stats, the autoscaler feed), not on a timer of its own.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

# Objective key -> the named-histogram family it reads (TTFT / ITL are
# decode-lane measurements; completion reads the gateway's own
# request-level op histograms instead — see completion_hists()).
OBJECTIVE_SOURCES = {
    "ttft": "tpu_engine_ttft_seconds",
    "itl": "tpu_engine_itl_seconds",
    "completion": None,
}

# Request-level ops whose per-op histograms constitute "completion":
# full client-visible latency of a generate stream at gateway scope.
COMPLETION_OPS = ("generate", "generate_stream")


def violations_over(snapshot: dict, threshold_s: float) -> Tuple[int, float]:
    """(violations, effective_threshold_s) for one histogram snapshot:
    samples above the largest bucket boundary ≤ the threshold. Cumulative
    buckets make this one subtraction; the effective threshold reported
    is the boundary actually used (bucket quantization is explicit, not
    silent)."""
    le = snapshot["le"]
    idx = bisect.bisect_right(le, threshold_s) - 1
    if idx < 0:
        # Threshold below the first bucket: every sample counts against.
        return snapshot["count"], 0.0
    return (snapshot["count"] - snapshot["cumulative"][idx], le[idx])


class SloTracker:
    """Windowed error-budget burn over declarative latency objectives.

    Construction reads the ``slo_*`` gateway config fields; with no
    objective set the gateway never constructs one (the house
    defaults-off rule: no tracker, no /stats block, no metrics family).
    """

    def __init__(self, objectives_ms: Dict[str, float], target: float,
                 window_s: float):
        # name -> threshold in SECONDS (config speaks ms, hists seconds).
        self.objectives = {name: ms / 1e3
                           for name, ms in objectives_ms.items() if ms > 0}
        self.target = float(target)
        self.budget = max(1e-9, 1.0 - self.target)
        self.window_s = float(window_s)
        # name -> deque[(ts, count, violations)], pruned to window_s.
        self._samples: Dict[str, deque] = {
            name: deque() for name in self.objectives}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config) -> Optional["SloTracker"]:
        objectives = {
            "ttft": getattr(config, "slo_ttft_p99_ms", 0.0),
            "itl": getattr(config, "slo_itl_p99_ms", 0.0),
            "completion": getattr(config, "slo_completion_p99_ms", 0.0),
        }
        if not any(v > 0 for v in objectives.values()):
            return None
        return cls(objectives, config.slo_target, config.slo_window_s)

    def status(self, hists_by_objective: Dict[str, Iterable]) -> dict:
        """Evaluate every objective against the given histograms (any
        object with ``snapshot()``), record one window sample, and return
        the /admin/slo payload. Callers own histogram gathering — this
        module never imports the serving topology."""
        now = time.time()
        out: Dict[str, dict] = {}
        with self._lock:
            for name, thr in sorted(self.objectives.items()):
                count = violations = 0
                effective = 0.0
                for h in hists_by_objective.get(name) or ():
                    snap = h.snapshot()
                    v, eff = violations_over(snap, thr)
                    count += snap["count"]
                    violations += v
                    effective = eff or effective
                ring = self._samples[name]
                ring.append((now, count, violations))
                while ring and ring[0][0] < now - self.window_s:
                    ring.popleft()
                t0, c0, v0 = ring[0]
                d_count = count - c0
                d_viol = violations - v0
                frac = (d_viol / d_count) if d_count > 0 else 0.0
                good = (1.0 - violations / count) if count else None
                out[name] = {
                    "objective_ms": round(thr * 1e3, 3),
                    "effective_threshold_ms": round(effective * 1e3, 3),
                    "samples": count,
                    "violations": violations,
                    "good_fraction": (round(good, 6)
                                      if good is not None else None),
                    "window_s": round(min(self.window_s, now - t0), 1),
                    "window_samples": d_count,
                    "window_violations": d_viol,
                    "burn_rate": round(frac / self.budget, 4),
                }
        return {
            "target": self.target,
            "error_budget": round(self.budget, 6),
            "window_s": self.window_s,
            "objectives": out,
        }

    @staticmethod
    def pressure(status: dict) -> float:
        """Autoscaler feed: the worst objective's burn mapped into the
        [0, 1] pressure scale the fleet controller speaks. burn 2.0 (the
        classic page-now threshold) saturates to 1.0; burn 0 = no
        pressure — so the feed can only ADD pressure, never mask lane
        saturation (the controller takes max(lane, slo))."""
        worst = 0.0
        for obj in (status.get("objectives") or {}).values():
            if obj.get("window_samples"):
                worst = max(worst, obj.get("burn_rate", 0.0))
        return min(1.0, worst / 2.0)


def completion_hists(recorders: Iterable) -> List:
    """The 'completion' objective's histogram set: request-level
    generate-op histograms from span recorders (gateway scope — full
    client-visible latency including failover/handoff/migration time)."""
    out = []
    for rec in recorders:
        hists = rec.histograms()
        for op in COMPLETION_OPS:
            if op in hists:
                out.append(hists[op])
    return out
