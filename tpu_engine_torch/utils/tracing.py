"""Distributed tracing for the port: span trees, trace propagation and the
device profiler (the port's own copy of ``tpu_engine/utils/tracing.py``,
with the same wire formats).

- `TraceContext`: a W3C-traceparent-style (trace_id, span_id) pair. Its
  wire form is one optional ``"traceparent"`` request field
  (``00-<32 hex>-<16 hex>-01``), re-parented at each hop: client ->
  gateway -> worker -> scheduler. A request without the field gets a
  trace id derived from its request_id at every hop (`derive_trace_id`),
  so a traceless request's spans correlate while its wire bytes stay
  those of the untraced protocol.
- `SpanRecorder`: a lock-guarded ring of spans, each with (trace_id,
  span_id, parent_id, start_ts) and free attrs. Request spans (``infer``,
  ``generate``, ...) and stage spans (``queue_wait``, ``device_compute``,
  ...) share the ring; ``summary()`` aggregates request spans only, and
  every span feeds a per-op `LatencyHistogram` (``utils.metrics``).
  ``capacity=0`` records nothing.
- `TraceSink`: (recorder, node, request_id, parent context) handed into
  the scheduler so it records stage spans without the serving layer.
- `export_chrome`, `spans_to_chrome`, `stitch_trace`: Chrome trace-event
  JSON (loadable in Perfetto) of one or more rings, and one stream's
  spans merged across lanes, with a synthetic ``evicted_parent`` root for
  every parent the ring evicted.
- `profiler_start` / `profiler_stop`: a ``torch.profiler`` session with
  the CPU and (on a CUDA host) CUDA activities, on the calling thread or
  on a thread of its own; the stop writes a Chrome trace into the
  session's ``log_dir`` and reports the file and its count of device
  events.

Span durations are host wall times: a span closes after the host sync its
path already makes, never after one of its own.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from tpu_engine_torch.utils.metrics import LatencyHistogram

# Request-level ops: one span per request. summary() aggregates these
# only, so its numbers stay per-request latencies.
_REQUEST_OPS = frozenset({"infer", "generate", "generate_stream", "score",
                          "route"})

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def derive_trace_id(request_id: str) -> str:
    """The trace id of a request without a traceparent: every hop derives
    the same id from the request_id, adding no byte to the wire."""
    return hashlib.md5(b"tpu-trace:"
                       + str(request_id).encode()).hexdigest()


class TraceContext:
    """One (trace_id, span_id) position in a trace tree. ``span_id`` is
    the current span: ``from_request`` gives the caller's (this hop's
    parent), ``child()`` mints this hop's own."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def from_request(cls, payload) -> Optional["TraceContext"]:
        """The request's ``traceparent`` field parsed; a missing or
        malformed value is None (traced as if absent, never an error)."""
        tp = payload.get("traceparent") if isinstance(payload, dict) else None
        if not isinstance(tp, str):
            return None
        m = _TRACEPARENT_RE.match(tp.strip().lower())
        if m is None:
            return None
        return cls(m.group(1), m.group(2))

    @classmethod
    def root(cls, request_id=None) -> "TraceContext":
        tid = (derive_trace_id(request_id) if request_id is not None
               else uuid.uuid4().hex)
        return cls(tid, new_span_id())

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, new_span_id())

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self) -> str:
        return f"TraceContext({self.to_traceparent()})"


class SpanRecorder:
    """Lock-guarded ring of spans plus per-op latency histograms.
    ``record(request_id, op, node, duration_us)`` takes the tree fields
    as keywords; ``capacity=0`` records nothing (histograms included)."""

    def __init__(self, capacity: int = 2048):
        self.capacity = int(capacity)
        self._spans = deque(maxlen=max(0, self.capacity))
        self._lock = threading.Lock()
        self._hists: Dict[str, LatencyHistogram] = {}

    def record(self, request_id: str, op: str, node: str, duration_us,
               *, cached: bool = False, batch_size: int = 1,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               start_ts: Optional[float] = None,
               attrs: Optional[dict] = None) -> None:
        if self.capacity <= 0:
            return
        span = {
            "request_id": request_id,
            "op": op,
            "node": node,
            "duration_us": int(duration_us),
            "cached": cached,
            "batch_size": batch_size,
            "ts": time.time(),
        }
        if trace_id is not None:
            span["trace_id"] = trace_id
        if span_id is not None:
            span["span_id"] = span_id
        if parent_id is not None:
            span["parent_id"] = parent_id
        if start_ts is not None:
            span["start_ts"] = start_ts
        if attrs:
            span["attrs"] = attrs
        hist = self._hists.get(op)
        with self._lock:
            self._spans.append(span)
            if hist is None:
                hist = self._hists.setdefault(op, LatencyHistogram())
        hist.observe(float(duration_us) / 1e6)

    def recent(self, n: int = 100) -> List[dict]:
        with self._lock:
            items = list(self._spans)
        return items[-n:]

    def snapshot(self) -> List[dict]:
        """Every span in the ring."""
        with self._lock:
            return list(self._spans)

    def summary(self) -> dict:
        """The ``/trace`` summary over request-level spans only (stage
        spans would count a request twice)."""
        items = [s for s in self.snapshot() if s["op"] in _REQUEST_OPS]
        if not items:
            return {"spans": 0}
        durs = sorted(s["duration_us"] for s in items)
        return {
            "spans": len(items),
            "cached": sum(1 for s in items if s["cached"]),
            "duration_us": {"p50": percentile(durs, 50),
                            "p90": percentile(durs, 90),
                            "p99": percentile(durs, 99),
                            "max": durs[-1]},
        }

    def stage_summary(self) -> dict:
        """Per-op count, mean and percentiles over every span in the
        ring: the stage breakdown of a lane."""
        by_op: Dict[str, List[int]] = {}
        for s in self.snapshot():
            by_op.setdefault(s["op"], []).append(s["duration_us"])
        out = {}
        for op, durs in sorted(by_op.items()):
            durs.sort()
            out[op] = {
                "count": len(durs),
                "mean_us": round(sum(durs) / len(durs), 1),
                "p50_us": percentile(durs, 50),
                "p90_us": percentile(durs, 90),
                "p99_us": percentile(durs, 99),
                "max_us": durs[-1],
            }
        return out

    def histograms(self) -> Dict[str, LatencyHistogram]:
        """The live per-op histograms (rendered by utils.metrics)."""
        with self._lock:
            return dict(self._hists)


class TraceSink:
    """Recorder and identity of one request, handed into the scheduler:
    ``stage`` records a child span of the request's worker-root span."""

    __slots__ = ("recorder", "node", "request_id", "ctx")

    def __init__(self, recorder: SpanRecorder, node: str, request_id: str,
                 ctx: TraceContext):
        self.recorder = recorder
        self.node = node
        self.request_id = request_id
        self.ctx = ctx

    def stage(self, op: str, duration_us: float,
              start_ts: Optional[float] = None, **attrs) -> None:
        child = self.ctx.child()
        self.recorder.record(
            self.request_id, op, self.node, duration_us,
            trace_id=child.trace_id, span_id=child.span_id,
            parent_id=self.ctx.span_id, start_ts=start_ts,
            attrs=attrs or None)


def percentile(vals: List, p: float):
    """Nearest-rank (ceil) percentile of ``vals`` (sorted here): the
    smallest value with at least p% of the samples at or below it; None
    for no samples."""
    if not vals:
        return None
    svals = sorted(vals)
    rank = math.ceil(p / 100.0 * len(svals))  # 1-based
    return svals[min(len(svals) - 1, max(0, rank - 1))]


def _span_start_ts(s: dict) -> float:
    start = s.get("start_ts")
    if start is None:  # a span stamped with its end only
        start = s["ts"] - s["duration_us"] / 1e6
    return start


def _span_event(s: dict, tid: int) -> dict:
    args = {"request_id": s["request_id"]}
    for k in ("trace_id", "span_id", "parent_id", "cached",
              "batch_size"):
        if k in s:
            args[k] = s[k]
    args.update(s.get("attrs") or {})
    return {
        "name": s["op"], "cat": "serving", "ph": "X",
        "ts": _span_start_ts(s) * 1e6,
        "dur": max(0, int(s["duration_us"])),
        "pid": 1, "tid": tid, "args": args,
    }


def _synthesize_evicted_roots(events: List[dict]) -> List[dict]:
    """One zero-duration ``evicted_parent`` event for every parent id no
    event carries (the ring evicted the parent, its children survive),
    claiming that span id at its earliest child's start, so the exported
    tree stays connected and the gap is labelled."""
    seen = set()
    for ev in events:
        sid = ev.get("args", {}).get("span_id")
        if sid is not None:
            seen.add(sid)
    dangling: Dict[str, dict] = {}
    for ev in events:
        args = ev.get("args", {})
        pid = args.get("parent_id")
        if pid is None or pid in seen:
            continue
        prev = dangling.get(pid)
        if prev is None or ev["ts"] < prev["ts"]:
            dangling[pid] = {
                "name": "evicted_parent", "cat": "serving", "ph": "X",
                "ts": ev["ts"], "dur": 0, "pid": 1, "tid": ev["tid"],
                "args": {
                    "request_id": args.get("request_id"),
                    "span_id": pid,
                    "evicted_parent": True,
                    **({"trace_id": args["trace_id"]}
                       if "trace_id" in args else {}),
                },
            }
    return [dangling[k] for k in sorted(dangling)]


def spans_to_chrome(named_spans: Dict[str, List[dict]]) -> dict:
    """Chrome trace-event JSON of named span lists: one tid per name
    (named by a thread_name metadata event), an ``X`` event per span with
    the tree ids in ``args``, and the synthetic ``evicted_parent``
    roots."""
    events: List[dict] = []
    for tid, name in enumerate(sorted(named_spans), start=1):
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": name}})
        for s in named_spans[name]:
            events.append(_span_event(s, tid))
    events.extend(_synthesize_evicted_roots(events))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome(recorders: Dict[str, SpanRecorder]) -> dict:
    """Chrome trace-event JSON of every recorder's ring, one tid per
    node."""
    return spans_to_chrome(
        {node: rec.snapshot() for node, rec in recorders.items()})


def stitch_trace(fragments: Dict[str, List[dict]], request_id: str,
                 trace_id: Optional[str] = None) -> dict:
    """One stream's spans merged across lanes. ``fragments`` maps a lane
    name to its spans; a span belongs to the stream when its request_id
    matches or its trace_id is ``trace_id`` (default: the id derived from
    ``request_id``). Returns the merged spans in start order, the lanes
    that contributed, the count of spans whose parent is missing (before
    any synthetic root) and the Chrome rendering."""
    tid = trace_id or derive_trace_id(request_id)
    picked: Dict[str, List[dict]] = {}
    for lane, spans in fragments.items():
        mine = [s for s in spans
                if s.get("request_id") == request_id
                or s.get("trace_id") == tid]
        if mine:
            picked[lane] = mine
    all_spans = [dict(s, lane=lane)
                 for lane, spans in sorted(picked.items())
                 for s in spans]
    all_spans.sort(key=_span_start_ts)
    have = {s["span_id"] for s in all_spans if "span_id" in s}
    orphans = sum(1 for s in all_spans
                  if s.get("parent_id") is not None
                  and s["parent_id"] not in have)
    return {
        "request_id": request_id,
        "trace_id": tid,
        "lanes": sorted(picked),
        "spans": all_spans,
        "orphans": orphans,
        "chrome": spans_to_chrome(picked),
    }


# -- the device profiler ------------------------------------------------------
#
# Kineto keeps a session's state on the thread that enabled it: it records
# that thread's CPU ops (and every kernel on the card, whatever thread
# launched it) and refuses to be disabled from another thread. A session
# opened ``on_caller`` belongs to the calling thread, which must stop it;
# any other session lives on a thread of its own, so any thread may stop
# it (its trace then holds the card's kernels, not other threads' CPU
# ops).

_profile_lock = threading.Lock()
_profile_session: Optional[dict] = None

# Chrome-trace categories of work that ran on the card.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _open():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _close(prof, log_dir: str, t0: float) -> dict:
    """Wait for the card's queued work (the last kernels' events complete),
    end the session, write its Chrome trace as ``<log_dir>/trace_<ms>.json``
    and report the file, its events and its device events."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{int(t0 * 1e3)}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents") or []
    device = sum(1 for ev in events if ev.get("cat") in DEVICE_EVENT_CATS)
    return {"ok": True, "log_dir": log_dir, "trace_file": path,
            "events": len(events), "device_events": device}


def _session_thread(log_dir: str, started: threading.Event,
                    stop: threading.Event, box: dict) -> None:
    t0 = time.time()
    try:
        prof = _open()
    except Exception as exc:  # reported by profiler_start
        box["result"] = {"error": f"profiler failed to start: {exc}"}
        started.set()
        return
    started.set()
    stop.wait()
    try:
        box["result"] = _close(prof, log_dir, t0)
    except Exception as exc:
        box["result"] = {"error": f"profiler failed to stop: {exc}"}


def profiler_start(log_dir: str, on_caller: bool = False) -> dict:
    """Begin a ``torch.profiler`` session (CPU activity, and CUDA when a
    card is present) that ``profiler_stop`` ends: on the calling thread
    with ``on_caller`` (which must then stop it), else on a thread of its
    own. One session at a time per process."""
    global _profile_session
    with _profile_lock:
        if _profile_session is not None:
            return {"error": "profiler already running -> "
                             f"{_profile_session['log_dir']}"}
        session = {"log_dir": log_dir, "t0": time.time()}
        if on_caller:
            try:
                session["prof"] = _open()
            except Exception as exc:
                return {"error": f"profiler failed to start: {exc}"}
            session["owner"] = threading.get_ident()
        else:
            started, stop, box = threading.Event(), threading.Event(), {}
            thread = threading.Thread(
                target=_session_thread, args=(log_dir, started, stop, box),
                name="profiler-session", daemon=True)
            thread.start()
            started.wait()
            if "result" in box:  # it failed to start
                return box["result"]
            session.update(thread=thread, stop=stop, box=box)
        _profile_session = session
    return {"ok": True, "log_dir": log_dir}


def profiler_stop() -> dict:
    """End the running session and report its trace (``_close``)."""
    global _profile_session
    with _profile_lock:
        session = _profile_session
        if session is None:
            return {"error": "profiler not running"}
        owner = session.get("owner")
        if owner is not None and owner != threading.get_ident():
            return {"error": "the profiler session belongs to another "
                             "thread, which must stop it"}
        _profile_session = None
    if owner is not None:
        return _close(session["prof"], session["log_dir"], session["t0"])
    session["stop"].set()
    session["thread"].join()
    return session["box"]["result"]
