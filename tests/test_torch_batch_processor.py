"""The port's dynamic batcher (tpu_engine_torch.runtime.batch_processor):
the cases of tests/test_batch_processor.py run on the port's copy, and its
split-phase pipeline (pipeline_depth batches in flight, the ready probe),
the deadline drop and the observer; the metrics and the pipeline also on
the JAX package's class with the same callbacks."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from tpu_engine.runtime.batch_processor import BatchProcessor as JaxBP
from tpu_engine_torch.runtime.batch_processor import (
    BatchProcessor,
    BatchTiming,
)
from tpu_engine_torch.utils.deadline import Deadline, DeadlineExceeded


def make(callback, max_batch=4, timeout_ms=30, cls=BatchProcessor, **kw):
    bp = cls(max_batch, timeout_ms, callback, **kw)
    bp.start()
    return bp


def test_single_request_roundtrip():
    bp = make(lambda reqs: [r * 2 for r in reqs])
    try:
        assert bp.process(21) == 42
    finally:
        bp.stop()


def test_batches_form_under_concurrency():
    seen_sizes = []
    gate = threading.Event()

    def cb(reqs):
        seen_sizes.append(len(reqs))
        gate.wait(0.2)  # hold the first batch so others pile up
        return [r + 1 for r in reqs]

    bp = make(cb, max_batch=8, timeout_ms=50)
    try:
        with ThreadPoolExecutor(16) as ex:
            futs = [ex.submit(bp.process, i) for i in range(16)]
            time.sleep(0.05)
            gate.set()
            results = sorted(f.result(timeout=5) for f in futs)
        assert results == [i + 1 for i in range(16)]
        assert max(seen_sizes) > 1
        assert sum(seen_sizes) == 16
    finally:
        bp.stop()


def test_max_batch_size_respected():
    sizes = []
    hold = threading.Event()

    def cb(reqs):
        sizes.append(len(reqs))
        hold.wait(0.1)
        return reqs

    bp = make(cb, max_batch=4, timeout_ms=20)
    try:
        with ThreadPoolExecutor(12) as ex:
            futs = [ex.submit(bp.process, i) for i in range(12)]
            time.sleep(0.03)
            hold.set()
            for f in futs:
                f.result(timeout=5)
        assert all(s <= 4 for s in sizes) and sum(sizes) == 12
    finally:
        bp.stop()


def test_callback_exception_fans_out():
    def cb(reqs):
        raise ValueError("boom")

    bp = make(cb, max_batch=8, timeout_ms=20)
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(bp.process, i) for i in range(4)]
            for f in futs:
                with pytest.raises(ValueError, match="boom"):
                    f.result(timeout=5)
        # A failed batch updates no counters.
        assert bp.get_metrics().total_batches == 0
    finally:
        bp.stop()


def test_short_response_list_fails_extras():
    gate = threading.Event()

    def cb(reqs):
        gate.wait(0.1)
        return reqs[:1]  # deliberately short: extras must fail, not hang

    bp = make(cb, max_batch=8, timeout_ms=10)
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(bp.process, i) for i in range(4)]
            time.sleep(0.02)
            gate.set()
            outcomes = []
            for f in futs:
                try:
                    f.result(timeout=5)
                    outcomes.append("ok")
                except RuntimeError:
                    outcomes.append("err")
        assert "err" in outcomes
    finally:
        bp.stop()


@pytest.mark.parametrize("cls", [BatchProcessor, JaxBP],
                         ids=["port", "jax"])
def test_metrics_fields_and_avg(cls):
    bp = make(lambda reqs: reqs, max_batch=4, timeout_ms=10, cls=cls)
    try:
        for i in range(5):
            bp.process(i)
        m = bp.get_metrics()
        assert m.total_requests == 5
        assert m.total_batches >= 1
        d = m.as_dict()
        assert set(d) == {"total_batches", "avg_batch_size",
                          "timeout_batches", "full_batches"}
        assert d["avg_batch_size"] == pytest.approx(5 / m.total_batches)
        # Sequential requests each wake the thread by notify: full.
        assert d["full_batches"] + d["timeout_batches"] == m.total_batches
    finally:
        bp.stop()


def test_stop_fails_pending_and_rejects_new():
    gate = threading.Event()

    def cb(reqs):
        gate.wait(1.0)
        return reqs

    bp = make(cb, max_batch=1, timeout_ms=10)
    fut = bp.submit(1)   # occupies the dispatch thread
    fut2 = bp.submit(2)  # stays queued
    time.sleep(0.05)
    gate.set()
    bp.stop()
    with pytest.raises(RuntimeError, match="not running"):
        bp.submit(3)
    for f in (fut, fut2):  # completed or failed at stop; neither hangs
        try:
            f.result(timeout=1)
        except RuntimeError:
            pass


def test_linger_accumulates_for_occupancy():
    sizes = []

    def cb(reqs):
        sizes.append(len(reqs))
        return reqs

    bp = make(cb, max_batch=8, timeout_ms=20, linger_ms=40)
    try:
        with ThreadPoolExecutor(8) as ex:
            futs = []
            for i in range(8):
                futs.append(ex.submit(bp.process, i))
                time.sleep(0.003)  # a trickle: without linger, batches of 1
            for f in futs:
                f.result(timeout=5)
        assert max(sizes) >= 4 and sum(sizes) == 8
    finally:
        bp.stop()


@pytest.mark.parametrize("cls", [BatchProcessor, JaxBP],
                         ids=["port", "jax"])
def test_pipeline_keeps_depth_batches_in_flight(cls):
    """Split-phase callbacks: up to pipeline_depth submitted batches are
    in flight before the oldest is collected, and each caller gets its
    own batch's results."""
    lock = threading.Lock()
    state = {"inflight": 0, "peak": 0}
    release = threading.Event()

    def submit(reqs):
        with lock:
            state["inflight"] += 1
            state["peak"] = max(state["peak"], state["inflight"])
        return list(reqs)

    def collect(handle):
        release.wait(2.0)
        with lock:
            state["inflight"] -= 1
        return [r * 10 for r in handle]

    bp = make(lambda reqs: reqs, max_batch=1, timeout_ms=5, cls=cls,
              submit_callback=submit, collect_callback=collect,
              pipeline_depth=3)
    try:
        futs = [bp.submit(i) for i in range(6)]
        time.sleep(0.2)
        with lock:
            peak = state["peak"]
        release.set()
        assert [f.result(timeout=5) for f in futs] == [i * 10
                                                       for i in range(6)]
        assert peak == 3
    finally:
        bp.stop()


def test_raising_ready_probe_never_unwinds_the_dispatch_thread():
    """A ready probe that raises counts as not ready: every caller still
    gets its result."""
    calls = []

    def ready(handle):
        calls.append(handle)
        raise RuntimeError("probe failed")

    bp = make(lambda reqs: reqs, max_batch=2, timeout_ms=5,
              submit_callback=lambda reqs: list(reqs),
              collect_callback=lambda h: [r + 1 for r in h],
              ready_callback=ready, pipeline_depth=4)
    try:
        with ThreadPoolExecutor(6) as ex:
            futs = [ex.submit(bp.process, i) for i in range(6)]
            assert sorted(f.result(timeout=5) for f in futs) == list(
                range(1, 7))
    finally:
        bp.stop()


def test_expired_deadline_is_dropped_not_batched():
    seen = []
    bp = make(lambda reqs: seen.extend(reqs) or reqs, max_batch=4,
              timeout_ms=5)
    try:
        gone = Deadline.after_ms(0)
        time.sleep(0.002)
        with pytest.raises(DeadlineExceeded):
            bp.process("late", deadline=gone)
        assert bp.process("ok", deadline=Deadline.after_ms(5000)) == "ok"
        assert seen == ["ok"] and bp.deadline_dropped == 1
    finally:
        bp.stop()


def test_observer_sees_each_batch_and_never_unwinds():
    timings = []

    def observer(reqs, timing):
        timings.append((list(reqs), timing))
        raise RuntimeError("a broken observer")

    bp = make(lambda reqs: reqs, max_batch=4, timeout_ms=5,
              observer=observer)
    try:
        assert bp.process(1) == 1 and bp.process(2) == 2
        assert [r for r, _ in timings] == [[1], [2]]
        t = timings[0][1]
        assert isinstance(t, BatchTiming) and len(t.queue_wait_us) == 1
        assert t.compute_us >= 0 and t.batch_form_us >= 0
    finally:
        bp.stop()


def test_split_callbacks_go_together():
    with pytest.raises(ValueError, match="go together"):
        BatchProcessor(4, 10, lambda r: r, submit_callback=lambda r: r)
    with pytest.raises(ValueError, match="positive"):
        BatchProcessor(0, 10, lambda r: r)
