"""The port's spans and counters: ``debug.span`` (a ``record_function``
range only while a profiler records, on any thread, its time summed in
``debug.span_totals``), the micro-batcher's
time counters in ``Batcher.stats`` and ``snapshot()``, and the spans the
batcher's runner and ``graphs.Graphed`` record, read back from the Chrome
trace that ``debug.Trace`` writes (every thread recorded)."""

import glob
import json
import threading
import time

import numpy as np
import pytest
import torch

from panodepth_torch import debug, graphs
from panodepth_torch.daemon import Batcher

# the keys of ``stats`` and ``snapshot()`` before the time counters
OLD_STATS = {"requests", "batches", "items", "errors", "timeouts",
             "rejected", "bad_requests"}
OLD_SNAPSHOT = OLD_STATS | {"mean_batch_fill", "latency_ms_p50",
                            "latency_ms_p99"}
RUNNER = ("wait", "gather", "stack", "call", "copy_out", "fanout")


class _SleepyArtifact:
    """Batch 4 of 4 floats; each call sleeps ``call_s`` and records when it
    started and ended."""

    meta = {"in_shapes": [[4, 4]], "in_dtypes": ["float32"]}

    def __init__(self, call_s):
        self.call_s = call_s
        self.calls = []  # (start, end), time.monotonic()
        self.started = threading.Event()

    def __call__(self, x):
        t = time.monotonic()
        self.started.set()
        time.sleep(self.call_s)
        self.calls.append((t, time.monotonic()))
        return (np.asarray(x) * 2.0,)


def _item(v):
    return [np.full((4,), v, np.float32)]


def test_counters_time_the_runner_and_the_queue_wait():
    art = _SleepyArtifact(0.3)
    b = Batcher(art, max_delay_ms=1.0).start()
    try:
        first = threading.Thread(target=b.submit, args=(_item(1.0),))
        first.start()
        assert art.started.wait(30)
        time.sleep(0.05)  # into the first call
        submitted = time.monotonic()
        out, = b.submit(_item(2.0), timeout=30)
        first.join(timeout=30)
        assert not first.is_alive()
        np.testing.assert_array_equal(out, np.full((4,), 4.0, np.float32))
        st = dict(b.stats)
    finally:
        b.stop()
    assert len(art.calls) == 2 and st["batches"] == 2 and st["items"] == 2
    assert st["padded"] == 6
    # the second item waited out the rest of the first call at least
    remainder = art.calls[0][1] - submitted
    assert remainder > 0
    assert st["wait_s"] >= remainder - 0.01
    called = sum(t1 - t0 for t0, t1 in art.calls)
    assert called <= st["call_s"] < called + 0.1
    assert 0 <= st["stack_s"] < 0.1
    assert 0 <= st["copy_out_s"] < 0.1 and 0 <= st["fanout_s"] < 0.1
    assert OLD_STATS <= set(st)
    assert all(isinstance(v, (int, float)) for v in st.values())


def test_snapshot_keeps_its_keys_and_adds_the_means():
    b = Batcher(_SleepyArtifact(0.02), max_delay_ms=1.0).start()
    try:
        for v in range(3):
            b.submit(_item(v), timeout=30)
        s = b.snapshot()
    finally:
        b.stop()
    assert OLD_SNAPSHOT <= set(s)
    assert s["items"] == s["batches"] == 3
    assert s["queue_wait_ms_mean"] == pytest.approx(
        1e3 * s["wait_s"] / 3)
    assert s["call_ms_mean"] == pytest.approx(1e3 * s["call_s"] / 3)
    assert s["call_ms_mean"] >= 20.0
    assert s["stack_ms_mean"] == pytest.approx(1e3 * s["stack_s"] / 3)
    empty = Batcher(_SleepyArtifact(0.0)).snapshot()
    assert empty["queue_wait_ms_mean"] == empty["call_ms_mean"] == 0.0


def test_span_is_one_null_context_without_a_profiler():
    assert not debug.recording()
    a, b = debug.span("batcher.call", "batch 1: requests 1"), \
        debug.span("graphs.key")
    assert a is b
    with a:
        pass


def test_span_totals_count_every_thread_while_recording():
    def spans(n, sleep_s):
        for _ in range(n):
            with debug.span("test.totals", "work"):
                time.sleep(sleep_s)

    key, none = "panodepth.test.totals", {"n": 0, "s": 0.0}
    before = debug.span_totals().get(key, none)
    spans(2, 0.0)  # no profiler: nothing counted
    assert debug.span_totals().get(key, none) == before
    # a profiler that follows this thread alone: the worker's spans count
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        spans(1, 0.02)
        worker = threading.Thread(target=spans, args=(2, 0.01))
        worker.start()
        worker.join(timeout=30)
    got = debug.span_totals()[key]
    assert got["n"] - before["n"] == 3
    assert 0.04 <= got["s"] - before["s"] < 1.0
    spans(1, 0.0)
    assert debug.span_totals()[key] == got


def _trace_events(directory):
    """The host ranges ``panodepth.*`` of the one trace in ``directory``
    (not their mirrors on the card's timeline)."""
    path, = glob.glob(str(directory / "*.pt.trace.json"))
    with open(path) as fp:
        return [e for e in json.load(fp)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith("panodepth.")]


def test_runner_and_graphed_spans_on_the_runner_thread(tmp_path):
    graphed = graphs.Graphed(lambda x: (x * 2.0,), "cpu", name="double")

    class Art:
        meta = _SleepyArtifact.meta

        def __call__(self, x):
            return graphed(x)

    b = Batcher(Art(), max_delay_ms=1.0).start()
    trace = debug.Trace(str(tmp_path), "spans", cuda=False)
    trace.start()
    try:
        assert debug.recording()
        time.sleep(0.05)
        b.submit(_item(1.0), timeout=30)
        time.sleep(0.05)
        b.submit(_item(2.0), timeout=30)
        time.sleep(0.05)
    finally:
        trace.stop()
        b.stop()
    assert not debug.recording()
    ev = _trace_events(tmp_path)
    names = {e["name"].split(" ", 1)[0] for e in ev}
    for step in RUNNER:
        assert f"panodepth.batcher.{step}" in names, names
    assert "panodepth.graphs.call" in names
    # the runner's thread records them all; the client (this thread) none
    main = threading.get_native_id()
    runner = {e["tid"] for e in ev}
    assert len(runner) == 1 and main not in runner
    calls = [e for e in ev if e["name"].startswith("panodepth.batcher.call")]
    assert [e["name"] for e in calls] == [
        "panodepth.batcher.call [batch 1: requests 1]",
        "panodepth.batcher.call [batch 2: requests 2]"]
    # the runner's steps follow one another; graphs.call nests in a call
    top = sorted((e for e in ev if e["name"].startswith("panodepth.batcher")),
                 key=lambda e: e["ts"])
    for a, c in zip(top, top[1:]):
        assert a["ts"] + a["dur"] <= c["ts"] + 1e-3, (a, c)
    for g in (e for e in ev if e["name"].startswith("panodepth.graphs.")):
        assert g["name"] == "panodepth.graphs.call [double]"
        assert any(c["ts"] <= g["ts"] and g["ts"] + g["dur"]
                   <= c["ts"] + c["dur"] for c in calls), g


def test_graphed_on_the_cpu_records_its_call_alone(tmp_path):
    graphed = graphs.Graphed(lambda x: x + 1, "cpu", name="plus")
    with debug.traced(str(tmp_path), "cpu", cuda=False, log=lambda m: None):
        out = graphed(np.zeros(3, np.float32))
    assert torch.equal(out, torch.ones(3))
    assert [e["name"] for e in _trace_events(tmp_path)] == [
        "panodepth.graphs.call [plus]"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_on_the_card_splits_its_call(cuda_device, tmp_path):
    graphed = graphs.Graphed(lambda x: x * 2.0, cuda_device, name="double")
    x = np.arange(12, dtype=np.float32)
    with debug.traced(str(tmp_path), "card", cuda=True, log=lambda m: None):
        first = graphed(x)
        second = graphed(x + 1)
    torch.cuda.synchronize()
    assert torch.equal(second.cpu(), torch.from_numpy((x + 1) * 2.0))
    assert torch.equal(first.cpu(), torch.from_numpy(x * 2.0))
    ev = sorted(_trace_events(tmp_path), key=lambda e: e["ts"])
    calls = [e for e in ev if e["name"] == "panodepth.graphs.call [double]"]
    assert len(calls) == 2
    for k, call in enumerate(calls):
        inner = [e["name"] for e in ev if e is not call
                 and call["ts"] <= e["ts"] <= call["ts"] + call["dur"]
                 and e["tid"] == call["tid"]]
        want = ["panodepth.graphs.key"] + (
            ["panodepth.graphs.capture"] if k == 0 else []) + [
            "panodepth.graphs.copy_in", "panodepth.graphs.replay",
            "panodepth.graphs.clone"]
        assert inner == want, inner
