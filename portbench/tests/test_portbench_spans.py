"""The program's spans and counters as the benchmark reads them: the
program's ranges on the host leave ``Trace.reduce``'s result as it was,
and the four readers of the batcher's counters and of the program's span
totals give their values, and None where the program keeps none."""

import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.harness import cells, trace


class _Event:
    def __init__(self, s, t, name, cpu=True, annotation=False):
        self.s, self.t, self.n = s, t, name
        self.cpu, self.annotation = cpu, annotation

    def name(self):
        return self.n

    def device_type(self):
        return DeviceType.CPU if self.cpu else DeviceType.CUDA

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.t

    def is_user_annotation(self):
        return self.annotation


def _reduced(events):
    tr = trace.Trace.__new__(trace.Trace)
    tr._prof = SimpleNamespace(
        __exit__=lambda *a: None,
        profiler=SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: events)))
    return tr.reduce()


# a fixed event list: the window 100-1100, two harness ranges, kernels,
# a copy, mirrored annotations, and the program's ranges
FIXED = [
    _Event(100, 1100, trace.WINDOW),
    _Event(150, 400, "harness.submit"),
    _Event(600, 1000, "harness.collect"),
    _Event(50, 200, "k_a", cpu=False),
    _Event(180, 300, "k_b", cpu=False),
    _Event(350, 500, "Memcpy HtoD (Pageable -> Device)", cpu=False),
    _Event(520, 700, "k_a", cpu=False),
    _Event(900, 1200, "k_c", cpu=False),
    _Event(520, 700, "harness.collect", cpu=False, annotation=True),
    _Event(120, 330, "panodepth.batcher.call [batch 4: requests 9]"),
    _Event(130, 320, "panodepth.graphs.call [serve.e2e]"),
    _Event(130, 320, "panodepth.graphs.call [serve.e2e]", cpu=False,
           annotation=True),
    _Event(700, 950, "panodepth.batcher.wait"),
]


def test_trace_reduce_leaves_out_the_programs_host_ranges():
    res = _reduced(FIXED)
    # as the reduction gives without the program's ranges
    assert res == _reduced([e for e in FIXED
                            if not e.n.startswith("panodepth.")])
    assert res["window_s"] == 1000 / 1e9
    assert res["busy_s"] == 730 / 1e9
    assert res["kernel_busy_s"] == 580 / 1e9
    assert res["kernels"] == {"k_a": 100 / 1e9 + 180 / 1e9, "k_b": 120 / 1e9,
                              "Memcpy HtoD (Pageable -> Device)": 150 / 1e9,
                              "k_c": 200 / 1e9}
    assert res["gaps"] == [("submit", 220 / 1e9), ("collect", 200 / 1e9)]


def _ctx(loop, trace_=None, batcher=None):
    return SimpleNamespace(loop=loop, trace=trace_, result=SimpleNamespace(
        batcher=batcher, batch=8))


TOTALS = {"panodepth.batcher.call": {"n": 4, "s": 0.4},
          "panodepth.graphs.call": {"n": 5, "s": 0.06}}
TRACE = {"window_s": 2.0, "kernel_busy_s": 0.9}


def _program(monkeypatch, totals):
    """The program's debug module as the run loaded it, keeping
    ``totals``; None: a program whose debug module keeps none (the
    parent's)."""
    mod = SimpleNamespace()
    if totals is not None:
        mod.span_totals = lambda: totals
    monkeypatch.setitem(sys.modules, "panodepth_torch.debug", mod)


def test_readers_of_the_counters():
    counts = {"items": 40, "batches": 5, "wait_s": 3.0, "stack_s": 0.05}
    wait, stack = (cells.reader("queue_wait_ms.serve"),
                   cells.reader("stack_ms.serve"))
    assert wait(_ctx("open", batcher=counts)) == pytest.approx(75.0)
    assert stack(_ctx("open", batcher=counts)) == pytest.approx(10.0)
    # the parent's batcher has no such counter; an empty window
    old = {"items": 40, "batches": 5}
    for read in (wait, stack):
        assert read(_ctx("open", batcher=old)) is None
        assert read(_ctx("open", batcher=dict(counts, items=0,
                                              batches=0))) is None
        assert read(_ctx("closed")) is None


def test_readers_of_the_span_totals(monkeypatch):
    serve, batch = (cells.reader("graphed_host_ms.serve"),
                    cells.reader("graphed_host_ms.batch"))
    # the eager path records no replay: the call's whole time
    _program(monkeypatch, TOTALS)
    assert serve(_ctx("open", TRACE)) == pytest.approx(12.0)
    assert batch(_ctx("closed", TRACE)) == pytest.approx(12.0)
    assert serve(_ctx("closed", TRACE)) is None
    assert batch(_ctx("open", TRACE)) is None
    # on the card the replay, which waits for the device, is left out
    _program(monkeypatch, dict(TOTALS, **{"panodepth.graphs.replay": {
        "n": 5, "s": 0.04}}))
    assert serve(_ctx("open", TRACE)) == pytest.approx(4.0)
    assert batch(_ctx("closed", TRACE)) == pytest.approx(4.0)
    # no trace; a program that kept no span, or keeps no totals
    for read, loop in ((serve, "open"), (batch, "closed")):
        assert read(_ctx(loop, None)) is None
        _program(monkeypatch, {})
        assert read(_ctx(loop, TRACE)) is None
        _program(monkeypatch, None)
        assert read(_ctx(loop, TRACE)) is None
        monkeypatch.delitem(sys.modules, "panodepth_torch.debug")
        assert read(_ctx(loop, TRACE)) is None
