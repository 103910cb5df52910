"""The trace's reduction: the device's busy time is the union of the
operations' intervals inside the window, the idle share counts only
kernels as busy (a copy or a set leaves the device's compute idle), and
the gaps between kernels are what the breakdown names."""

from types import SimpleNamespace

import pytest

from portbench.harness import cells, trace

OPS = [(0, 10, "kernel_a"), (5, 20, "kernel_b"), (30, 60, "Memcpy DtoH"),
       (70, 80, "kernel_a"), (75, 90, "Memset (Device)")]


def test_union_and_gaps():
    busy, gaps = trace._union(OPS, 0, 100)
    assert busy == 20 + 30 + 20
    assert gaps == [(20, 30), (60, 70), (90, 100)]
    kernels = [op for op in OPS if not trace.is_transfer(op[2])]
    busy, gaps = trace._union(kernels, 0, 100)
    assert busy == 20 + 10
    assert gaps == [(20, 70), (80, 100)]
    assert trace._union([], 0, 100) == (0, [(0, 100)])


@pytest.mark.parametrize("name,loop", [("idle_share.batch", "closed"),
                                       ("idle_share.serve", "open")])
def test_idle_share_counts_kernels_only(name, loop):
    tr = {"window_s": 2.0, "busy_s": 1.5, "kernel_busy_s": 1.0}
    read = cells.reader(name)
    assert read(SimpleNamespace(loop=loop, trace=tr)) == pytest.approx(50.0)
    other = "open" if loop == "closed" else "closed"
    assert read(SimpleNamespace(loop=other, trace=tr)) is None
    assert read(SimpleNamespace(loop=loop, trace=None)) is None
