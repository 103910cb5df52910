"""The device trace of a run: ``torch.profiler`` over the last slice of
the measured window, reduced to device busy time (of every operation, and
of the kernels alone), time by operation name and the gaps between
kernels, each gap named by what the harness's host was doing (its
``harness.*`` ranges) while the device waited.

The profiler is prepared before the window (its set-up, which takes
seconds, would stall the loop inside it), starts recording at the slice's
start and is read after the window has closed."""

from __future__ import annotations

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function, schedule

WINDOW = "portbench.window"


def span(name: str):
    """A host range the trace can name an idle gap after."""
    return record_function("harness." + name)


class Trace:
    """Prepared when made; records between :meth:`start` and :meth:`stop`;
    :meth:`reduce` after the window."""

    def __init__(self):
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1))
        self._prof.__enter__()
        self._window = None
        self.state = "ready"
        self.result = None

    def start(self):
        self._prof.step()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self.state = "on"

    def stop(self):
        if self.state == "on":
            self._window.__exit__(None, None, None)
            self.state = "off"

    def reduce(self) -> dict:
        """{window_s, busy_s, kernel_busy_s, kernels: {name: seconds},
        gaps: [(host range, seconds)]}: device operations clipped to the
        window.  ``busy_s`` is the union of every device operation
        (kernels, copies, sets), ``kernel_busy_s`` that of the kernels
        alone; the gaps are those between kernels."""
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        w0 = w1 = None
        host, dev = [], []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                if name == WINDOW:
                    w0, w1 = e.start_ns(), e.end_ns()
                elif name.startswith("harness."):
                    host.append((e.start_ns(), e.end_ns(), name[8:]))
            elif not (e.is_user_annotation() or name == WINDOW
                      or name.startswith("harness.")):
                # the device's own operations, not the ranges the profiler
                # mirrors onto its timeline
                dev.append((e.start_ns(), e.end_ns(), name))
        if w0 is None:
            raise RuntimeError("the trace holds no window range")
        ops = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev
                     if t > w0 and s < w1)
        kernels = {}
        for s, t, n in ops:
            kernels[n] = kernels.get(n, 0.0) + (t - s) / 1e9
        busy, _ = _union(ops, w0, w1)
        kernel_busy, gaps = _union(
            [op for op in ops if not is_transfer(op[2])], w0, w1)
        named = {}
        for g0, g1 in gaps:
            label = _host_label(host, g0, g1)
            named[label] = named.get(label, 0.0) + (g1 - g0) / 1e9
        self.result = dict(
            window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
            kernel_busy_s=kernel_busy / 1e9, kernels=kernels,
            gaps=sorted(named.items(), key=lambda kv: -kv[1]))
        self._prof = None
        return self.result


def is_transfer(name: str) -> bool:
    """A copy or a set, not a kernel (the profiler's ``Memcpy ...`` and
    ``Memset ...`` records)."""
    return name.startswith(("Memcpy", "Memset"))


def _union(ops, w0, w1):
    """(nanoseconds covered by the sorted intervals ``ops`` inside
    [w0, w1], the gaps [(start, end)] between them)."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, t, _ in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gaps.append((w0 if cur_e is None else cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.append((w0 if cur_e is None else cur_e, w1))
    return busy, [(a, b) for a, b in gaps if b > a]


def _host_label(host, g0, g1) -> str:
    """The innermost harness range that overlaps the gap [g0, g1] most."""
    best, best_len = "idle host", 0
    for s, t, n in host:
        ov = min(t, g1) - max(s, g0)
        if ov > best_len or (ov == best_len and ov > 0 and len(n) > len(best)):
            best, best_len = n, ov
    return best


def kernel_time(kernels: dict, *needles) -> float:
    """Seconds of the kernels whose name holds any of ``needles``."""
    return sum(s for n, s in kernels.items()
               if any(k in n for k in needles))


def roofline_share(ctx, bound: dict, *names):
    """A kernel's least time a panorama (``bound``, from
    ``portbench/counts/work.py``) over its device time a panorama in the
    traced window (the kernels whose name holds any of ``names``), in
    percent; None where the trace holds none of them."""
    res = ctx.result
    if not ctx.trace or not getattr(res, "trace_panos", None) \
            or not bound["bound_s"]:
        return None
    t = kernel_time(ctx.trace["kernels"], *names)
    if t <= 0:
        return None
    return 100.0 * bound["bound_s"] * res.trace_panos / t
