"""The CLIs' debugging aids: NaN checks stage by stage (``--debug-nans``)
and ``torch.profiler`` traces (``--trace``).

``--debug-nans`` is the counterpart of JAX's ``jax_debug_nans``, the
functional replacement of the reference's ``oops!`` prints
(Depth.cpp:1600-1601).  Inside :func:`nan_checks`, each stage's result
is checked as it is made, and the first NaN raises
:class:`FloatingPointError` naming the stage (registration, fusion, the
baseline or perspective net; the loss, gradients or parameters of a train
step) and the work it belongs to (the panorama or the step, set by
:func:`where`).  ``graphs.Graphed`` then runs its function eagerly: a
replayed graph cannot be checked stage by stage.  Off (the default),
:func:`check` returns at once and nothing is synchronised; on, the
outputs are those of the run without it, bit for bit.

:func:`span` names a stretch of host work on a profiler's timeline
(``panodepth.<layer>.<step>``): the micro-batcher's runner
(``daemon.Batcher``) and every ``graphs.Graphed`` call record theirs, so a
trace says what the host did while the card waited.  A span is recorded
only while a profiler records (a :class:`Trace`, the benchmark's), on
every thread that :class:`Trace` follows, and its host time is summed by
name (:func:`span_totals`) on every thread; otherwise it costs one test
of a flag.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List

import torch
from torch.autograd import profiler as _profiler

_NANS = False
_WHERE: List[str] = []


@contextlib.contextmanager
def nan_checks(on: bool = True):
    """The stage checks on (or off) inside the block, process-wide as JAX's
    flag; the setting before it is restored after."""
    global _NANS
    saved, _NANS = _NANS, bool(on)
    try:
        yield
    finally:
        _NANS = saved


def nans_on() -> bool:
    return _NANS


@contextlib.contextmanager
def where(label: str):
    """Name the work inside the block (``panorama X``, ``train step N``) in
    a check's error."""
    _WHERE.append(label)
    try:
        yield
    finally:
        _WHERE.pop()


def _named(tensors):
    if isinstance(tensors, dict):
        return list(tensors.items())
    if isinstance(tensors, torch.Tensor):
        return [(None, tensors)]
    return [(None, t) for t in tensors if t is not None]


def check(stage: str, tensors) -> None:
    """With the checks on, raise :class:`FloatingPointError` if a floating
    tensor of ``tensors`` (a tensor, a sequence, or a dict by name) holds a
    NaN, naming ``stage``, the tensor's name and the work running."""
    if not _NANS:
        return
    for name, t in _named(tensors):
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            what = f" ({name})" if name else ""
            at = f" of {', '.join(_WHERE)}" if _WHERE else ""
            raise FloatingPointError(
                f"--debug-nans: NaN in the {stage}{what}{at}")


_NO_SPAN = contextlib.nullcontext()
# name -> [spans closed, nanoseconds], of the spans run while a profiler
# recorded
_TOTALS: dict = {}
_TOTALS_LOCK = threading.Lock()


def recording() -> bool:
    """True while a profiler records, on any thread.  (The profiler's own
    test, ``torch._C._autograd._profiler_enabled()``, is per thread: it
    reads False on a worker thread while the profiler records there.)"""
    return _profiler._is_profiler_enabled


class _Span:
    """A ``record_function`` range that adds its host time to
    :func:`span_totals` when it closes."""

    __slots__ = ("key", "_range", "_t0")

    def __init__(self, key: str, label: str):
        self.key, self._range = key, _profiler.record_function(label)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        with _TOTALS_LOCK:
            row = _TOTALS.setdefault(self.key, [0, 0])
            row[0] += 1
            row[1] += ns
        return False


def span(name: str, args: str = None):
    """A ``record_function`` range ``panodepth.<name>`` while a profiler
    records, else one shared null context.  ``args`` (the work's identity:
    a batch's request numbers, a graph's name) follows the name after a
    space, in brackets: PyTorch's profiler records a range's string
    argument as an empty input, so the name carries it; a reader keys the
    range by the part before the space.  Build ``args`` only when
    :func:`recording`.  The range's time also goes to
    :func:`span_totals`, from any thread, whether or not the profiler
    follows that thread."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    name = "panodepth." + name
    return _Span(name, f"{name} [{args}]" if args else name)


def span_totals() -> dict:
    """``{"panodepth.<name>": {"n": spans, "s": seconds}}`` of every span
    closed while a profiler recorded, since the process started: what the
    host spent in each, on every thread."""
    with _TOTALS_LOCK:
        return {k: {"n": n, "s": ns / 1e9} for k, (n, ns) in _TOTALS.items()}


class Trace:
    """A ``torch.profiler`` trace (host, and the card's kernels when
    ``cuda``) between :meth:`start` and :meth:`stop`, written into
    ``directory`` as a Chrome trace ``<name>.<time>.<pid>.pt.trace.json``
    (chrome://tracing, Perfetto, TensorBoard).  Every thread is recorded:
    the decode and writer pools, the batcher's runner and their
    :func:`span` ranges appear beside the main thread's."""

    def __init__(self, directory: str, name: str, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.directory, self.name = directory, name
        self._prof = torch.profiler.profile(
            activities=acts, experimental_config=torch.profiler
            ._ExperimentalConfig(profile_all_threads=True))
        self.running = False

    def start(self) -> None:
        self._prof.start()
        self.running = True

    def stop(self) -> str:
        """Stop, write the trace; returns its path."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._prof.stop()
        self.running = False
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"{self.name}."
                            f"{time.strftime('%Y%m%d_%H%M%S')}.{os.getpid()}"
                            f".pt.trace.json")
        self._prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def traced(directory, name: str, cuda: bool, log=print):
    """A :class:`Trace` of the block into ``directory``; nothing when
    ``directory`` is None."""
    if directory is None:
        yield
        return
    trace = Trace(directory, name, cuda)
    trace.start()
    try:
        yield
    finally:
        log(f"[trace] profiler trace written to {trace.stop()}")
