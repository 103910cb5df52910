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
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch

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


class Trace:
    """A ``torch.profiler`` trace (host, and the card's kernels when
    ``cuda``) between :meth:`start` and :meth:`stop`, written into
    ``directory`` as a Chrome trace ``<name>.<time>.<pid>.pt.trace.json``
    (chrome://tracing, Perfetto, TensorBoard)."""

    def __init__(self, directory: str, name: str, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.directory, self.name = directory, name
        self._prof = torch.profiler.profile(activities=acts)
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
