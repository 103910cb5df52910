"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each merge and each e2e stage as one compiled graph.
Here the same functions run eagerly, one PyTorch operation (and about a
thousand kernel launches per merge) at a time, and the card waits for the
host between them.  :class:`Graphed` captures a pure tensor function once
per input signature into a CUDA graph and replays it with no Python in
between; every shape is static per configuration, as under ``jax.jit``.

- **Capture.** Two warm-up calls run first on a side stream; they build
  what a first call builds (the cached index tables, cuDNN's choice, the
  kernels' libraries and attributes).  Then one call is captured under
  ``torch.cuda.graph``, with a memory pool of its own.  The kernels'
  ``LAUNCHES`` counters tick in those three calls; a replay launches the
  kernels again without ticking them (``chip_smoke.py`` sees the replayed
  kernels under ``torch.profiler``).
- **Replay.** The inputs are copied into the graph's static input buffers,
  the graph is replayed, and the outputs are returned as clones, so that a
  caller may hold batch k's results while batch k+1 replays.
- **What a graph reads.** A graph stores the device address of every
  tensor it reads, and a replay reads them again with no check.  So each
  captured graph holds a reference to every such tensor that it did not
  allocate itself: the parameters and buffers of its nets, the casts that
  ``models/layers.Derived`` made of them, and the index and weight tables
  of the merge, which live in bounded caches (:func:`device_cache`)
  that may evict a table while a graph that reads it is still kept.
  Every call of such a cache, hit or miss, hands its result to
  :func:`hold`, which adds it to the graph being captured.
- **Cache key.** Like ``jax.jit``'s: the structure, shapes and dtypes of
  the inputs (the configuration, the routes and the device belong to the
  object), and for every net the graph runs, each parameter's
  ``(data_ptr, dtype, _version)``, the key ``models/layers.Derived`` keys
  its casts with.  A graph bakes in the weights' addresses and those
  casts, so new weights capture anew.  The values of the environment
  variables named in ``env`` join the key: a stage that reads one when
  it runs (``PANODEPTH_BASE_FEED``, ``PANODEPTH_P99``, as JAX reads them
  when it traces) is captured anew for another value.
- **CPU, NaN checks and failures.** On the CPU the function runs eagerly:
  the CPU has no graph; so it does under ``--debug-nans``
  (``debug.nans_on()``), whose checks a replay would skip.  On the card a
  capture that fails raises :class:`CaptureError`; it never falls back to
  the eager function.
- **Tracers.** ``torch.export`` (``serve.py``) runs the same functions on
  fake tensors.  A table of :func:`device_cache` is then still computed
  on real tensors (:func:`untraced`), so the cache never keeps a fake
  tensor for a later eager call, and the exporter lifts the real table
  into the program as a constant, as a graph holds it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
from typing import Callable, Iterable

import numpy as np
import torch
from torch.utils import _python_dispatch

from . import debug

# eager calls on a side stream before each capture
WARMUP = 2
# input signatures a Graphed keeps captured, the least recently used evicted
MAX_SIGNATURES = 8


class CaptureError(RuntimeError):
    """A function could not be captured into a CUDA graph."""


# one list per capture in progress: the tensors its graph must keep alive
_HOLDING: list = []


def hold(obj):
    """Keep ``obj`` (a tensor or a structure of them) alive as long as the
    graph being captured now, if any; returns ``obj``."""
    if _HOLDING:
        _HOLDING[-1].append(obj)
    return obj


@contextlib.contextmanager
def holding(held: list):
    """Within the block, :func:`hold` appends to ``held``."""
    _HOLDING.append(held)
    try:
        yield held
    finally:
        _HOLDING.pop()


def tracing() -> bool:
    """True while a tracer (``torch.export``, ``torch.compile``) or another
    dispatch mode (a ``FakeTensorMode``) runs the calling code: tensors
    made now may be fake."""
    return bool(torch.compiler.is_compiling()
                or _python_dispatch._get_current_dispatch_mode_stack())


def untraced():
    """A block in which tensors are real even under a tracer (every
    dispatch mode set aside); to a tracer, what it makes is a constant."""
    return _python_dispatch._disable_current_modes()


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that returns tensors
    on a device that a captured graph may read: every call hands its
    result to :func:`hold`, so an evicted table stays alive for as long
    as a graph captured with it is kept.  Under a tracer the function
    runs :func:`untraced`: the cache keeps only real tensors, and a traced
    program reads the table as a constant."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if tracing():
                with untraced():
                    return hold(cached(*args))
            return hold(cached(*args))

        call.cache_clear = cached.cache_clear
        call.cache_info = cached.cache_info
        return call

    return wrap


def _flatten(obj, leaves: list):
    """Append the leaves of nested tuples and lists to ``leaves``; returns
    the (hashable) structure."""
    if isinstance(obj, (tuple, list)):
        return type(obj), tuple(_flatten(o, leaves) for o in obj)
    leaves.append(obj)
    return None


def _unflatten(spec, leaves):
    """The inverse of :func:`_flatten` over an iterator of leaves."""
    if spec is None:
        return next(leaves)
    kind, kids = spec
    return kind(_unflatten(k, leaves) for k in kids)


class _Entry:
    """One captured signature: the graph, its static inputs and outputs,
    and the tensors from outside its pool that it reads (``held``)."""

    def __init__(self, graph, inputs, outputs, out_spec, held):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.out_spec = out_spec
        self.held = held


class Graphed:
    """``fn`` replayed from a CUDA graph per input signature on ``device``.

    ``fn`` takes tensors (or nested tuples and lists of them) and returns
    the same; it may not synchronise with the host or copy from it, and its
    result must depend on nothing but its inputs, the parameters of
    ``modules`` and tensors it obtains through :func:`hold` (directly or
    from a :func:`device_cache`).  Inputs may be numpy arrays, CPU tensors (pinned ones are
    copied asynchronously) or tensors on ``device``.  ``eager`` is ``fn``
    itself.  At most ``MAX_SIGNATURES`` signatures are kept, the least
    recently used evicted (its graph and memory pool freed).  ``env``
    names environment variables ``fn`` reads: their values join the key.
    """

    def __init__(self, fn: Callable, device, modules: Iterable = (),
                 name: str = None, env: Iterable[str] = ()):
        self.eager = fn
        self.device = torch.device(device)
        self.modules = tuple(m for m in modules if m is not None)
        self.name = name or getattr(fn, "__name__", "function")
        self.env = tuple(env)
        self._cache: collections.OrderedDict = collections.OrderedDict()

    def _weights(self):
        return [p for m in self.modules
                for p in list(m.parameters()) + list(m.buffers())]

    def _weights_key(self):
        return tuple((p.data_ptr(), p.dtype, p._version)
                     for p in self._weights())

    def __call__(self, *args):
        leaves = []
        spec = _flatten(args, leaves)
        if self.device.type != "cuda" or debug.nans_on():
            return self.eager(*_unflatten(spec, iter(
                [torch.as_tensor(t, device=self.device) for t in leaves])))
        leaves = [torch.from_numpy(np.ascontiguousarray(t))
                  if isinstance(t, np.ndarray) else t for t in leaves]
        key = (spec, tuple((tuple(t.shape), t.dtype) for t in leaves),
               self._weights_key(),
               tuple(os.environ.get(name) for name in self.env))
        entry = self._cache.get(key)
        if entry is None:
            entry = self._capture(spec, leaves)
            self._cache[key] = entry
            while len(self._cache) > MAX_SIGNATURES:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        for dst, src in zip(entry.inputs, leaves):
            dst.copy_(src, non_blocking=True)
        entry.graph.replay()
        return _unflatten(entry.out_spec,
                          iter([t.clone() for t in entry.outputs]))

    def _capture(self, spec, leaves) -> _Entry:
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for t in leaves]
        for dst, src in zip(inputs, leaves):
            dst.copy_(src)
        args = _unflatten(spec, iter(inputs))
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        # the weights are held too: a new parameter that reused a freed
        # one's address and version would otherwise match this graph's key
        held = self._weights()
        with holding(held):
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.eager(*args)
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    out = self.eager(*args)
            except Exception as e:  # any failure of the capture: name it
                raise CaptureError(
                    f"{self.name}: CUDA graph capture failed (a host sync or "
                    f"a host-to-device copy inside the function?): {e}"
                ) from e
        outputs = []
        out_spec = _flatten(out, outputs)
        if not all(isinstance(t, torch.Tensor) for t in outputs):
            raise CaptureError(f"{self.name}: returns something other than "
                               f"tensors")
        return _Entry(graph, inputs, outputs, out_spec, held)

    def clear(self):
        """Drop every captured graph (and its memory pool)."""
        self._cache.clear()

    def __len__(self):
        return len(self._cache)
