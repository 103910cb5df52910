"""The closed loop of the model-mode batch: each step takes ``batch``
distinct panoramas of the seeded pool from host memory, copies them in
through pinned memory and replays the e2e graph's ``full``; step k+1 is
submitted before step k's ``out_u16`` and baselines are copied back to
the host, the submit/collect order of ``run_batch_e2e``."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from . import program
from .pool import make_pool
from .trace import Trace, span


class Sampler:
    """The outputs the check compares: ``k`` items in all, spread over the
    row positions of the batch, each position's share a uniform sample of
    the items offered at it (reservoir sampling, drawn from ``rng``).
    Every row position is sampled, so a fault confined to some rows of
    the batch shows."""

    def __init__(self, k: int, batch: int, rng):
        rows = max(1, min(k, batch))
        self.rng = rng
        # per row position: [share of k, items seen, items kept]
        self.rows = [[k // rows + (r < k % rows), 0, []] for r in range(rows)]

    def offer(self, make, row: int):
        res = self.rows[row % len(self.rows)]
        size, seen, items = res
        if seen < size:
            items.append(make())
        else:
            j = int(self.rng.integers(0, seen + 1))
            if j < size:
                items[j] = make()
        res[1] += 1

    @property
    def items(self) -> list:
        return [item for _, _, items in self.rows for item in items]


def batches(rng, pool_size: int, batch: int):
    """Index lists of ``batch`` distinct pool panoramas: the pool in a new
    seeded order each pass."""
    while True:
        order = rng.permutation(pool_size)
        for lo in range(0, pool_size - batch + 1, batch):
            yield order[lo:lo + batch]


class ClosedLoop:
    def __init__(self, cell, root, device, trace: bool):
        self.cell, self.root = cell, root
        self.device = torch.device(device)
        self.trace = trace
        self.batch = cell.traffic["batch"]

    def setup(self, seed: int):
        """The pool, the graphs, and every shape captured."""
        t = self.cell.traffic
        self.pool = make_pool(seed, t["pool"], self.cell.config["rgb_shape"],
                              self.device)
        self.full, self.models, self.fuse = program.build_e2e(
            self.cell.config, self.root, self.device)
        x = self._inputs(np.arange(self.batch) % len(self.pool))
        for _ in range(t.get("warmup_steps", 3)):
            out = self.full(x)
        if self.trace:
            for _ in range(2):
                out = self.fuse(*self.models(x))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del out

    def _inputs(self, idx):
        x = torch.from_numpy(np.stack([self.pool[i] for i in idx]))
        return x.pin_memory() if self.device.type == "cuda" else x

    def run(self, seed: int, seconds: float, trace_window=None):
        """The measured window; returns its readings."""
        t = self.cell.traffic
        rng = np.random.default_rng([seed, 1])
        order = batches(rng, len(self.pool), self.batch)
        sampler = Sampler(t.get("check", 8), self.batch,
                          np.random.default_rng([seed, 2]))
        tr = Trace() if trace_window else None
        done = in_trace = 0
        t0 = time.monotonic()
        t_end = t0 + seconds
        tr_on = t0 + trace_window[0] if tr else None

        def submit(idx):
            with span("submit"):
                out, bases = self.full(self._inputs(idx))
                host = (out.to("cpu", non_blocking=True),
                        bases.to("cpu", non_blocking=True))
                ev = None
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
            return idx, host, ev

        def collect(pending):
            nonlocal done, in_trace
            idx, (out, bases), ev = pending
            with span("collect"):
                if ev is not None:
                    ev.synchronize()
                now = time.monotonic()
                if now > t_end:
                    return
                out_np, base_np = out.numpy(), bases.numpy()
                for j, i in enumerate(idx):
                    sampler.offer(lambda j=j, i=i: (
                        int(i), out_np[j].copy(), base_np[j].copy()), j)
                done += len(idx)
                if tr is not None and tr.state == "on":
                    in_trace += len(idx)

        pending = None
        while True:
            now = time.monotonic()
            if tr is not None and tr.state == "ready" and now >= tr_on:
                tr.start()
            if now >= t_end:
                break
            submitted = submit(next(order))
            if pending is not None:
                collect(pending)
            pending = submitted
        if tr is not None:
            tr.stop()
        if pending is not None:
            collect(pending)
        if tr is not None:
            tr.reduce()
        stages = self._stages(t.get("stage_steps", 8)) if tr else None
        return SimpleNamespace(
            seconds=seconds, attempted=done, failed=0,
            e2e={"pano_per_s": done / seconds}, samples=sampler.items,
            pool=self.pool, trace=tr.result if tr else None,
            trace_panos=in_trace, stages=stages, batch=self.batch)

    def _stages(self, steps: int):
        """ms a panorama of ``models_stage`` and ``fuse_stage`` replayed one
        after the other, CUDA events around each (the split of
        ``run_batch_e2e --profile``; the host clock on the CPU)."""
        x = self._inputs(np.arange(self.batch) % len(self.pool))
        models, fuse = [], []
        for _ in range(steps):
            e = [_Mark(self.device) for _ in range(3)]
            e[0].record()
            bases, pmaps = self.models(x)
            e[1].record()
            self.fuse(bases, pmaps)
            e[2].record()
            models.append(e[0].ms_to(e[1]) / self.batch)
            fuse.append(e[1].ms_to(e[2]) / self.batch)
        return {"models_ms": models, "fuse_ms": fuse}

    def close(self):
        self.full = self.models = self.fuse = None


class _Mark:
    """A CUDA event on the card, the host clock on the CPU."""

    def __init__(self, device):
        self.ev = torch.cuda.Event(enable_timing=True) \
            if device.type == "cuda" else None
        self.t = None

    def record(self):
        if self.ev is None:
            self.t = time.perf_counter()
        else:
            self.ev.record()

    def ms_to(self, later) -> float:
        if self.ev is None:
            return (later.t - self.t) * 1e3
        later.ev.synchronize()
        return self.ev.elapsed_time(later.ev)
