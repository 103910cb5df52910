"""The open loop of the serving daemon's micro-batcher: requests arrive at
times drawn from the seed, whatever the system's pace, each one decoded
panorama handed to ``daemon.Batcher.submit`` from a pool of client
threads, as the daemon's HTTP handlers hand it on after decoding.  The
batcher runs over the ``serve export-e2e`` artifact, the daemon's default
batch and delay.  Each request is timed from when it was due to the
return of ``submit``.

The traffic file states the rate and, optionally, bursts: ``burst`` > 1
sends that many requests at each arrival of a Poisson process of rate
``rate_per_s / burst``.  A window of ``seconds`` holds exactly
``round(rate_per_s * seconds)`` requests whose gaps are the same set for
every ``--seed``: exponential gaps at the quantiles of their distribution,
in an order drawn from the seed.  The seed also draws the panoramas and
which request sends which; the amount of work is the traffic mix's own."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import program
from .pool import make_pool
from .trace import Trace, span


def arrivals(rng, rate: float, seconds: float, burst: int = 1):
    """Due times (s from the window's start) of ``round(rate * seconds)``
    requests: exponential gaps of mean ``burst / rate`` at the quantiles
    ``(i + 0.5) / m`` of their distribution, shuffled by ``rng``, scaled to
    end within the window."""
    n = int(round(rate * seconds))
    m = -(-n // burst)
    gaps = -np.log1p(-(np.arange(m) + 0.5) / m)
    gaps = rng.permutation(gaps) * (seconds / (gaps.sum() + gaps.mean()))
    return np.repeat(np.cumsum(gaps), burst)[:n]


class TimedArtifact:
    """The artifact as the batcher calls it, timing each call from its
    start to its outputs on the host (the copies back included)."""

    def __init__(self, art):
        self.art = art
        self.meta = art.meta
        self.calls = []  # (start, ms)

    def __call__(self, *args):
        t = time.monotonic()
        with span("artifact_call"):
            outs = self.art(*args)
            outs = tuple(np.asarray(o.cpu() if hasattr(o, "cpu") else o)
                         for o in outs)
        self.calls.append((t, (time.monotonic() - t) * 1e3))
        return outs


class OpenLoop:
    def __init__(self, cell, root, device, trace: bool):
        self.cell, self.root = cell, root
        self.device = torch.device(device)
        self.trace = trace

    def setup(self, seed: int):
        t = self.cell.traffic
        self.pool = make_pool(seed, t["pool"], self.cell.config["rgb_shape"],
                              self.device)
        art = program.artifact(self.cell.config, t["batch"], self.root,
                               Path(self.root) / "portbench" / ".cache",
                               self.device, log=_log)
        self.art = TimedArtifact(art)
        self.batcher = program.batcher(self.art, t["max_delay_ms"])
        # a full batch or two, as the traffic sends them
        for _ in range(t.get("warmup_steps", 2)):
            with ThreadPoolExecutor(t["batch"]) as ex:
                futs = [ex.submit(self.batcher.submit, [self.pool[i]])
                        for i in range(t["batch"])]
                for f in futs:
                    f.result()

    def run(self, seed: int, seconds: float, trace_window=None):
        from panodepth_torch.daemon import Overloaded

        t = self.cell.traffic
        due = arrivals(np.random.default_rng([seed, 3]), t["rate_per_s"],
                       seconds, t.get("burst", 1))
        n = len(due)
        pick = np.random.default_rng([seed, 1]).integers(0, len(self.pool), n)
        k = min(t.get("check", 8), n)
        check = set(np.random.default_rng([seed, 2]).choice(
            n, k, replace=False).tolist())
        lat = np.full(n, np.inf)
        late = np.zeros(n)
        samples, errors = [], []
        lock = threading.Lock()
        timeout = t.get("timeout_s", 60.0)
        tr = Trace() if trace_window else None
        before = dict(self.batcher.stats)
        self.art.calls.clear()

        def request(i, due_at):
            try:
                out = self.batcher.submit([self.pool[pick[i]]],
                                          timeout=timeout)
            except (Overloaded, TimeoutError):
                return  # its latency stays infinite: a failure
            except Exception as e:  # noqa: BLE001 - the program failed it
                errors.append(e)
                return
            lat[i] = time.monotonic() - due_at
            if i in check:
                with lock:
                    samples.append((int(pick[i]), np.array(out[0]),
                                    np.array(out[1])))

        with ThreadPoolExecutor(t["clients"]) as ex:
            t0 = time.monotonic() + 0.05
            end = t0 + seconds
            futs = []
            for i, d in enumerate(due):
                at = t0 + d
                if tr is not None and tr.state == "ready" and \
                        at >= t0 + trace_window[0]:
                    time.sleep(max(0.0, t0 + trace_window[0]
                                   - time.monotonic()))
                    tr.start()
                wait = at - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                late[i] = time.monotonic() - at
                futs.append(ex.submit(request, i, at))
            if tr is not None:
                time.sleep(max(0.0, end - time.monotonic()))
                tr.stop()
            for f in futs:
                f.result()
        if tr is not None:
            tr.reduce()
        after = dict(self.batcher.stats)
        calls = [ms for s, ms in self.art.calls if t0 <= s <= end]
        ok = np.isfinite(lat)
        # a failed request misses every latency limit
        lat_ms = np.where(ok, lat, timeout + seconds) * 1e3
        if errors:
            _log(f"[portbench] {len(errors)} requests failed in the program, "
                 f"the first: {errors[0]!r}")
        _log(f"[portbench] generator lateness: median "
             f"{float(np.median(late)) * 1e3!r} ms, p99 "
             f"{float(np.percentile(late, 99)) * 1e3!r} ms, max "
             f"{float(late.max()) * 1e3!r} ms over {n} requests")
        med = float(np.median(calls)) if calls else float("nan")
        _log(f"[portbench] {after['batches'] - before['batches']} artifact "
             f"calls, median {med!r} ms; latency p99 "
             f"{float(np.percentile(lat_ms, 99))!r} ms")
        return SimpleNamespace(
            seconds=seconds, attempted=n, failed=int((~ok).sum()),
            e2e={"latency_p95_ms": float(np.percentile(lat_ms, 95)),
                 "latency_p50_ms": float(np.percentile(lat_ms, 50))},
            samples=samples, pool=self.pool,
            trace=tr.result if tr else None, trace_panos=None,
            batch=t["batch"], call_ms=calls,
            batcher={k: after[k] - before[k] for k in after},
            lateness_ms=late * 1e3, latency_ms=lat_ms)

    def close(self):
        self.batcher.stop()
        self.batcher = self.art = None


def _log(msg):
    import sys

    print(msg, file=sys.stderr, flush=True)
