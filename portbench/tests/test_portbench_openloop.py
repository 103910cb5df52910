"""The open loop: its arrivals repeat from the seed, with the same gaps in
the order each seed draws, and a stall of the artifact
shows in the latency timed from each request's due time, not from when
the client got to send it."""

import threading
import time

import numpy as np

from tiny import ROOT, cell

from portbench.harness import openloop


def test_schedule_repeats_from_its_seed():
    seed = 2 ** 33 + 5
    a = openloop.arrivals(np.random.default_rng([seed, 1]), 64.0, 20.0)
    b = openloop.arrivals(np.random.default_rng([seed, 1]), 64.0, 20.0)
    c = openloop.arrivals(np.random.default_rng([seed + 1, 1]), 64.0, 20.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 1280
    assert np.all(np.diff(a) > 0) and 0 < a[0] and a[-1] < 20.0
    # the same gaps in another order: same work, same spread
    ga, gc = np.diff(a, prepend=0.0), np.diff(c, prepend=0.0)
    assert np.allclose(np.sort(ga), np.sort(gc))
    assert abs(ga.mean() * 64.0 - 1.0) < 0.01
    burst = openloop.arrivals(np.random.default_rng(3), 64.0, 20.0, burst=4)
    assert len(burst) == 1280 and len(np.unique(burst)) == 320


class Fake:
    """An artifact of batch 4 that answers in 2 ms, and once, at its
    ``stall_at``-th call, takes ``stall_s``."""

    def __init__(self, stall_at=None, stall_s=0.0):
        self.meta = {"in_shapes": [[4, 8, 16, 3]], "in_dtypes": ["uint8"]}
        self.calls, self.stall_at, self.stall_s = 0, stall_at, stall_s
        self.lock = threading.Lock()

    def __call__(self, x):
        with self.lock:
            self.calls += 1
            n = self.calls
        time.sleep(self.stall_s if n == self.stall_at else 0.002)
        x = np.asarray(x)
        return (x[..., 0].astype(np.uint16),
                x[..., 0].astype(np.float32) / 255.0)


def _run(fake, monkeypatch):
    from portbench.harness import program

    c = cell("serve_nf_poisson", rate_per_s=100.0, clients=16,
             warmup_steps=0)
    c.config["rgb_shape"] = [8, 16]
    monkeypatch.setattr(program, "artifact", lambda *a, **k: fake)
    loop = openloop.OpenLoop(c, ROOT, "cpu", False)
    loop.setup(7)
    try:
        return loop.run(7, 2.0)
    finally:
        loop.close()


def test_a_stall_shows_in_the_tail(monkeypatch):
    calm = _run(Fake(), monkeypatch)
    stalled = _run(Fake(stall_at=20, stall_s=0.6), monkeypatch)
    assert calm.failed == stalled.failed == 0
    assert calm.attempted == stalled.attempted == 200
    assert calm.e2e["latency_p95_ms"] < 100
    # the requests due during the stall wait for it; those due after it
    # queue behind them: well over 5 % of the window's requests are late
    assert stalled.e2e["latency_p95_ms"] > 300
    assert stalled.e2e["latency_p95_ms"] > 3 * calm.e2e["latency_p95_ms"]
    assert {s[0] for s in calm.samples} <= set(range(8))
