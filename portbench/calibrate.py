"""Readings that set a cell's limits and rate, many seeds in one process
(the program built once): ``python3 portbench/calibrate.py --workload
<name> --seeds 1,2,3 [--control-seeds 1,2,3] [--seconds 3]
[--sweep 40,60,80 [--sweep-seeds 1,2]]``.

For each seed: a window at the cell's own load on that seed's pool, and
the gaps of its sampled outputs against the reference (the lower
readings); for each control seed, the gaps of the control, the reference
one precision step below the configuration's, on the same inputs (the
upper readings).  ``--sweep`` runs an open-loop cell's window at each
rate, once for each of ``--sweep-seeds``, and prints its latencies,
failures, batch fill and the latency of the last quarter of requests
against the first (a growing backlog).
One JSON line a reading on standard output."""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import cells, check  # noqa: E402
from portbench.harness.main import loop_for  # noqa: E402
from portbench.harness.pool import make_pool  # noqa: E402


def ints(s):
    return [int(v) for v in s.split(",") if v]


def main():
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--sweep", default="")
    p.add_argument("--sweep-seeds", type=ints, default=[])
    args = p.parse_args()
    cell = cells.load(args.workload)
    dev = torch.device("cuda", 0)
    loop = loop_for(cell, dev, False)
    first = (args.seeds or args.control_seeds or [1])[0]
    loop.setup(first)
    print(json.dumps({"setup_s": time.monotonic() - STARTED}), flush=True)
    rates = [float(r) for r in args.sweep.split(",") if r]
    for seed, rate in ((s, r) for s in args.sweep_seeds or [first]
                       for r in rates):
        cell.traffic["rate_per_s"] = rate
        res = loop.run(seed, args.seconds)
        lat = res.latency_ms
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "rate": rate, "seed": seed, "attempted": res.attempted,
            "failed": res.failed, **res.e2e,
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "fill": res.batcher["items"] / max(
                1, res.batcher["batches"] * res.batch),
            "first_quarter_ms": float(np.mean(lat[:q])),
            "last_quarter_ms": float(np.mean(lat[-q:])),
            "lateness_max_ms": float(res.lateness_ms.max()),
            "call_ms": float(np.median(res.call_ms)) if res.call_ms
            else None}), flush=True)
    for seed in sorted(set(args.seeds) | set(args.control_seeds),
                       key=(args.seeds + args.control_seeds).index):
        loop.pool = make_pool(seed, cell.traffic["pool"],
                              cell.config["rgb_shape"], dev)
        t = time.monotonic()
        res = loop.run(seed, args.seconds)
        row = {"seed": seed, **res.e2e, "attempted": res.attempted,
               "failed": res.failed}
        t = time.monotonic()
        if seed in args.seeds:
            row["program"] = check.gaps(cell.config, cells.ROOT, res.samples,
                                        res.pool, dev)
            row["reference_s"] = time.monotonic() - t
        if seed in args.control_seeds:
            row["control"] = check.control_gaps(cell.config, cells.ROOT,
                                                res.samples, res.pool, dev)
        print(json.dumps(row), flush=True)
    loop.close()
    print(json.dumps({"peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "total_s": time.monotonic() - STARTED}), flush=True)


if __name__ == "__main__":
    main()
