"""``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json``.

Set-up (the process's start, the seeded pool, the program built and
every shape it replays captured, the artifact exported on a cache miss)
is timed as ``setup_s``; then the window runs for ``--seconds``.  With
``--trace 1`` the profiler records a slice of the window and the cell's
per-layer metrics are read from it.  After the window the device's peak
memory is read, the program is freed, and the sampled outputs are
compared with the plain reference.  The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the result's last key, ``check``."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from types import SimpleNamespace

from . import cells, check

# names a run may not hold in sys.modules once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "panodepth")
# the traced slice, the end of the window: at most this share of it and
# this many seconds
TRACE_SHARE, TRACE_MAX_S = 0.5, 3.0
TOP = 10


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is a forbidden one, compared
    whole (``panodepth_torch`` is not ``panodepth``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loop_for(cell, device, trace: bool):
    from .closed import ClosedLoop
    from .openloop import OpenLoop

    kind = cell.traffic["loop"]
    loops = {"closed": ClosedLoop, "open": OpenLoop}
    if kind not in loops:
        raise SystemExit(f"unknown loop {kind!r} in the traffic file")
    return loops[kind](cell, cell.root, device, trace)


def trace_window(seconds: float):
    """(start, end) of the traced slice, seconds into the window."""
    return (seconds - min(TRACE_MAX_S, TRACE_SHARE * seconds), seconds)


def per_layer(cell, res) -> dict:
    ctx = SimpleNamespace(cell=cell, config=cell.config, root=cell.root,
                          loop=cell.traffic["loop"], result=res,
                          trace=res.trace)
    out = {}
    for m in cell.per_layer:
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in trace["gaps"][:TOP]]}


def run_cell(cell, device, seed: int, seconds: float, trace: bool,
             started: float) -> dict:
    """One run of ``cell`` on ``device``: the result object the last line
    prints, without the check for the device and the loaded modules."""
    import torch

    cuda = device.type == "cuda"
    loop = loop_for(cell, device, trace)
    loop.setup(seed)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.monotonic() - started
    res = loop.run(seed, seconds, trace_window(seconds) if trace else None)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loop.close()
    del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.config["limits"]
    numbers = check.gaps(cell.config, cell.root, res.samples, res.pool,
                         device) if res.samples else {}
    if trace:
        metrics = per_layer(cell, res)
    else:
        metrics = {m["name"]: {"value": setup_s if m["name"] == "setup_s"
                               else res.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": check.verdict(numbers, limits),
           "attempted": res.attempted, "failed": res.failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = res.trace["busy_s"]
        dev["window_s"] = res.trace["window_s"]
        out["breakdown"] = breakdown(res.trace)
    out["check"] = {k: {"value": v, "limit": limits.get(k)}
                    for k, v in numbers.items()}
    return out


def main(argv=None, started: float = None) -> int:
    started = time.monotonic() if started is None else started
    args = parse(argv)
    cell = cells.load(args.workload)
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this process sees {seen}", file=sys.stderr)
        return 2
    out = run_cell(cell, torch.device("cuda", 0), args.seed, args.seconds,
                   bool(args.trace), started)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which the port may not "
              f"import", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
