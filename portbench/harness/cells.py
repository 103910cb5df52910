"""A cell of ``BENCHMARK.json`` and the files it names: the configuration
(``configs/<name>.json``), the traffic mix (``traffic/<name>.json``), the
metrics it reports and the readers of its per-layer metrics
(``metrics/<name>.py``), each found by its name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(workload: str, root: Path = ROOT, bench: dict = None):
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return SimpleNamespace(name=workload, chips=w["chips"], config=config,
                           traffic=traffic, end_to_end=e2e, per_layer=layer,
                           root=root)


def reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
