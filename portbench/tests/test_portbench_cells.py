"""Each cell, configuration, traffic mix and per-layer reader of
``BENCHMARK.json`` loads by its name, the file keeps to the benchmark's
contract, and a later cell, mix or metric is added by new files and new
entries alone."""

import copy
import json
import re
import shutil

import pytest

from tiny import ROOT

from portbench.harness import cells, program
from portbench.reference.e2e import Reference

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_by_name(workload):
    c = cells.load(workload)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == workload)
    assert c.traffic["loop"] in ("closed", "open")
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_stated_pipeline_is_what_both_sides_run(config):
    """The layout and the Jacobi iterations a configuration states are
    checked against what the program and the reference run."""
    cfg = json.loads((ROOT / next(c["file"] for c in BENCH["configs"]
                                  if c["name"] == config)).read_text())
    assert program.merge_config(cfg).schedule == tuple(
        cfg["pipeline"]["jacobi"])
    wrong = copy.deepcopy(cfg)
    wrong["pipeline"]["jacobi"] = [100, 100, 50]
    with pytest.raises(ValueError, match="Jacobi"):
        program.merge_config(wrong)
    with pytest.raises(ValueError, match="Jacobi"):
        Reference(wrong, str(ROOT), "cpu")
    wrong = copy.deepcopy(cfg)
    wrong["pipeline"]["layout_spec"]["margin_deg"] += 1.0
    with pytest.raises(ValueError, match="layout_spec"):
        program.merge_config(wrong)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads_by_name(metric):
    read = cells.reader(metric)
    assert callable(read)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(WORKLOADS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix and a metric
    through new files and new entries; the harness finds all three."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "portbench" / "traffic" / "b4.json").write_text(json.dumps(
        {"loop": "closed", "batch": 4, "pool": 16}))
    (tmp_path / "portbench" / "metrics" / "steps.batch.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench["workloads"].append({"name": "e2e_nf_b4", "config": "fastpano_nf",
                               "traffic": "b4", "chips": 1, "why": "b4"})
    bench["end_to_end"][0]["workloads"].append("e2e_nf_b4")
    bench["per_layer"].append({"name": "steps.batch", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "pano_per_s",
                               "workloads": ["e2e_nf_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "zoo").symlink_to(ROOT / "zoo")
    c = cells.load("e2e_nf_b4", root=tmp_path)
    assert c.traffic["batch"] == 4
    assert [m["name"] for m in c.per_layer] == ["steps.batch"]
    assert cells.reader("steps.batch", root=tmp_path)(None) == 1.0
