"""On the card (``python -m pytest portbench/tests -m cuda``): a short
traced run of each batch cell prints a result whose every per-layer metric
was found in the trace, every share of a peak or roofline at most 100 %,
and ``correct`` true."""

import json
import subprocess
import sys

import pytest

from tiny import ROOT

from portbench.harness import cells


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["e2e_nf_b8", "e2e_int8_b8"])
def test_traced_run_reads_every_layer(card, workload):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", "2147483659", "--seconds", "6",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["check"]
    want = {m["name"] for m in cells.load(workload).per_layer}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
