"""The control of ``correct``: the reference one precision step below
what the configuration states (bfloat16 convs in float8 e4m3, int8 convs
in int4), put in the program's place, fails the configuration's limits,
while the program passes them.  On the CPU at a size a test run holds
(the 5fold_leres layout 512 wide, views 64 wide, the baseline net at its
published 512); on the card the same comparison runs at the cells' own
size through ``portbench/calibrate.py``."""

import copy

import pytest
import torch

from tiny import ROOT

from portbench.harness import cells, check, program
from portbench.harness.pool import make_pool


@pytest.mark.parametrize("workload", ["e2e_nf_b8", "e2e_int8_b8"])
def test_control_fails_and_program_passes(workload):
    cfg = copy.deepcopy(cells.load(workload).config)
    cfg["rgb_shape"] = [256, 512]
    cfg["pipeline"]["out_width"] = 512
    cfg["perspective"]["view_width"] = 64
    pool = make_pool(2 ** 31 + 17, 2, cfg["rgb_shape"], "cpu")
    full, _, _ = program.build_e2e(cfg, ROOT, "cpu")
    out, bases = full(torch.from_numpy(pool))
    samples = [(k, out[k].numpy(), bases[k].numpy()) for k in range(2)]
    limits = cfg["limits"]
    ours = check.gaps(cfg, ROOT, samples, pool, "cpu")
    assert check.verdict(ours, limits), ours
    ctl = check.control_gaps(cfg, ROOT, samples, pool, "cpu")
    assert not check.verdict(ctl, limits), ctl
    assert all(ctl[k] > limits[k] for k in ctl), ctl
