"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds (the
5fold_leres layout 128 wide, views 32 wide, the baseline net at 128), for
the harness's tests; and a stand-in artifact for the open loop."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import cells, program  # noqa: E402

torch.set_num_threads(2)


def cell(workload: str, **traffic):
    c = cells.load(workload)
    cfg = copy.deepcopy(c.config)
    cfg["rgb_shape"] = [64, 128]
    cfg["pipeline"]["out_width"] = 128
    cfg["perspective"]["view_width"] = 32
    cfg["baseline"]["width"] = 128
    c.config = cfg
    c.traffic = dict(c.traffic, pool=8, batch=min(c.traffic["batch"], 4),
                     check=4, **traffic)
    return c


class Artifact:
    """The e2e graph's ``full`` as ``serve.load`` hands it to the batcher:
    called on a stacked batch, with the artifact's ``meta``."""

    def __init__(self, cell, fault=None):
        self.full, _, _ = program.build_e2e(cell.config, ROOT, "cpu")
        b = cell.traffic["batch"]
        self.meta = {"in_shapes": [[b] + list(cell.config["rgb_shape"])
                                   + [3]], "in_dtypes": ["uint8"]}
        self.fault = fault

    def __call__(self, rgbs):
        out, bases = self.full(torch.as_tensor(np.asarray(rgbs)))
        if self.fault is not None:
            out, bases = self.fault(out, bases)
        return out, bases
