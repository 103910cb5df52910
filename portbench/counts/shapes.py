"""The shapes each net of a configuration computes on, for one panorama:
the reference nets (``portbench/reference``) run on the meta device at
the cell's sizes and record every conv, dense layer and GroupNorm.  The
counts are of the work the configuration asks for, the same whatever
implements it."""

from __future__ import annotations

import functools
import json
import os

import torch

from ..reference import layout as L
from ..reference.nets import NETS, read_npz


def view_groups(config: dict):
    """[((h, w) run size, number of views)] of the perspective net: each
    view shape at the configuration's view width, rounded up to multiples
    of 32 as the net runs it."""
    fovs, _ = L.layout_tables(config["pipeline"]["layout_spec"])
    counts = {}
    for fov in fovs:
        h, w = L.view_shape(fov, config["perspective"]["view_width"])
        key = tuple(max(32, -(-d // 32) * 32) for d in (h, w))
        counts[key] = counts.get(key, 0) + 1
    return sorted(counts.items())


def _records(net_cfg: dict, root: str, inputs):
    net = NETS[net_cfg["net"]](read_npz(os.path.join(root,
                                                     net_cfg["checkpoint"]),
                                        "meta"))
    net.record = []
    with torch.no_grad():
        for shape in inputs:
            net(torch.empty(shape, device="meta"))
    return net.record


@functools.lru_cache(maxsize=8)
def _cached(config_json: str, root: str):
    config = json.loads(config_json)
    bw = config["baseline"]["width"]
    base = _records(config["baseline"], root, [(1, bw // 2, bw, 3)])
    persp = _records(config["perspective"], root,
                     [(n, h, w, 3) for (h, w), n in view_groups(config)])
    return {"baseline": base, "perspective": persp}


def records(config: dict, root: str) -> dict:
    """{"baseline": [...], "perspective": [...]}: each net's recorded
    operations for one panorama (dicts with ``op`` conv, dense or
    group_norm and their shapes)."""
    return _cached(json.dumps(config, sort_keys=True), root)
