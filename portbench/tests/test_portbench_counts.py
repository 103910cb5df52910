"""The operation and byte counts of ``portbench/counts`` at the cells'
shapes equal the values worked out by hand from the nets and kernels."""

import json

import pytest

from tiny import ROOT

from portbench.counts import work
from portbench.reference import layout as L


def config(name):
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["fastpano_nf", "fastpano_gn_int8"])
def test_nets_work_a_panorama(name):
    """479.35 GFLOP a panorama: 445.04 in the perspective net on 15 views
    at 256x256, 34.31 in FastPanoNet at 256x512."""
    flops = work.net_flops(config(name), str(ROOT))
    assert round(sum(flops.values()) / 1e9, 2) == 479.35
    recs = work.records(config(name), str(ROOT))
    persp = sum(work.conv_flops(r) for r in recs["perspective"]
                if r["op"] == "conv")
    assert round(persp / 1e9, 2) == 445.04


def test_int8_bounds():
    """qconv 0.2249 ms a forward at N = 15 (operations), the quantization
    0.3558 ms (1191.9 MB)."""
    cfg = config("fastpano_gn_int8")
    q = work.qconv(cfg, str(ROOT))
    assert q["bound_by"] == "operations"
    assert round(q["bound_s"] * 1e3, 4) == 0.2249
    z = work.quantize(cfg, str(ROOT))
    assert round(z["bytes"] / 1e6, 1) == 1191.9
    assert round(z["bound_s"] * 1e3, 4) == 0.3558
    assert work.qconv(config("fastpano_nf"), str(ROOT))["bound_s"] == 0


def test_jacobi_and_groupnorm_bounds():
    """14 operations a covered pixel-iteration and 13 bytes a pixel over
    the 2048 pyramid; FastPanoNet's 29 GroupNorms 0.023 ms."""
    cfg = config("fastpano_nf")
    _, ranges = L.layout_tables(cfg["pipeline"]["layout_spec"])
    levels = L.pyramid(ranges, 2048)
    assert [(lv.width, lv.iterations) for lv in levels] == [
        (512, 200), (1024, 100), (2048, 50)]
    j = work.jacobi(cfg)
    assert j["ops"] == 14 * sum(int((lv.inv_cov > 0).sum()) * lv.iterations
                                for lv in levels)
    assert j["bytes"] == 13 * sum(lv.width * lv.height for lv in levels)
    assert round(j["bound_s"] * 1e3, 4) == 0.0273
    recs = work.records(cfg, str(ROOT))["baseline"]
    assert sum(r["op"] == "group_norm" for r in recs) == 29
    assert round(work.groupnorm(cfg, str(ROOT))["bound_s"] * 1e3, 3) == 0.023
