"""The port's layouts, schedules and window geometry equal the JAX
package's exactly (f64 window math to 1e-12)."""

import math

import numpy as np
import pytest

from panodepth import config as jconfig
from panodepth import geometry as jgeometry

import panodepth_torch.config as tconfig
from panodepth_torch import geometry as tgeometry

from torch_port_common import LAYOUT_NAMES, configs, port_layout

D2R = math.pi / 180.0


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_layout_tables_tags_and_ranges(name):
    jl, tl = jconfig.LAYOUTS[name](), port_layout(name)
    np.testing.assert_array_equal(tl.fovs, jl.fovs)
    np.testing.assert_array_equal(tl.ranges, jl.ranges)
    assert [tl.view_tag(v) for v in range(tl.num_views)] == \
        [jl.view_tag(v) for v in range(jl.num_views)]
    for width in ((64, 256) if name == "test2" else (2048, 4096)):
        jcfg, tcfg = configs(name, width)
        np.testing.assert_array_equal(tcfg.clamped_ranges(),
                                      jcfg.clamped_ranges())
        assert tcfg.schedule == jcfg.schedule
        assert (tcfg.out_height, tcfg.layout.num_views) == \
            (jcfg.out_height, jcfg.layout.num_views)


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_layout_windows_and_spherical_to_xy(name):
    jl, tl = jconfig.LAYOUTS[name](), port_layout(name)
    jw, tw = jgeometry.layout_windows(jl.fovs), tgeometry.layout_windows(tl.fovs)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    rng = np.random.RandomState(3)
    azi = rng.uniform(0, 2 * math.pi, (9, 11))
    zen = rng.uniform(0.2, math.pi - 0.2, (9, 11))
    for v in range(tl.num_views):
        jwin = jgeometry.Window(*(a[v] for a in jw))
        jx, jy = jgeometry.spherical_to_xy(jwin, azi, zen, xp=np)
        tx, ty = tgeometry.spherical_to_xy(tgeometry.window_at(tw, v), azi, zen)
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-12)
        ja, jz = jgeometry.xy_to_spherical(jwin, jx, jy, xp=np)
        ta, tz = tgeometry.xy_to_spherical(tgeometry.window_at(tw, v), tx, ty)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-12)


def test_geometry_runs_on_torch_tensors():
    import torch

    fovs = tconfig.five_fold_leres().fovs
    wn = tgeometry.layout_windows(fovs)
    wt = tgeometry.make_window(*(torch.tensor(fovs[:, i]) for i in range(4)),
                               xp=torch)
    for a, b in zip(wn, wt):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("width", [32, 64, 256, 1000, 2048, 4096, 8192])
def test_jacobi_schedule(width):
    assert tconfig.jacobi_schedule(width) == jconfig.jacobi_schedule(width)


def _refusal(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


def test_validate_layout_refusals():
    cases = [
        # fovs/ranges of different shapes
        (np.zeros((2, 4)), np.zeros((3, 4)), (2048,)),
        # an azimuth range that rounds to one pixel column
        (np.array([(0, 90 * D2R, 30 * D2R, 150 * D2R)]),
         np.array([(10 * D2R, 10.01 * D2R, 40 * D2R, 140 * D2R)]), (2048,)),
        (np.array([(0, 90 * D2R, 30 * D2R, 150 * D2R)]),
         np.array([(10 * D2R, 12 * D2R, 40 * D2R, 140 * D2R)]), (64,)),
    ]
    for fovs, ranges, widths in cases:
        want = _refusal(lambda: jconfig.validate_layout(
            jconfig.ViewLayout("bad", fovs, ranges), widths))
        got = _refusal(lambda: tconfig.validate_layout(
            tconfig.ViewLayout("bad", fovs, ranges), widths))
        assert want is not None and got == want
    # a usable layout passes both
    good = jconfig.LAYOUTS["3fold"]()
    jconfig.validate_layout(good, (2048,))
    tconfig.validate_layout(tconfig.three_fold(), (2048,))


def test_merge_config_refusals():
    for kw in (dict(out_width=100), dict(out_width=16)):
        want = _refusal(lambda: jconfig.MergeConfig(**kw))
        got = _refusal(lambda: tconfig.MergeConfig(**kw))
        assert want is not None and got == want
    # the message lists the registered layouts, which differ between the
    # packages once other test modules have registered their own
    for make in (jconfig.MergeConfig, tconfig.MergeConfig):
        assert _refusal(lambda: make(layout_name="nope")).startswith(
            "unknown layout 'nope'; have [")


def test_layout_from_arrays_registers():
    jl = jconfig.LAYOUTS["4fold"]()
    tl = tconfig.layout_from_arrays("4fold_copy", jl.fovs, jl.ranges)
    assert tconfig.LAYOUTS["4fold_copy"]() is tl
    cfg = tconfig.MergeConfig(layout_name="4fold_copy", out_width=256)
    np.testing.assert_array_equal(cfg.clamped_ranges(),
                                  jconfig.MergeConfig("4fold", 256).clamped_ranges())
