"""The rest of the port's single-device library surface against the JAX
package, on the same numpy inputs made from a seed, at the small layouts
(``test2`` at 64, ``5fold_leres`` at 128): ``geometry.contains`` /
``window_coords``; registration's ``fit_poly`` / ``apply_poly``,
``fit_reciprocal`` / ``apply_reciprocal``, ``fit_cubic_global`` and
``_chol_solve_factory``; fusion's ``_pixel_coords``, ``lap4``,
``resample_view`` and ``solve_depth_by_smoothing``; projection's
``elevated_zenith``,
``extract_view_elevated`` and ``depth_view_to_equirect``; and the
perspective net's ``_percentile99`` in each ``PANODEPTH_P99`` mode.
Mirrors ``tests/test_registration.py:94-165``, ``tests/test_fusion.py:
106``, ``tests/test_ops.py:67-78``, ``tests/test_geometry.py:99-111`` and
``tests/test_models.py:205``.

Bars:

* Host float64 (``contains``, ``window_coords``): bit-equal.
* ``fit_poly`` degrees 1 and 2 measured bit-equal, degree 4 1.3e-6 in a
  coefficient (the Gram matrix's f32 sums in another order); held to the
  fitted curves within 1e-5 of JAX's and JAX's own bar against the data
  (2e-3).  Degree 3 returns ``fit_cubic`` exactly.
* ``fit_reciprocal``: the parameters have a gauge freedom (a, b, c scale
  together), so the fitted curves are compared: within 1e-5 of JAX's on a
  grid (measured 6e-8), and within JAX's 1e-4 of the data.
* ``fit_cubic_global``: the f64 oracle's bar of tests/test_registration.py
  (1e-3 on its curve) and 1e-4 of JAX's curve.
* ``_pixel_coords``, ``lap4``, ``resample_view``, ``depth_view_to_equirect``,
  ``solve_depth_by_smoothing``: bit-equal (the nearest taps' f32 window
  coords agree on these grids; the smoother is the same f32 arithmetic).
* ``extract_view_elevated``: as the extraction (f32 ray angles): 1e-5 on a
  smooth panorama, 1e-4 on noise.
* ``_percentile99``: ``topk`` and ``approx`` bit-equal to JAX's (off the
  TPU JAX's ``approx_max_k`` returns the exact top k); ``sort`` within
  JAX's 1e-5 relative of ``jnp.percentile``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import fusion as jfusion
from panodepth import geometry as jgeometry
from panodepth import registration as jreg
from panodepth.config import LAYOUTS as JAX_LAYOUTS
from panodepth.models import perspective as jpersp
from panodepth.ops import projection as jproj

from panodepth_torch import fusion as tfusion
from panodepth_torch import geometry as tgeometry
from panodepth_torch import registration as treg
from panodepth_torch.config import LAYOUTS as PORT_LAYOUTS
from panodepth_torch.models import perspective as tpersp
from panodepth_torch.ops import projection as tproj

from conftest import make_equirect
from reference_impl import clamp01eps, emap_value_at_coord
from torch_port_common import leres_scene, tiny_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    return tiny_scene()


@pytest.fixture(scope="module")
def leres():
    return leres_scene()


# geometry -----------------------------------------------------------------

def test_contains_matches_jax():
    for name in ("5fold_leres", "3fold"):
        jl, tl = JAX_LAYOUTS[name](), PORT_LAYOUTS[name]()
        rng = np.random.RandomState(4)
        azi = rng.uniform(0, 2 * np.pi, 500)
        zen = rng.uniform(0, np.pi, 500)
        for v in range(jl.num_views):
            jw = jgeometry.make_window(*jl.fovs[v], xp=np)
            tw = tgeometry.make_window(*tl.fovs[v])
            for thr in (1e-3, 0.0, 0.05):
                np.testing.assert_array_equal(
                    tgeometry.contains(tw, azi, zen, threshold=thr),
                    jgeometry.contains(jw, azi, zen, threshold=thr))
    # tests/test_geometry.py:99-105
    fov = PORT_LAYOUTS["5fold_leres"]().fovs[0]
    win = tgeometry.make_window(*fov)
    ca, cz = (fov[0] + fov[1]) / 2, (fov[2] + fov[3]) / 2
    assert tgeometry.contains(win, ca, cz)
    assert not tgeometry.contains(win, ca + math.pi, cz)


@pytest.mark.parametrize("center,ah,zh", [
    ((math.radians(90), math.radians(90)), math.radians(30),
     math.radians(20)),
    ((0.3, 1.1), 0.6, 0.4), ((5.9, 2.2), 1.2, 0.7)])
def test_window_coords_bit_equal(center, ah, zh):
    got = tgeometry.window_coords(center, ah, zh)
    want = jgeometry.window_coords(center, ah, zh)
    assert len(got) == 4
    for (ga, gz), (wa, wz) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gz, wz)
    lu, ld, rd, ru = got
    if center[0] == math.radians(90):   # tests/test_geometry.py:108-111
        assert abs((lu[0] + ru[0]) / 2 - center[0]) < 1e-9


# registration -------------------------------------------------------------

@pytest.mark.parametrize("deg", [1, 2, 3, 4])
def test_fit_poly_matches_jax(deg):
    """tests/test_registration.py:145-157 on both packages."""
    rng = np.random.RandomState(11)
    x = rng.uniform(0.05, 0.95, 2000).astype(np.float32)
    # the JAX test draws the degrees' coefficients in turn: skip to this
    # degree's draw
    for d in range(1, deg):
        rng.uniform(-0.5, 0.8, d + 1)
    true = rng.uniform(-0.5, 0.8, deg + 1)
    y = np.polyval(true, x).astype(np.float32)
    w = np.ones_like(x)
    want = np.asarray(jreg.fit_poly(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(w), degree=deg))
    got = treg.fit_poly(torch.tensor(x), torch.tensor(y), torch.tensor(w),
                        degree=deg)
    assert got.shape == (deg + 1,) and got.dtype == torch.float32
    got = got.numpy()
    grid = np.linspace(0.05, 0.95, 64)
    np.testing.assert_allclose(np.polyval(got, grid), np.polyval(want, grid),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.polyval(got, x), y, atol=2e-3)
    if deg == 3:
        np.testing.assert_array_equal(got, treg.fit_cubic(
            torch.tensor(x), torch.tensor(y), torch.tensor(w)).numpy())


def test_fit_poly_weighted_2d_input_degree3_is_fit_cubic():
    """fit_poly flattens its inputs as JAX's does; degree 3 is fit_cubic."""
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.uniform(0.3, 0.42, (30, 40)).astype(np.float32))
    y = 0.8 * x ** 3 - 0.5 * x + 0.05
    w = torch.tensor((rng.rand(30, 40) > 0.2).astype(np.float32))
    assert torch.equal(treg.fit_poly(x, y, w),
                       treg.fit_cubic(x.reshape(-1), y.reshape(-1),
                                      w.reshape(-1)))
    for deg in (1, 2, 4):
        want = np.asarray(jreg.fit_poly(jnp.asarray(x.numpy()),
                                        jnp.asarray(y.numpy()),
                                        jnp.asarray(w.numpy()), degree=deg))
        got = treg.fit_poly(x, y, w, degree=deg).numpy()
        grid = np.linspace(0.3, 0.42, 32)
        np.testing.assert_allclose(np.polyval(got, grid),
                                   np.polyval(want, grid), rtol=0, atol=1e-5)


def test_apply_poly_matches_jax_and_apply_cubic(tiny):
    img = tiny["pmaps"][0]
    for coeffs in ([0.3, -0.2, 1.1, 0.05], [0.9, 0.02], [0.1, -0.4, 1.2],
                   [0.5, -0.7, 0.3, 0.8, 0.01]):
        c = np.asarray(coeffs, np.float32)
        got = treg.apply_poly(torch.tensor(img), torch.tensor(c)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jreg.apply_poly(jnp.asarray(img),
                                            jnp.asarray(c))),
            rtol=0, atol=1e-6)
    abcd = torch.tensor([0.3, -0.2, 1.1, 0.05])
    np.testing.assert_allclose(
        treg.apply_poly(torch.tensor(img), abcd).numpy(),
        treg.apply_cubic(torch.tensor(img), abcd).numpy(), atol=1e-6)


def test_chol_solve_factory_matches_jax():
    rng = np.random.RandomState(8)
    for n in (2, 3, 5):
        a = rng.randn(40, n).astype(np.float32)
        g = a.T @ a
        rhs = rng.randn(n).astype(np.float32)
        want = np.asarray(jreg._chol_solve_factory(jnp.asarray(g))(
            jnp.asarray(rhs)))
        got = treg._chol_solve_factory(torch.tensor(g))(torch.tensor(rhs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g @ got.numpy(), rhs, rtol=0, atol=1e-3)


def test_fit_reciprocal_matches_jax_curves():
    """tests/test_registration.py:103-112: the curves, not the gauge-free
    parameters."""
    rng = np.random.RandomState(5)
    x = rng.uniform(0.1, 0.9, 500).astype(np.float32)
    y = (0.7 / (1.3 * x + 0.4) + 0.05).astype(np.float32)
    want = np.asarray(jreg.fit_reciprocal(jnp.asarray(x), jnp.asarray(y),
                                          jnp.ones(500)))
    got = treg.fit_reciprocal(torch.tensor(x), torch.tensor(y),
                              torch.ones(500))
    assert got.shape == (4,) and bool(torch.isfinite(got).all())
    p = got.numpy()
    np.testing.assert_allclose(p[2] / (p[0] * x + p[1]) + p[3], y,
                               atol=1e-4)
    grid = np.linspace(0.0, 1.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        treg.apply_reciprocal(torch.tensor(grid), got).numpy(),
        np.asarray(jreg.apply_reciprocal(jnp.asarray(grid),
                                         jnp.asarray(want))),
        rtol=0, atol=1e-5)


def test_apply_reciprocal_clamps_and_matches_jax():
    img = np.linspace(-0.5, 1.5, 64, dtype=np.float32)
    abcd = np.asarray([1.0, 0.5, 0.4, 0.1], np.float32)
    got = treg.apply_reciprocal(torch.tensor(img), torch.tensor(abcd))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jreg.apply_reciprocal(jnp.asarray(img),
                                                      jnp.asarray(abcd))))
    x = np.clip(img, 1e-4, 1 - 1e-4)
    np.testing.assert_allclose(got.numpy(), np.clip(0.4 / (x + 0.5) + 0.1,
                                                    0, 1), atol=1e-6)


@pytest.mark.parametrize("scene", ["tiny", "leres"])
def test_fit_cubic_global_matches_jax_and_oracle(scene, request):
    """tests/test_registration.py:115-142: against the f64 oracle of the
    literal SolveDepthToDepth2 samples, and against JAX."""
    sc = request.getfixturevalue(scene)
    zr = sc["jcfg"].zenith_range
    emap = np.asarray(sc["emap"], np.float32)
    result = np.asarray(jreg.apply_cubic(jnp.asarray(emap),
                                         jnp.asarray([0.0, 0.0, 0.8, 0.05])))
    want = np.asarray(jreg.fit_cubic_global(jnp.asarray(result),
                                            jnp.asarray(emap), zr))
    got = treg.fit_cubic_global(torch.tensor(result), torch.tensor(emap),
                                sc["tcfg"].zenith_range).numpy()
    h, w = result.shape
    y0 = int(math.floor(h * zr[0] / math.pi))
    y1 = int(math.ceil(h * zr[1] / math.pi))
    xs, ys = [], []
    for yy in range(y0, y1 + 1):
        for xx in range(w):
            xs.append(clamp01eps(float(result[yy, xx])))
            ys.append(clamp01eps(emap_value_at_coord(
                emap, xx / (w - 1) * 2 * math.pi, yy / (h - 1) * math.pi)))
    xv, yv = np.asarray(xs), np.asarray(ys)
    oracle, *_ = np.linalg.lstsq(
        np.stack([xv ** 3, xv ** 2, xv, np.ones_like(xv)], -1), yv,
        rcond=None)
    grid = np.linspace(xv.min(), xv.max(), 50)
    np.testing.assert_allclose(np.polyval(got, grid),
                               np.polyval(oracle, grid), atol=1e-3)
    np.testing.assert_allclose(np.polyval(got, grid), np.polyval(want, grid),
                               rtol=0, atol=1e-4)


# fusion -------------------------------------------------------------------

def test_lap4_matches_jax():
    """tests/test_fusion.py:106-111, and bit-equal to JAX on noise."""
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    lap = tfusion.lap4(torch.tensor(img)).numpy()
    expect = img[1, 0] - 0.25 * (img[1, 3] + img[1, 1] + img[0, 0]
                                 + img[2, 0])
    np.testing.assert_allclose(lap[1, 0], expect, atol=1e-6)
    noise = np.random.RandomState(2).rand(17, 23).astype(np.float32)
    for a in (img, noise):
        np.testing.assert_array_equal(
            tfusion.lap4(torch.tensor(a)).numpy(),
            np.asarray(jfusion.lap4(jnp.asarray(a))))


@pytest.mark.parametrize("width,height", [(64, 32), (2048, 1024),
                                          (333, 171)])
def test_pixel_coords_bit_equal(width, height):
    """The f32 iota's spherical coords, as JAX computes them."""
    for got, want in zip(tfusion._pixel_coords(width, height),
                         jfusion._pixel_coords(width, height)):
        assert got.dtype == torch.float32 and got.shape == (height, width)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fusion_plan_windows_match_jax(leres):
    jw = jfusion.build_fusion_plan(leres["jcfg"]).windows
    tw = tfusion.build_fusion_plan(leres["tcfg"]).windows
    for a, b in zip(jw, tw):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("width", [128, 256])
def test_resample_view_bit_equal(leres, width):
    jplan = jfusion.build_fusion_plan(leres["jcfg"])
    tplan = tfusion.build_fusion_plan(leres["tcfg"])
    for v in range(15):
        want = np.asarray(jfusion.resample_view(
            jnp.asarray(leres["pmaps"][v]),
            jax.tree.map(lambda a: a[v], jplan.windows), width, width // 2))
        got = tfusion.resample_view(
            torch.tensor(leres["pmaps"][v]),
            tgeometry.window_at(tplan.windows, v), width, width // 2)
        assert got.shape == (width // 2, width)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scene,iterations", [("tiny", 50), ("leres", 500)])
def test_solve_depth_by_smoothing_bit_equal(scene, iterations, request):
    """tests/test_ops.py:67-78 on both packages: the paste, the unclamped
    re-gather, the mask and the rounds, bit for bit; also from u16 maps
    and from a list of maps."""
    sc = request.getfixturevalue(scene)
    jplan = jfusion.build_fusion_plan(sc["jcfg"])
    tplan = tfusion.build_fusion_plan(sc["tcfg"])
    jo, jb = jfusion.solve_depth_by_smoothing(jnp.asarray(sc["pmaps"]),
                                              jplan, iterations=iterations)
    to, tb = tfusion.solve_depth_by_smoothing(torch.tensor(sc["pmaps"]),
                                              tplan, iterations=iterations)
    assert to.dtype == torch.uint16
    assert to.shape == (sc["tcfg"].out_height, sc["tcfg"].out_width)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    lvl = tplan.levels[-1]
    x_lo, x_hi, y_lo, y_hi = lvl.bboxes[0]
    out = to.numpy()
    assert out[(y_lo + y_hi) // 2, (x_lo + x_hi) // 2] > 0
    if scene == "tiny":
        assert out[lvl.height0 + 1, 0] == 0
    u16 = (np.clip(sc["pmaps"], 0, 1) * 65535).astype(np.uint16)
    jo16, _ = jfusion.solve_depth_by_smoothing(jnp.asarray(u16), jplan,
                                               iterations=5)
    to16, _ = tfusion.solve_depth_by_smoothing(
        [torch.tensor(p) for p in u16], tplan, iterations=5)
    np.testing.assert_array_equal(to16.numpy(), np.asarray(jo16))


# projection ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(camera_height=0.5,
                                         fovy=math.radians(60))])
def test_extract_view_elevated_matches_jax(kw):
    smooth = np.stack([make_equirect(128, 64) * s + o for s, o in
                       ((0.9, 0.05), (0.7, 0.2), (0.5, 0.3))], -1)
    noise = np.random.RandomState(1).rand(64, 128, 3)
    jl, tl = JAX_LAYOUTS["5fold_leres"](), PORT_LAYOUTS["5fold_leres"]()
    for img, tol in ((smooth, 1e-5), (noise, 1e-4)):
        img = img.astype(np.float32)
        for v in (0, 7, 14):
            want = np.asarray(jproj.extract_view_elevated(
                jnp.asarray(img), jl.fovs[v], 64, **kw))
            got = tproj.extract_view_elevated(torch.tensor(img), tl.fovs[v],
                                              64, **kw)
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    zen = np.linspace(0.2, 2.9, 50).astype(np.float32)
    np.testing.assert_allclose(
        tproj.elevated_zenith(torch.tensor(zen), **kw).numpy(),
        np.asarray(jproj.elevated_zenith(jnp.asarray(zen), **kw)), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("width", [128, 256])
def test_depth_view_to_equirect_bit_equal(width):
    rng = np.random.RandomState(6)
    jl, tl = JAX_LAYOUTS["5fold_leres"](), PORT_LAYOUTS["5fold_leres"]()
    for v in (0, 5, 7, 14):
        d = rng.rand(62, 64).astype(np.float32)
        want, wi = jproj.depth_view_to_equirect(jnp.asarray(d), jl.fovs[v],
                                                width, width // 2)
        got, gi = tproj.depth_view_to_equirect(torch.tensor(d), tl.fovs[v],
                                               width, width // 2)
        assert got.shape == (width // 2, width) and gi.dtype == torch.bool
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bool(gi.any()) and not bool(gi.all())


# the perspective net's 99th percentile -------------------------------------

@pytest.mark.parametrize("n", [100, 4096, 65536])
def test_percentile99_modes_match_jax(monkeypatch, n):
    """tests/test_models.py:205-238 on both packages."""
    flat = np.random.RandomState(11).rand(3, n).astype(np.float32)
    monkeypatch.delenv("PANODEPTH_P99", raising=False)
    default = tpersp._percentile99(torch.tensor(flat)).numpy()
    want_sort = np.asarray(jnp.percentile(jnp.asarray(flat), 99.0, axis=1))
    np.testing.assert_allclose(default, want_sort, rtol=1e-5, atol=0)
    got = {}
    for mode in ("sort", "topk", "approx"):
        monkeypatch.setenv("PANODEPTH_P99", mode)
        got[mode] = tpersp._percentile99(torch.tensor(flat)).numpy()
        want = np.asarray(jpersp._percentile99(jnp.asarray(flat)))
        if mode == "sort":
            np.testing.assert_array_equal(got[mode], default)
            np.testing.assert_allclose(got[mode], want, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(got[mode], want)
    np.testing.assert_array_equal(got["approx"], got["topk"])
    np.testing.assert_allclose(got["topk"], got["sort"], rtol=0, atol=2e-6)
    monkeypatch.setenv("PANODEPTH_P99", "nearest")
    with pytest.raises(ValueError, match="PANODEPTH_P99"):
        tpersp._percentile99(torch.tensor(flat))
