"""Registration of the port against the JAX package and the reference
oracle: the f64 sample grids and gather indices exactly, the fitted cubics
to the oracle's bar (polyval atol 1e-3, tests/test_parity_default.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import registration as jreg
from panodepth.ops import sampling as jsampling

from panodepth_torch import registration as treg
from panodepth_torch.ops import sampling as tsampling

from reference_impl import RefPerspectiveMap, ref_solve_depth_to_depth
from torch_port_common import configs, leres_scene, tiny_scene


@pytest.fixture(scope="module")
def leres():
    return leres_scene()


@pytest.mark.parametrize("layout,width", [("5fold_leres", 128),
                                          ("3fold", 256), ("test2", 64)])
def test_sample_grids_and_indices_equal(layout, width):
    jcfg, tcfg = configs(layout, width)
    jg, tg = jreg.build_sample_grids(jcfg), treg.build_sample_grids(tcfg)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b, a)
    for emap_shape, pmap_shape in (((64, 128), (124, 128)),
                                   ((512, 1024), (988, 1024))):
        for view in (None, 0):
            for a, b in zip(jreg.grid_sample_indices(jg, emap_shape,
                                                     pmap_shape, view),
                            treg.grid_sample_indices(tg, emap_shape,
                                                     pmap_shape, view)):
                np.testing.assert_array_equal(b, a)


def _polyval_rows(abcd, X):
    return np.stack([np.polyval(c, X) for c in abcd])


def test_register_views_stacked_matches_jax_and_oracle(leres):
    jcfg, tcfg = leres["jcfg"], leres["tcfg"]
    j = np.asarray(jreg.register_views(jnp.asarray(leres["emap"]),
                                       jnp.asarray(leres["pmaps"]), jcfg))
    t = treg.register_views(torch.tensor(leres["emap"]),
                            torch.tensor(leres["pmaps"]), tcfg).numpy()
    ranges = jcfg.clamped_ranges()
    for v in range(0, 15, 3):
        pm = RefPerspectiveMap(leres["pmaps"][v], jcfg.layout.fovs[v], ranges[v])
        abcd_ref, X, _ = ref_solve_depth_to_depth(leres["emap"], pm,
                                                  jcfg.zenith_range)
        # the bar of test_parity_default: fitted curves over the samples
        np.testing.assert_allclose(np.polyval(t[v], X),
                                   np.polyval(abcd_ref, X), atol=1e-3)
        np.testing.assert_allclose(np.polyval(t[v], X),
                                   np.polyval(j[v], X), atol=1e-3)


def test_register_views_list_input_matches_jax():
    """Per-view maps of different shapes (the list input)."""
    sc = tiny_scene()
    pm_list = [sc["pmaps"][0], sc["pmaps"][1][:40, :56]]
    j = np.asarray(jreg.register_views(
        jnp.asarray(sc["emap"]), [jnp.asarray(p) for p in pm_list], sc["jcfg"]))
    t = treg.register_views(torch.tensor(sc["emap"]),
                            [torch.tensor(p) for p in pm_list],
                            sc["tcfg"]).numpy()
    X = np.linspace(0.05, 0.95, 64)
    np.testing.assert_allclose(_polyval_rows(t, X), _polyval_rows(j, X),
                               atol=1e-3)
    # the stacked form of the same-shape scene agrees with the list form
    t_stack = treg.register_views(torch.tensor(sc["emap"]),
                                  torch.tensor(sc["pmaps"]), sc["tcfg"])
    t_list = treg.register_views(torch.tensor(sc["emap"]),
                                 list(torch.tensor(sc["pmaps"])), sc["tcfg"])
    np.testing.assert_array_equal(t_list.numpy(), t_stack.numpy())


def test_fit_cubic_narrow_spread_matches_f64():
    """Narrow-spread data (tests/test_registration.py's regression): the
    standardized basis must hold the curve to the f64 answer; batched over
    three spreads in one call."""
    rng = np.random.RandomState(7)
    spans = ((0.45, 0.55), (0.30, 0.42), (0.05, 0.12))
    coef = np.array([0.8, -0.5, 1.2, 0.05])
    xs = np.stack([rng.uniform(lo, hi, 3000) for lo, hi in spans])
    ys = np.polyval(coef, xs) + rng.normal(0, 1e-3, xs.shape)
    got = treg.fit_cubic(torch.tensor(xs, dtype=torch.float32),
                         torch.tensor(ys, dtype=torch.float32),
                         torch.ones(xs.shape)).numpy()
    for k, (lo, hi) in enumerate(spans):
        want = np.polyfit(xs[k], ys[k], 3)
        grid = np.linspace(lo, hi, 50)
        np.testing.assert_allclose(np.polyval(got[k], grid),
                                   np.polyval(want, grid), atol=5e-4)
        j = np.asarray(jreg.fit_cubic(jnp.asarray(xs[k], jnp.float32),
                                      jnp.asarray(ys[k], jnp.float32),
                                      jnp.ones(xs.shape[1], jnp.float32)))
        np.testing.assert_allclose(np.polyval(got[k], grid),
                                   np.polyval(j, grid), atol=5e-4)


def test_apply_cubic_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.uniform(-0.2, 1.2, (24, 40)).astype(np.float32)
    abcd = np.array([0.3, -0.2, 1.1, 0.05], np.float32)
    j = np.asarray(jreg.apply_cubic(jnp.asarray(img), jnp.asarray(abcd)))
    t = treg.apply_cubic(torch.tensor(img), torch.tensor(abcd)).numpy()
    # f32 elementwise, same op order: equal up to the last bit's rounding
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_nearest_samplers_match_jax():
    rng = np.random.RandomState(2)
    img = rng.rand(37, 53).astype(np.float32)
    x = rng.uniform(0, 1, 500).astype(np.float32)
    y = rng.uniform(0, 1, 500).astype(np.float32)
    azi = rng.uniform(0, 2 * np.pi, 500).astype(np.float32)
    zen = rng.uniform(0, np.pi, 500).astype(np.float32)
    np.testing.assert_array_equal(
        tsampling.sample_unit_nearest(torch.tensor(img), torch.tensor(x),
                                      torch.tensor(y)).numpy(),
        np.asarray(jsampling.sample_unit_nearest(jnp.asarray(img),
                                                 jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(
        tsampling.sample_equirect_nearest(torch.tensor(img),
                                          torch.tensor(azi),
                                          torch.tensor(zen)).numpy(),
        np.asarray(jsampling.sample_equirect_nearest(
            jnp.asarray(img), jnp.asarray(azi), jnp.asarray(zen))))
    # numpy inputs take the same path on the host
    np.testing.assert_array_equal(
        tsampling.sample_unit_nearest(img, x, y),
        np.asarray(jsampling.sample_unit_nearest(jnp.asarray(img),
                                                 jnp.asarray(x), jnp.asarray(y))))
    u16 = (img * 65535).astype(np.uint16)
    np.testing.assert_array_equal(
        tsampling.as01_post(torch.tensor(u16)).numpy(),
        np.asarray(jsampling.as01_post(jnp.asarray(u16))))
