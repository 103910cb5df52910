"""Fusion of the port against the JAX package: the f64 host plan and gather
tables exactly, the stencil and the plain Jacobi to f32 rounding, the
Pallas kernel (interpret mode) where its precondition holds, the hand
goldens of tests/test_golden_seam.py, and fuse to 2 u16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import fusion as jfusion
from panodepth.kernels import jacobi as jkernel

from panodepth_torch import fusion as tfusion

from test_golden_seam import _emap, _hand_expected_row2
from torch_port_common import configs, leres_scene, tiny_scene


@pytest.mark.parametrize("layout,width", [("5fold_leres", 128),
                                          ("5fold_leres", 2048),
                                          ("4fold", 4096), ("test2", 64)])
def test_fusion_plan_equal(layout, width):
    jcfg, tcfg = configs(layout, width)
    jp, tp = jfusion.build_fusion_plan(jcfg), tfusion.build_fusion_plan(tcfg)
    assert len(tp.levels) == len(jp.levels)
    for jl, tl in zip(jp.levels, tp.levels):
        assert (tl.width, tl.height, tl.height0, tl.height1, tl.iterations,
                tl.bboxes) == (jl.width, jl.height, jl.height0, jl.height1,
                               jl.iterations, jl.bboxes)
        np.testing.assert_array_equal(tl.inv_cov, jl.inv_cov)


@pytest.mark.parametrize("layout,width,pmap_shape,emap_shape", [
    ("5fold_leres", 128, (124, 128), (64, 128)),
    ("5fold_leres", 512, (988, 1024), (128, 256)),
    ("test2", 64, (48, 64), (32, 64)),
])
def test_gather_tables_equal(layout, width, pmap_shape, emap_shape):
    jcfg, tcfg = configs(layout, width)
    plan = tfusion.build_fusion_plan(tcfg)
    for lvl in range(len(plan.levels)):
        for v in range(tcfg.layout.num_views):
            a = jfusion._view_gather_indices(jcfg, lvl, v, pmap_shape)
            b = tfusion._view_gather_indices(tcfg, lvl, v, pmap_shape)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        tfusion._level0_gather_indices(tcfg, emap_shape),
        jfusion._level0_gather_indices(jcfg, emap_shape))


def _relax_case(h=32, w=64, seed=0):
    """Random buffer/target with coverage that includes all four edges."""
    rng = np.random.RandomState(seed)
    buf = rng.uniform(0, 1, (h, w)).astype(np.float32)
    tgt = rng.normal(0, 0.05, (h, w)).astype(np.float32)
    cov = rng.rand(h, w) < 0.6
    cov[0], cov[-1], cov[:, 0], cov[:, -1] = True, True, True, True
    return buf, tgt, cov


def test_lap4_refwrap_matches_jax():
    buf, _, _ = _relax_case()
    j = np.asarray(jfusion.lap4_refwrap(jnp.asarray(buf)))
    t = tfusion.lap4_refwrap(torch.tensor(buf)).numpy()
    # same taps and op order in f32; 1e-6 allows a last-bit rounding
    # difference between the two frameworks' CPU code
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("iterations", [1, 7, 50])
def test_jacobi_plain_matches_jax_with_covered_edges(iterations):
    buf, tgt, cov = _relax_case(seed=iterations)
    j = np.asarray(jfusion.jacobi(jnp.asarray(buf), jnp.asarray(tgt),
                                  jnp.asarray(cov), iterations, 0.5, 1e-4))
    t = tfusion.jacobi(torch.tensor(buf), torch.tensor(tgt),
                       torch.tensor(cov), iterations, 0.5, 1e-4).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_jacobi_plain_matches_pallas_interpret():
    """The TPU kernel in interpret mode, inside its precondition (covered
    rows >= HALO rows from the edge), as tests/test_kernels.py runs it."""
    rng = np.random.RandomState(4)
    h, w = 64, 128
    buf = rng.uniform(0, 1, (h, w)).astype(np.float32)
    tgt = rng.normal(0, 0.01, (h, w)).astype(np.float32)
    cov = np.zeros((h, w), bool)
    cov[h // 4: -h // 4, :] = True  # full-width rows: the seam wrap is used
    j = np.asarray(jkernel.pallas_jacobi(jnp.asarray(buf), jnp.asarray(tgt),
                                         jnp.asarray(cov), 20, 0.5, 1e-4,
                                         interpret=True))
    t = tfusion.jacobi(torch.tensor(buf), torch.tensor(tgt),
                       torch.tensor(cov), 20, 0.5, 1e-4).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_stencil_matches_hand_computed_seam_wrap():
    """tests/test_golden_seam.py's hand values from the C++ text: the
    port's stencil and update reproduce every column of row 2."""
    buf = _emap().copy()
    buf[0] = 0.0  # level-0 init zeroes rows outside the band
    B = torch.tensor(buf)
    upd = B + (0.0 - tfusion.lap4_refwrap(B)) * 0.5
    blended = (upd * (1 - 1e-4) + B * 1e-4).numpy()
    np.testing.assert_allclose(blended[2], _hand_expected_row2(), atol=2e-6)
    # one Jacobi iteration with row 2 covered gives the same row
    cov = torch.zeros(buf.shape, dtype=torch.bool)
    cov[2] = True
    one = tfusion.jacobi(B, torch.zeros_like(B), cov, 1, 0.5, 1e-4).numpy()
    np.testing.assert_allclose(one[2], np.clip(_hand_expected_row2(), 0, 1),
                               atol=2e-6)
    np.testing.assert_array_equal(one[[0, 1, 3]], buf[[0, 1, 3]])


def test_cylindrical_wrap_would_fail():
    """The golden discriminates: a plain cylindrical roll misses by
    thousands of u16 at both seam columns, the port's stencil does not."""
    buf = _emap().copy()
    buf[0] = 0.0
    B = torch.tensor(buf)
    cyl = B - 0.25 * (torch.roll(B, 1, 1) + torch.roll(B, -1, 1)
                      + torch.roll(B, 1, 0) + torch.roll(B, -1, 0))
    want = _hand_expected_row2()
    blended = ((B - cyl * 0.5) * (1 - 1e-4) + B * 1e-4).numpy()
    assert abs(blended[2, 0] - want[0]) * 65535 > 1000
    assert abs(blended[2, 7] - want[7]) * 65535 > 1000


def test_upsample2x_and_init_level0_match_jax():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        tfusion.upsample2x(torch.tensor(a)).numpy(),
        np.asarray(jfusion.upsample2x(jnp.asarray(a))))
    sc = leres_scene()
    jp = jfusion.build_fusion_plan(sc["jcfg"])
    tp = tfusion.build_fusion_plan(sc["tcfg"])
    np.testing.assert_array_equal(
        tfusion.init_level0(torch.tensor(sc["emap"]), tp.levels[0],
                            sc["tcfg"]).numpy(),
        np.asarray(jfusion.init_level0(jnp.asarray(sc["emap"]), jp.levels[0],
                                       sc["jcfg"])))


@pytest.mark.parametrize("scene", ["test2", "5fold_leres"])
def test_fuse_matches_jax(scene):
    sc = tiny_scene() if scene == "test2" else leres_scene()
    nv = sc["pmaps"].shape[0]
    abcd = np.tile(np.array([[0.1, -0.05, 0.95, 0.03]], np.float32), (nv, 1))
    abcd[:, 3] += np.linspace(0, 0.02, nv, dtype=np.float32)
    jp = jfusion.build_fusion_plan(sc["jcfg"])
    tp = tfusion.build_fusion_plan(sc["tcfg"])
    j_out, _ = jax.jit(lambda e, p, a: jfusion.fuse(e, p, jp, abcd=a))(
        jnp.asarray(sc["emap"]), jnp.asarray(sc["pmaps"]), jnp.asarray(abcd))
    t_out, _ = tfusion.fuse(torch.tensor(sc["emap"]), torch.tensor(sc["pmaps"]),
                            tp, abcd=torch.tensor(abcd))
    assert t_out.dtype == torch.uint16
    diff = np.abs(t_out.numpy().astype(np.int64)
                  - np.asarray(j_out).astype(np.int64))
    # same semantics; f32 rounding differences between the frameworks can
    # move a value across a u16 truncation boundary
    assert diff.max() <= 2, diff.max()
