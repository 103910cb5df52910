"""The port's host oracles of the sphere mesh and the rasterized stage-A
warp (``panodepth_torch/ops/sphere.py``, ``ops/meshwarp.py``) against the
JAX package's (``panodepth/ops/sphere.py``, ``ops/meshwarp.py``): both are
numpy float64 over the same inputs, so every array is held bit-equal.
Mirrors ``tests/test_meshwarp.py`` at its reduced widths and
``tests/test_ops.py:45-64``.
"""

import math

import numpy as np
import pytest

from panodepth.config import LAYOUTS as JAX_LAYOUTS
from panodepth.ops import meshwarp as jmesh
from panodepth.ops import sphere as jsphere

from panodepth_torch import geometry as tgeometry
from panodepth_torch.config import LAYOUTS as PORT_LAYOUTS
from panodepth_torch.ops import meshwarp as tmesh
from panodepth_torch.ops import sphere as tsphere


@pytest.mark.parametrize("lat,lon", [(180, 90), (8, 6), (33, 17)])
def test_init_sphere_bit_equal(lat, lon):
    want = jsphere.init_sphere(lat, lon)
    got = tsphere.init_sphere(lat, lon)
    for name, a, b in zip(want._fields, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_init_sphere_reference_layout():
    """tests/test_ops.py:45-64 on the port."""
    mesh = tsphere.init_sphere(8, 6)
    assert mesh.vertices.shape == (48, 3)
    assert mesh.faces.shape == ((8 - 1) * (6 - 1), 4)
    assert mesh.triangles.shape == (2 * mesh.faces.shape[0], 3)
    np.testing.assert_allclose(mesh.vertices[0], [0, 0, 1], atol=1e-7)
    assert mesh.texcoords.min() == 0.0 and mesh.texcoords.max() == 1.0
    np.testing.assert_allclose(np.linalg.norm(mesh.vertices, axis=1), 1.0,
                               atol=1e-6)
    f = mesh.faces[20]
    azi, zen = tgeometry.world_to_spherical(mesh.vertices[f].mean(0)[None])
    tex = mesh.texcoords[f].mean(axis=0)
    np.testing.assert_allclose(tex[0], azi[0] / (2 * math.pi), atol=0.05)
    np.testing.assert_allclose(tex[1], zen[0] / math.pi, atol=0.05)


@pytest.mark.parametrize("view,width", [(0, 96), (7, 160), (12, 96)])
def test_mesh_warp_and_analytic_bit_equal(view, width):
    jfov = JAX_LAYOUTS["5fold_leres"]().fovs[view]
    tfov = PORT_LAYOUTS["5fold_leres"]().fovs[view]
    np.testing.assert_array_equal(tmesh.mesh_warp_texcoords(tfov, width),
                                  jmesh.mesh_warp_texcoords(jfov, width))
    np.testing.assert_array_equal(tmesh.analytic_texcoords(tfov, width),
                                  jmesh.analytic_texcoords(jfov, width))
    assert tmesh.texcoord_delta_pixels(tfov, width) == \
        jmesh.texcoord_delta_pixels(jfov, width)


@pytest.mark.parametrize("view", [0, 7, 12])
def test_tessellation_error_subpixel(view):
    """tests/test_meshwarp.py:59-66 on the port: sub-pixel in 2048x1024
    source pixels."""
    fov = PORT_LAYOUTS["5fold_leres"]().fovs[view]
    mx, mean = tmesh.texcoord_delta_pixels(fov, width=160)
    assert mx < 0.5 and mean < 0.1, (mx, mean)


def test_mesh_warp_with_shape_and_vertex_rays():
    """An explicit output shape, and rays near mesh vertices interpolate
    to the analytic texcoords (tests/test_meshwarp.py:22-56)."""
    fov = PORT_LAYOUTS["5fold_leres"]().fovs[7]
    m = tmesh.mesh_warp_texcoords(fov, shape=(40, 48))
    np.testing.assert_array_equal(
        m, jmesh.mesh_warp_texcoords(JAX_LAYOUTS["5fold_leres"]().fovs[7],
                                     shape=(40, 48)))
    mesh = tsphere.init_sphere(180, 90)
    a0, a1, z0, z1 = (float(v) for v in fov)
    azi = np.mod(np.arctan2(mesh.vertices[:, 1], mesh.vertices[:, 0]),
                 2 * np.pi)
    zen = np.arccos(np.clip(mesh.vertices[:, 2], -1, 1))
    lo, hi = np.mod(a0, 2 * np.pi), np.mod(a1, 2 * np.pi)
    idx = np.flatnonzero((azi > lo + 0.1) & (azi < hi - 0.1)
                         & (zen > z0 + 0.1) & (zen < z1 - 0.1))[:50]
    win = tgeometry.make_window(a0, a1, z0, z1)
    x, y = tgeometry.spherical_to_xy(win, azi[idx], zen[idx])
    m = tmesh.mesh_warp_texcoords(fov, width=256)
    a = tmesh.analytic_texcoords(fov, width=256)
    h, w = m.shape[:2]
    px = np.clip((x * w - 0.5).round().astype(int), 0, w - 1)
    py = np.clip((y * h - 0.5).round().astype(int), 0, h - 1)
    assert np.abs(m[py, px] - a[py, px]).max() < 2e-4
