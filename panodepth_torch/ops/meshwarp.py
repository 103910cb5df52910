"""Mesh-interpolated stage-A warp oracle (rasterizer equivalence), host numpy.

Counterpart of ``panodepth/ops/meshwarp.py``.  The reference's stage A
rasterizes a textured 180x90 lat-long sphere through ``gluPerspective``
(``Main.cpp:242-326``): each output pixel's texture coordinate is GL's
perspective-correct interpolation of the per-vertex equirect texcoords
(``SphereMesh.cpp:154-210``) over the chordal triangle its ray hits.  The
port's extraction (``ops/projection.extract_view``) computes the texcoord
analytically.  The window is the same on both sides (``SetWindow`` builds
its corners as ``middle +- tan(fov/2)`` along the camera axes,
``Depth.cpp:120-155``, which is ``gluPerspective``'s image rectangle), so
the only difference is the triangle interpolation: this module measures
it.  f64 math over the reference's f32 vertices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import geometry
from .projection import view_shape
from .sphere import init_sphere


def mesh_warp_texcoords(fov, width: int = 1024,
                        latitudes: int = 180, longitudes: int = 90,
                        shape: Tuple[int, int] = None,
                        chunk_rows: int = 16) -> np.ndarray:
    """Per-pixel (u, v) equirect texcoords of the rasterized view: an (h,
    w, 2) f64 array, for each pixel's centre ray the texcoord interpolated
    linearly over the mesh triangle the ray hits (GL's perspective-correct
    interpolation is linear on the 3D triangle).  ``u = azimuth/2pi``,
    ``v = zenith/pi`` at the vertices."""
    h, w = shape if shape is not None else view_shape(fov, width)
    mesh = init_sphere(latitudes, longitudes)
    verts = mesh.vertices.astype(np.float64)       # (N, 3)
    tex = mesh.texcoords.astype(np.float64)        # (N, 2)

    # (latitudes-1) zenith rows x (longitudes-1) azimuth cols of quads;
    # quad (t, p) splits into triangles (v0, v1, v2) and (v2, v3, v0)
    n_rows, n_cols = latitudes - 1, longitudes - 1

    win = geometry.make_window(float(fov[0]), float(fov[1]), float(fov[2]),
                               float(fov[3]))
    xs = (np.arange(w, dtype=np.float64) + 0.5) / w
    ys = (np.arange(h, dtype=np.float64) + 0.5) / h

    # candidate cells: the ray's own lat-long cell and the ring around it
    # (a chordal triangle's footprint can spill past its cell)
    offs = np.array([(dt, dp) for dt in (-1, 0, 1) for dp in (-1, 0, 1)])

    out = np.empty((h, w, 2), np.float64)
    for r0 in range(0, h, chunk_rows):
        r1 = min(r0 + chunk_rows, h)
        xg, yg = np.meshgrid(xs, ys[r0:r1])
        d = (win.corner0 + win.hedge * xg[..., None]
             + win.vedge * yg[..., None]).reshape(-1, 3)   # (P, 3) rays
        dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
        azi = np.mod(np.arctan2(dn[:, 1], dn[:, 0]), 2 * np.pi)
        zen = np.arccos(np.clip(dn[:, 2], -1.0, 1.0))
        ct = np.clip((zen / np.pi * n_rows).astype(np.int64), 0, n_rows - 1)
        cp = np.clip((azi / (2 * np.pi) * n_cols).astype(np.int64),
                     0, n_cols - 1)

        # (P, 9) candidate cells -> (P, 18) candidate triangles
        cand_t = np.clip(ct[:, None] + offs[None, :, 0], 0, n_rows - 1)
        cand_p = np.mod(cp[:, None] + offs[None, :, 1], n_cols)
        i0 = cand_t * longitudes + cand_p
        i1 = i0 + 1
        i2 = i0 + longitudes + 1
        i3 = i0 + longitudes
        a_idx = np.concatenate([i0, i2], axis=1)
        b_idx = np.concatenate([i1, i3], axis=1)
        c_idx = np.concatenate([i2, i0], axis=1)

        va, vb, vc = verts[a_idx], verts[b_idx], verts[c_idx]  # (P, 18, 3)
        # Moller-Trumbore from the origin
        e1 = vb - va
        e2 = vc - va
        dd = d[:, None, :]
        pvec = np.cross(dd, e2)
        det = np.einsum("ptk,ptk->pt", e1, pvec)
        inv = np.where(np.abs(det) > 1e-14, 1.0 / det, 0.0)
        tvec = -va
        u = np.einsum("ptk,ptk->pt", tvec, pvec) * inv
        qvec = np.cross(tvec, e1)
        v = np.einsum("ptk,ptk->pt", dd, qvec) * inv
        t_hit = np.einsum("ptk,ptk->pt", e2, qvec) * inv
        eps = 1e-9
        ok = ((np.abs(det) > 1e-14) & (u >= -eps) & (v >= -eps)
              & (u + v <= 1.0 + eps) & (t_hit > 0))
        if not np.all(np.any(ok, axis=1)):
            raise RuntimeError("mesh_warp: some rays missed all candidate "
                               "triangles (widen the candidate ring)")
        pick = np.argmax(ok, axis=1)
        rows = np.arange(len(pick))
        uu = u[rows, pick][:, None]
        vv = v[rows, pick][:, None]
        ta = tex[a_idx[rows, pick]]
        tb = tex[b_idx[rows, pick]]
        tc = tex[c_idx[rows, pick]]
        out[r0:r1] = ((1.0 - uu - vv) * ta + uu * tb + vv * tc
                      ).reshape(r1 - r0, w, 2)
    return out


def analytic_texcoords(fov, width: int = 1024,
                       shape: Tuple[int, int] = None) -> np.ndarray:
    """The extraction's exact texcoords: (h, w, 2) f64 (u, v)."""
    h, w = shape if shape is not None else view_shape(fov, width)
    win = geometry.make_window(float(fov[0]), float(fov[1]), float(fov[2]),
                               float(fov[3]))
    xs = (np.arange(w, dtype=np.float64) + 0.5) / w
    ys = (np.arange(h, dtype=np.float64) + 0.5) / h
    xg, yg = np.meshgrid(xs, ys)
    azi, zen = geometry.xy_to_spherical(win, xg, yg)
    return np.stack([np.mod(azi, 2 * np.pi) / (2 * np.pi), zen / np.pi],
                    axis=-1)


def texcoord_delta_pixels(fov, width: int = 1024, pano_width: int = 2048,
                          shape: Tuple[int, int] = None):
    """Tessellation error of one view in source-panorama pixels: (max_px,
    mean_px) of the texcoord distance between the mesh rasterization and
    the analytic warp, scaled by (pano_width-1, pano_height-1); u deltas
    wrap mod 1."""
    m = mesh_warp_texcoords(fov, width, shape=shape)
    a = analytic_texcoords(fov, width, shape=shape)
    du = m[..., 0] - a[..., 0]
    du = (du + 0.5) % 1.0 - 0.5       # seam-safe azimuth delta
    dv = m[..., 1] - a[..., 1]
    ph, pw = pano_width // 2, pano_width
    px = np.hypot(du * (pw - 1), dv * (ph - 1))
    return float(px.max()), float(px.mean())
