"""Lat-long sphere mesh (LiteMesh::InitSphere parity), host numpy.

Counterpart of ``panodepth/ops/sphere.py``.  The reference rasterizes a
textured 180x90 lat-long quad sphere through GL (``SphereMesh.cpp:
154-210``, drawn at ``SphereMesh.cpp:48``).  The port maps rays
analytically instead (``ops/projection.py``), so the mesh is off the
path: it serves geometry parity and debugging, such as the tessellation
error of the rasterized warp (``ops/meshwarp.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SphereMesh(NamedTuple):
    vertices: np.ndarray    # (N, 3) unit sphere positions, f32
    texcoords: np.ndarray   # (N, 2) equirect texture coords in [0, 1], f32
    faces: np.ndarray       # (F, 4) quad vertex indices
    triangles: np.ndarray   # (T, 3) triangulated indices (CreateArrays split)


def init_sphere(latitudes: int = 180, longitudes: int = 90) -> SphereMesh:
    """The reference's lat-long quad sphere (SphereMesh.cpp:154-210).

    Vertex (t, p): azimuth = p/(longitudes-1)*2pi, zenith =
    t/(latitudes-1)*pi (both ends included), position z-up, texcoord (p,
    t) normalized.  Each quad (a, b, c, d) splits into triangles (a, b, c)
    and (c, d, a), as CreateArrays does (SphereMesh.cpp:130-152).
    """
    t = np.arange(latitudes, dtype=np.float64)
    p = np.arange(longitudes, dtype=np.float64)
    azimuth = p / (longitudes - 1) * (2 * np.pi)
    zenith = t / (latitudes - 1) * np.pi
    ag, zg = np.meshgrid(azimuth, zenith)  # (lat, lon)
    verts = np.stack(
        [np.sin(zg) * np.cos(ag), np.sin(zg) * np.sin(ag), np.cos(zg)],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    u, v = np.meshgrid(p / (longitudes - 1), t / (latitudes - 1))
    tex = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)

    tt, pp = np.meshgrid(np.arange(latitudes - 1), np.arange(longitudes - 1),
                         indexing="ij")
    i0 = (tt * longitudes + pp).ravel()
    i1 = (tt * longitudes + pp + 1).ravel()
    i2 = ((tt + 1) * longitudes + pp + 1).ravel()
    i3 = ((tt + 1) * longitudes + pp).ravel()
    faces = np.stack([i0, i1, i2, i3], axis=-1).astype(np.int32)
    tris = np.concatenate([faces[:, [0, 1, 2]], faces[:, [2, 3, 0]]],
                          axis=0).astype(np.int32)
    return SphereMesh(verts, tex, faces, tris)
