"""Spherical / gnomonic projection geometry, as pure array math.

Counterpart of ``panodepth/geometry.py``:

* ``spherical_to_world`` / ``world_to_spherical`` — reference
  ``Depth.cpp:2955-2971`` (z-up, zenith measured from the north pole).
* ``Window`` + ``make_window`` — the tangent-plane viewing window of
  ``PerspectiveMap::SetWindow`` (reference ``Depth.cpp:120-155``).
* ``spherical_to_xy`` — the inverse gnomonic map ray -> (x, y) in [0, 1]^2 on
  the window plane (``PerspectiveMap::SphericalTo2D``, ``Depth.cpp:168-182``).
* ``xy_to_spherical`` — forward map (``PerspectiveMap::ToSphericalCoord``,
  ``Depth.cpp:157-166``).
* ``contains`` / ``window_coords`` — the window's ray test
  (``Depth.cpp:184-207``) and its corner coords (``WindowCoords``,
  ``Depth.cpp:2973-3039``).

Every function takes an array module ``xp``: ``numpy`` (the default) for the
float64 host precompute the gather tables are built from, or ``torch`` for
tensors on a device.  Only operations both modules spell alike are used.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

TWO_PI = 2.0 * np.pi


def spherical_to_world(azimuth, zenith, xp=np):
    """(azi, zen) -> unit vector with a trailing axis of 3 (Depth.cpp:2955-2958)."""
    sz = xp.sin(zenith)
    return xp.stack([sz * xp.cos(azimuth), sz * xp.sin(azimuth), xp.cos(zenith)], -1)


def world_to_spherical(p, xp=np):
    """Vector -> (azimuth in [0, 2pi), zenith in [0, pi]) (Depth.cpp:2960-2971)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    azimuth = xp.arctan2(y, x) % TWO_PI
    zenith = xp.arctan2(xp.sqrt(x * x + y * y), z)
    return azimuth, zenith


class Window(NamedTuple):
    """Tangent-plane viewing window; each field has shape (..., 3)."""

    middle: np.ndarray
    corner0: np.ndarray
    hedge: np.ndarray
    vedge: np.ndarray


def _cross(a, b, xp):
    """Cross product over the last axis, written out as np.cross computes it."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return xp.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v, xp):
    return v / xp.sqrt(_dot(v, v))[..., None]


def make_window(azimuth_left, azimuth_right, zenith_top, zenith_down, xp=np):
    """Build the tangent-plane window for a viewing FOV (broadcastable)."""
    azimuth_left = xp.asarray(azimuth_left)
    middle = spherical_to_world(
        (azimuth_left + azimuth_right) / 2.0, (zenith_top + zenith_down) / 2.0, xp
    )
    up = xp.zeros_like(middle)  # +z, on middle's device when xp is torch
    up[..., 2] = 1.0
    left_dir = _normalize(_cross(up, middle, xp), xp)
    up_dir = _normalize(_cross(left_dir, middle, xp), xp)

    th = xp.tan(xp.abs(azimuth_right - azimuth_left) / 2.0)[..., None]
    tv = xp.tan(xp.abs(zenith_top - zenith_down) / 2.0)[..., None]
    left_middle = middle + left_dir * th
    right_middle = middle - left_dir * th
    up_middle = middle - up_dir * tv
    down_middle = middle + up_dir * tv

    corner0 = left_middle + up_middle - middle
    hedge = right_middle - left_middle
    vedge = down_middle - up_middle
    return Window(middle=middle, corner0=corner0, hedge=hedge, vedge=vedge)


def spherical_to_xy(window: Window, azimuth, zenith, xp=np):
    """Inverse gnomonic: spherical coord -> (x, y) on the window, unclamped.

    The ray along (azi, zen) meets the window plane (point = normal =
    ``middle``) and is decomposed on ``hedge``/``vedge`` (Depth.cpp:168-182
    with LinePlaneIntersection, Depth.cpp:34-42).
    """
    d = spherical_to_world(azimuth, zenith, xp)
    t = _dot(window.middle, window.middle) / _dot(d, window.middle)
    pos = d * t[..., None]
    e = pos - window.corner0
    x = _dot(e, window.hedge) / _dot(window.hedge, window.hedge)
    y = _dot(e, window.vedge) / _dot(window.vedge, window.vedge)
    return x, y


def xy_to_spherical(window: Window, x, y, xp=np):
    """Forward map: (x, y) in [0,1]^2 on the window -> (azimuth, zenith)."""
    pos = window.corner0 + window.hedge * xp.asarray(x)[..., None] \
        + window.vedge * xp.asarray(y)[..., None]
    return world_to_spherical(pos, xp)


def contains(window: Window, azimuth, zenith, threshold=1e-3, xp=np):
    """Whether rays fall inside the window (reference Depth.cpp:184-207)."""
    x, y = spherical_to_xy(window, azimuth, zenith, xp)
    return ((x >= -threshold) & (x <= 1 + threshold)
            & (y >= -threshold) & (y <= 1 + threshold))


def window_coords(middle_coord, azi_half, zen_half):
    """Spherical coords of a window's 4 corners (left-up, left-down,
    right-down, right-up), each an (azimuth, zenith) pair, from its centre
    (azi, zen) and half-FOVs: the debug utility WindowCoords
    (Depth.cpp:2973-3039) without its prints.  Host float64."""
    a0 = middle_coord[0] - azi_half
    a1 = middle_coord[0] + azi_half
    z0 = middle_coord[1] - zen_half
    z1 = middle_coord[1] + zen_half
    win = make_window(a0, a1, z0, z1)
    c0 = win.corner0
    c1 = win.corner0 + win.vedge
    c2 = win.corner0 + win.hedge + win.vedge
    c3 = win.corner0 + win.hedge
    return tuple(world_to_spherical(np.asarray(c)) for c in (c0, c1, c2, c3))


def window_at(windows: Window, v: int) -> Window:
    """One view's window out of a stacked :class:`Window`."""
    return Window(*(a[v] for a in windows))


def layout_windows(fovs: np.ndarray) -> Window:
    """Stack of windows for an (N, 4) FOV table, computed in float64."""
    f = np.asarray(fovs, np.float64)
    return make_window(f[:, 0], f[:, 1], f[:, 2], f[:, 3], xp=np)
