"""The merge's host geometry, in float64 numpy: views, windows, the
registration sample grid and the fusion pyramid's footprints.

A frozen, self-contained copy of the plain host code of the pipeline
(the reference's ``SaveCubeMap`` window geometry, ``Main.cpp:242-294``;
the 1-degree registration grid, ``Depth.cpp:1266-1335``; the fusion
footprints and pyramid, ``Depth.cpp:1419-1717``).  It imports nothing of
the program.  A configuration file describes its layout as data
(``layout_spec``): either the reference's five-column construction or an
explicit table of FOVs and ranges in degrees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

D2R = math.pi / 180.0
TWO_PI = 2.0 * np.pi
ZENITH_RANGE = (26.0 * D2R, 154.0 * D2R)   # Depth.cpp:22


def layout_tables(spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(fovs, ranges), each (V, 4) radians, of a ``layout_spec``:
    ``{"kind": "five_fold", "margin_deg", "zen_windows", "zen_ranges"}``
    (Main.cpp:731-844: five 72-degree columns, ranges stored reversed) or
    ``{"kind": "table", "fovs_deg", "ranges_deg"}``."""
    if spec["kind"] == "table":
        return (np.asarray(spec["fovs_deg"], np.float64) * D2R,
                np.asarray(spec["ranges_deg"], np.float64) * D2R)
    if spec["kind"] != "five_fold":
        raise ValueError(f"unknown layout kind {spec['kind']!r}")
    m = spec["margin_deg"] * D2R
    azi = [(i * 72.0 * D2R - m, (i + 1) * 72.0 * D2R + m) for i in range(5)]
    fovs, ranges = [], []
    for (z0, z1), (zz0, zz1) in zip(spec["zen_windows"], spec["zen_ranges"]):
        for a0, a1 in azi:
            fovs.append((a0, a1, z0 * D2R, z1 * D2R))
            ranges.append((a1 - m, a0 + m, zz0 * D2R, zz1 * D2R))
    return np.array(fovs, np.float64), np.array(ranges, np.float64)


def cround(v: float) -> int:
    """C ``round``: half away from zero."""
    return int(np.floor(v + 0.5)) if v >= 0 else int(np.ceil(v - 0.5))


def schedule(out_width: int) -> Tuple[int, ...]:
    """Jacobi iterations per level, coarse to fine (Depth.cpp:1654-1675)."""
    return (200, 150, 100, 50) if out_width >= 4096 else (200, 100, 50)


# -- windows (Depth.cpp:168-207, 2955-2971) --------------------------------

def to_world(azimuth, zenith):
    sz = np.sin(zenith)
    return np.stack([sz * np.cos(azimuth), sz * np.sin(azimuth),
                     np.cos(zenith)], -1)


def to_spherical(p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.arctan2(y, x) % TWO_PI, np.arctan2(np.sqrt(x * x + y * y), z)


@dataclasses.dataclass(frozen=True)
class Window:
    middle: np.ndarray
    corner0: np.ndarray
    hedge: np.ndarray
    vedge: np.ndarray


def window(fov) -> Window:
    """The tangent-plane window of one FOV (a0, a1, z0, z1)."""
    a0, a1, z0, z1 = (float(v) for v in fov)
    middle = to_world((a0 + a1) / 2.0, (z0 + z1) / 2.0)
    up = np.array([0.0, 0.0, 1.0])
    left = np.cross(up, middle)
    left = left / np.linalg.norm(left)
    updir = np.cross(left, middle)
    updir = updir / np.linalg.norm(updir)
    th = math.tan(abs(a1 - a0) / 2.0)
    tv = math.tan(abs(z0 - z1) / 2.0)
    lm, rm = middle + left * th, middle - left * th
    um, dm = middle - updir * tv, middle + updir * tv
    return Window(middle, lm + um - middle, rm - lm, dm - um)


def sph_to_xy(win: Window, azimuth, zenith):
    """Inverse gnomonic map: (x, y) on the window, unclamped."""
    d = to_world(azimuth, zenith)
    t = (win.middle @ win.middle) / (d @ win.middle)
    e = d * t[..., None] - win.corner0
    return (e @ win.hedge / (win.hedge @ win.hedge),
            e @ win.vedge / (win.vedge @ win.vedge))


def xy_to_sph(win: Window, x, y):
    pos = win.corner0 + win.hedge * x[..., None] + win.vedge * y[..., None]
    return to_spherical(pos)


def view_shape(fov, width: int) -> Tuple[int, int]:
    """(h, w) of a view rendered ``width`` wide (Main.cpp:250-272)."""
    a0, a1, z0, z1 = (float(v) for v in fov)
    aspect = math.tan(abs(a1 - a0) / 2.0) / math.tan(abs(z1 - z0) / 2.0)
    return int(round(width / aspect)), width


def view_rays(fov, shape):
    """(azimuth, zenith) of the rays through a view's pixel centres."""
    h, w = shape
    xs = (np.arange(w) + 0.5) / w
    ys = (np.arange(h) + 0.5) / h
    yg, xg = np.meshgrid(ys, xs, indexing="ij")
    return xy_to_sph(window(fov), xg, yg)


# -- registration's sample grid (Depth.cpp:1266-1335) ----------------------

def clamped_ranges(ranges: np.ndarray) -> np.ndarray:
    """Ranges with azimuths clamped to 359.9 degrees (Depth.cpp:783-786)."""
    r = ranges.copy()
    r[:, :2] = np.minimum(r[:, :2], 359.9 * D2R)
    return r


def sample_grid(fov, rng, step=D2R, zenith_range=ZENITH_RANGE):
    """One view's 1-degree grid: (x, y) on the view clamped to [0, 1], and
    the (azimuth, zenith) of each sample, each (rows+1, cols+1)."""
    r0, r1, rz0, rz1 = rng
    cols = int(round(abs(r1 - r0) / step))
    zt, zd = max(zenith_range[0], rz0), min(zenith_range[1], rz1)
    rows = int(round(abs(zd - zt) / step))
    azi = r0 + (r1 - r0) * np.arange(cols + 1) / cols
    zen = zt + (zd - zt) * np.arange(rows + 1) / rows
    ag, zg = np.meshgrid(azi, zen)
    x, y = sph_to_xy(window(fov), ag, zg)
    return np.clip(x, 0, 1), np.clip(y, 0, 1), ag, zg


# -- the fusion pyramid (Depth.cpp:1419-1717) ------------------------------

@dataclasses.dataclass(frozen=True)
class Level:
    width: int
    height: int
    band: Tuple[int, int]       # rows kept at level 0: [height0, height1]
    iterations: int
    bboxes: tuple               # per view (x_lo, x_hi, y_lo, y_hi) inclusive
    inv_cov: np.ndarray         # 1 / number of covering views, 0 uncovered


def bbox(rng, width, height, height0, height1):
    """A view's inclusive footprint: the x walk excludes x1 and turns back
    on a reversed range, rows clamp strictly inside the zenith band."""
    r0, r1, rz0, rz1 = rng
    x0 = cround(r0 / TWO_PI * (width - 1))
    x1 = cround(r1 / TWO_PI * (width - 1))
    y0 = cround(rz0 / np.pi * (height - 1))
    y1 = cround(rz1 / np.pi * (height - 1))
    xs = 1 if x1 >= x0 else -1
    x0, x1 = min(max(x0, 0), width - 1), min(max(x1, 0), width - 1)
    y0, y1 = max(y0, height0 + 1), min(y1, height1 - 1)
    lo_hi = (x0, x1 - 1) if xs == 1 else (x1 + 1, x0)
    return lo_hi[0], lo_hi[1], y0, y1


def pyramid(ranges: np.ndarray, out_width: int,
            zenith_range=ZENITH_RANGE) -> Tuple[Level, ...]:
    sched = schedule(out_width)
    n = len(sched)
    levels = []
    for i, iters in enumerate(sched):
        w = out_width // 2 ** (n - 1 - i)
        h = w // 2
        h0 = int(np.floor(h * zenith_range[0] / np.pi))
        h1 = int(np.ceil(h * zenith_range[1] / np.pi))
        boxes = tuple(bbox(r, w, h, h0, h1) for r in clamped_ranges(ranges))
        cov = np.zeros((h, w), np.int64)
        for x_lo, x_hi, y_lo, y_hi in boxes:
            if y_lo <= y_hi:
                cov[y_lo:y_hi + 1, x_lo:x_hi + 1] += 1
        inv = np.where(cov > 0, 1.0 / np.maximum(cov, 1), 0.0)
        levels.append(Level(w, h, (h0, h1), iters, boxes,
                            inv.astype(np.float32)))
    return tuple(levels)


def slab_indices(fov, box, width, height, pmap_shape):
    """Flat nearest indices into a (ph, pw) view map of its footprint
    extended by one ring (the stencil's neighbours), (y, x) at the
    reference's ``xx / (width - 1) * 2 pi`` azimuths."""
    x_lo, x_hi, y_lo, y_hi = box
    ph, pw = pmap_shape
    azi = np.arange(x_lo - 1, x_hi + 2) / (width - 1) * TWO_PI
    zen = np.arange(y_lo - 1, y_hi + 2) / (height - 1) * np.pi
    ag, zg = np.meshgrid(azi, zen)
    x, y = sph_to_xy(window(fov), ag, zg)
    px = np.clip((np.clip(x, 0, 1) * (pw - 1)).astype(np.int64), 0, pw - 1)
    py = np.clip((np.clip(y, 0, 1) * (ph - 1)).astype(np.int64), 0, ph - 1)
    return py * pw + px


def level0_indices(width, height, emap_shape):
    """Flat nearest indices of the baseline map at level 0's pixels."""
    he, we = emap_shape
    x = np.arange(width) / (width - 1) * TWO_PI
    y = np.arange(height) / (height - 1) * np.pi
    xi = np.clip((x / TWO_PI * (we - 1)).astype(np.int64), 0, we - 1)
    yi = np.clip((y / np.pi * (he - 1)).astype(np.int64), 0, he - 1)
    return yi[:, None] * we + xi[None, :]
