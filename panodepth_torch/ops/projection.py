"""Stage A: equirectangular RGB -> perspective view extraction.

Counterpart of ``panodepth/ops/projection.py`` (``view_shape``,
``extract_view``, ``extract_views``).  The reference renders a textured
sphere mesh per view through GL and reads the framebuffer back
(``Main.cpp:242-326``); here each output pixel's ray is computed
analytically on the view's tangent-plane window and the equirect texture
is sampled bilinearly, with the window geometry of SaveCubeMap
(``Main.cpp:242-294``: fovy = zenith span, aspect = tan(fovx/2)/tan(fovy/2),
height = round(width / aspect)).

The ray angles are computed in f32 on the device from the f32-rounded FOVs,
as the JAX package does; the tap tables depend only on the layout, the view
width and the panorama's shape, so they are built once per device and
cached.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .. import geometry, graphs
from ..config import ViewLayout
from .sampling import _bilinear_coords, bilinear_taps


def view_shape(fov, width: int = 1024) -> Tuple[int, int]:
    """(height, width) of a view's output image (Main.cpp:250-272)."""
    a0, a1, z0, z1 = (float(v) for v in fov)
    fovx = abs(a1 - a0)
    fovy = abs(z1 - z0)
    if fovx >= math.pi or fovy >= math.pi:
        raise ValueError(
            f"perspective window FOV must be < 180 deg, got "
            f"({math.degrees(fovx):.1f}, {math.degrees(fovy):.1f})")
    aspect = math.tan(fovx / 2.0) / math.tan(fovy / 2.0)
    return int(round(width / aspect)), width


@graphs.device_cache(maxsize=64)
def _taps(fovs: Tuple[Tuple[float, ...], ...], shape: Tuple[int, int],
          pano_hw: Tuple[int, int], device: torch.device):
    """Bilinear taps of views with the FOVs ``fovs`` and output ``shape``
    over a panorama of ``pano_hw``: index and weight tensors shaped
    (V, h, w) and (V, h, w, 1).  Rays go through pixel centres
    ((i+0.5)/w on the window), GL's sample positions."""
    f = torch.tensor(fovs, dtype=torch.float32, device=device)
    win = geometry.make_window(f[:, 0], f[:, 1], f[:, 2], f[:, 3], xp=torch)
    win = geometry.Window(*(a[:, None, None, :] for a in win))
    h, w = shape
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    azi, zen = geometry.xy_to_spherical(win, xg, yg, xp=torch)
    return _bilinear_coords(pano_hw[0], pano_hw[1], azi, zen)


def extract_group(rgb, fovs, shape):
    """Views of one output ``shape`` from ``rgb`` (..., H, W, C): returns
    (..., V, h, w, C) for the (V, 4) FOV table ``fovs``."""
    key = tuple(tuple(float(v) for v in row) for row in np.asarray(fovs))
    taps = _taps(key, tuple(shape), tuple(rgb.shape[-3:-1]), rgb.device)
    return bilinear_taps(rgb, taps)


def extract_view(rgb, fov, width: int = 1024, shape: Tuple[int, int] = None):
    """One perspective view from an equirect image (H, W[, C]) -> (h, w[, C])."""
    shape = shape if shape is not None else view_shape(fov, width)
    squeeze = rgb.dim() == 2
    img = rgb[..., None] if squeeze else rgb
    out = extract_group(img, np.asarray(fov)[None], shape)[0]
    return out[..., 0] if squeeze else out


def view_groups(layout: ViewLayout, width: int):
    """{(h, w): [view indices]} of a layout's views at ``width``, in view
    order (same-shaped views are extracted and inferred together)."""
    groups = {}
    for i in range(layout.num_views):
        groups.setdefault(view_shape(layout.fovs[i], width), []).append(i)
    return groups


def extract_views(rgb, layout: ViewLayout, width: int = 1024) -> List[torch.Tensor]:
    """All views of a layout; same-shaped views are gathered together."""
    out: List[torch.Tensor] = [None] * layout.num_views  # type: ignore
    for shape, idxs in view_groups(layout, width).items():
        views = extract_group(rgb, layout.fovs[idxs], shape)
        for j, i in enumerate(idxs):
            out[i] = views[j]
    return out
