"""Stage A: equirectangular RGB -> perspective view extraction.

Counterpart of ``panodepth/ops/projection.py`` (``view_shape``,
``extract_view``, ``extract_views``, and off the path ``elevated_zenith``,
``extract_view_elevated``, ``depth_view_to_equirect``).  The reference renders a textured
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
from .sampling import (_bilinear_coords, bilinear_taps, pack_rgb565_pair_u32,
                       pack_rgb565_u16, pack_rgb_u32, packed565_taps,
                       packed565pair_taps, packed_taps,
                       sample_equirect_bilinear, sample_unit_nearest)

# --extract-dtype's tables: (pack (..., H, W, 3) -> table, blend of taps);
# None keeps the image, and the image's own dtype (f32 or bf16) is sampled
TABLES = {
    "f32": (None, bilinear_taps),
    "bf16": (None, bilinear_taps),
    "packed": (pack_rgb_u32, packed_taps),
    "packed16": (pack_rgb565_u16, packed565_taps),
    "pair16": (pack_rgb565_pair_u32, packed565pair_taps),
    "pair16d": (lambda rgb: pack_rgb565_pair_u32(rgb, dither=True),
                packed565pair_taps),
}
# the tables packed from the RGB, (..., H, W) words or codes
PACKED = tuple(k for k, (pack, _) in TABLES.items() if pack is not None)


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


def _view_angles(fovs, shape: Tuple[int, int], device: torch.device):
    """(azimuth, zenith), each (V, h, w) f32, of the rays through the pixel
    centres ((i+0.5)/w on the window, GL's sample positions) of views with
    the FOVs ``fovs`` (V, 4) and output ``shape``."""
    f = torch.tensor(fovs, dtype=torch.float32, device=device)
    win = geometry.make_window(f[:, 0], f[:, 1], f[:, 2], f[:, 3], xp=torch)
    win = geometry.Window(*(a[:, None, None, :] for a in win))
    h, w = shape
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return geometry.xy_to_spherical(win, xg, yg, xp=torch)


@graphs.device_cache(maxsize=64)
def _taps(fovs: Tuple[Tuple[float, ...], ...], shape: Tuple[int, int],
          pano_hw: Tuple[int, int], device: torch.device):
    """Bilinear taps of views with the FOVs ``fovs`` and output ``shape``
    over a panorama of ``pano_hw``: index and weight tensors shaped
    (V, h, w) and (V, h, w, 1)."""
    azi, zen = _view_angles(fovs, shape, device)
    return _bilinear_coords(pano_hw[0], pano_hw[1], azi, zen)


def make_table(rgb, table: str = "f32"):
    """The gather table ``table`` (a key of ``TABLES``) of ``rgb`` (..., H,
    W, 3): uint8 or f32 0~1 for the packed tables (packed straight from
    uint8, as the JAX package does for a streamed panorama), f32 0~1 for
    ``f32`` and ``bf16``."""
    pack, _ = TABLES[table]
    if pack is not None:
        return pack(rgb)
    return rgb.to(torch.bfloat16) if table == "bf16" else rgb


def extract_group(src, fovs, shape, table: str = "f32"):
    """Views of one output ``shape``, (..., V, h, w, C) f32, for the (V, 4)
    FOV table ``fovs``, from ``src``: the image (..., H, W, C) for ``f32``
    and ``bf16``, else the :func:`make_table` table (..., H, W)."""
    _, blend = TABLES[table]
    key = tuple(tuple(float(v) for v in row) for row in np.asarray(fovs))
    hw = src.shape[-2:] if table in PACKED else src.shape[-3:-1]
    taps = _taps(key, tuple(shape), tuple(hw), src.device)
    return blend(src, taps)


def extract_view(rgb, fov, width: int = 1024, shape: Tuple[int, int] = None,
                 table: str = "f32"):
    """One perspective view from an equirect image (H, W[, C]) -> (h, w[,
    C]); with ``table`` other than ``f32`` the view is sampled from that
    gather table of the RGB image (H, W, 3), JAX's ``sampler=``."""
    shape = shape if shape is not None else view_shape(fov, width)
    squeeze = rgb.dim() == 2
    img = rgb[..., None] if squeeze else rgb
    out = extract_group(make_table(img, table), np.asarray(fov)[None],
                        shape, table)[0]
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


def elevated_zenith(zenith, camera_height: float = 0.3,
                    fovy: float = math.radians(45)):
    """The camera-height zenith remap of ``shaders/fs_perspective_elevated
    .txt`` (:29-38): zeniths seen by a camera raised by ``camera_height``
    on the unit sphere, as seen from its centre (r = 1 - h, b = r
    cos(fovy), the ray height b tan(pi/2 - zen) shifted by the camera
    height).  f32 tensors; the constants rounded to f32 as in JAX."""
    r = 1.0 - camera_height
    b = r * math.cos(fovy)
    h = b * torch.tan(np.pi / 2 - zenith)
    return np.pi / 2 - torch.atan2(camera_height + h, torch.full_like(h, b))


def extract_view_elevated(rgb, fov, width: int = 1024,
                          camera_height: float = 0.3,
                          fovy: float = math.radians(45)):
    """A perspective view from an elevated camera (the unused
    fs_perspective_elevated shader): every ray's zenith goes through
    :func:`elevated_zenith` before the bilinear sampling."""
    shape = view_shape(fov, width)
    azi, zen = _view_angles([[float(v) for v in fov]], shape, rgb.device)
    return sample_equirect_bilinear(
        rgb, azi[0], elevated_zenith(zen[0], camera_height, fovy))


def depth_view_to_equirect(depth_view, fov, out_width: int, out_height: int):
    """The inverse direction: a perspective depth map (h, w[, C]) gathered
    nearest onto the (out_height, out_width) equirect grid, zero outside
    the view.  Returns (map, inside mask).  The window and the pixel
    coords in f32 on the map's device, as in JAX (debugging and
    visualization; fusion uses ``fusion.resample_view``)."""
    dev = depth_view.device
    f = torch.tensor([float(v) for v in fov], dtype=torch.float32,
                     device=dev)
    win = geometry.make_window(f[0], f[1], f[2], f[3], xp=torch)
    xg = torch.arange(out_width, dtype=torch.float32, device=dev)
    yg = torch.arange(out_height, dtype=torch.float32, device=dev)
    azi = (xg / (out_width - 1) * (2 * np.pi)).expand(out_height, out_width)
    zen = (yg / (out_height - 1) * np.pi)[:, None].expand(out_height,
                                                          out_width)
    x, y = geometry.spherical_to_xy(win, azi, zen, xp=torch)
    inside = (x >= 0) & (x <= 1) & (y >= 0) & (y <= 1)
    vals = sample_unit_nearest(depth_view, x, y)
    return torch.where(inside, vals, torch.zeros_like(vals)), inside
