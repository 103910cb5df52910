"""Multiresolution Laplacian (gradient-domain) fusion.

Counterpart of the main-path part of ``panodepth/fusion.py``.  The
reference's ``SolveDepthAll`` (Depth.cpp:1416-1771) builds a per-pixel
Laplacian window per pyramid level from every view's bounding box and
relaxes the buffer toward it.  Because every view contributes the same
5-point stencil, that is exactly

    target(p)  = mean over covering views v of  lap4(V_v)(p)
    update(p)  = B(p) + (target(p) - lap4(B)(p)) * step     (covered p only)

with ``V_v`` view v's depth resampled onto the equirect grid by the inverse
gnomonic map.  Pixels no view covers keep their value.

The geometry is static per (config, shapes): bounding boxes, coverage and
every nearest-pixel gather index are built on the host in float64 (f32
index arithmetic would flip pixel boundaries) and cached as index tensors
on the device.  At run time each view is one flat gather into its bbox
slab, the cubic remap, a local stencil and an add; the relaxation is the
Jacobi of ``kernels/jacobi.py``, the CUDA kernel on the card.

Reference quirks kept: C ``round`` for bbox endpoints (Depth.cpp:1498-1501);
the x walk excludes x1 (Depth.cpp:1566-1623); rows clamped strictly inside
the zenith band (Depth.cpp:1558-1562); level-0 rows outside the band zeroed
(Depth.cpp:1444-1464); schedule 200/100/50 (200/150/100/50 at >= 4096),
step 0.5, reg 1e-4, clamp [0, 1] (Depth.cpp:1649-1717); C-cast
quantization ``(ushort)(v * 65535)`` (Depth.cpp:1734); the flat-index seam
wrap of the stencil taps (PARITY.md quirk #19).

Off the main path, as in the JAX package: ``lap4`` (the plain periodic
stencil), ``resample_view`` (a view's depth on the full equirect grid)
and ``solve_depth_by_smoothing`` (the reference's disabled alternative
fusion, Depth.cpp:1773-1878).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from . import geometry, graphs
from .config import MergeConfig, _cround
from .kernels.jacobi import jacobi_plain as jacobi
from .kernels.jacobi import lap4_refwrap
from .ops.sampling import as01_post, sample_unit_nearest
from .registration import apply_cubic

TWO_PI = 2.0 * np.pi

__all__ = ["view_bbox", "LevelPlan", "FusionPlan", "build_fusion_plan",
           "lap4", "lap4_refwrap", "resample_view", "level_target",
           "init_level0", "upsample2x", "jacobi", "fuse", "fuse_batched",
           "solve_depth_by_smoothing"]


def view_bbox(rng, width, height, height0, height1) -> Tuple[int, int, int, int]:
    """Inclusive (x_lo, x_hi, y_lo, y_hi) of one view's fusion footprint.

    Reproduces the reference's walk (x1 excluded, rows clamped strictly
    inside the zenith band).  Empty footprints return y_lo > y_hi.
    """
    r0, r1, rz0, rz1 = rng
    x0 = _cround(r0 / TWO_PI * (width - 1))
    x1 = _cround(r1 / TWO_PI * (width - 1))
    y0 = _cround(rz0 / np.pi * (height - 1))
    y1 = _cround(rz1 / np.pi * (height - 1))
    xs = 1 if x1 >= x0 else -1
    # clamp into the image (reference Depth.cpp:1524-1556 with enlarge=0)
    x0 = min(max(x0, 0), width - 1)
    x1 = min(max(x1, 0), width - 1)
    y0 = max(y0, height0 + 1)
    y1 = min(y1, height1 - 1)
    if x0 == x1:  # unreachable for MergeConfig-validated layouts
        raise ValueError(
            "degenerate azimuth footprint (single pixel column; the "
            "reference's bbox walk would loop forever) — "
            "config.validate_layout should have rejected this layout")
    # the x walk covers [x0, x1) in steps of xs
    x_lo, x_hi = (x0, x1 - 1) if xs == 1 else (x1 + 1, x0)
    return x_lo, x_hi, y0, y1


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    width: int
    height: int
    height0: int
    height1: int
    iterations: int
    bboxes: Tuple[Tuple[int, int, int, int], ...]  # per view, inclusive
    inv_cov: np.ndarray   # (H, W) f32: 1/#covering views (0 where uncovered)


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Host-precomputed static data for the whole pyramid."""

    cfg: MergeConfig
    levels: Tuple[LevelPlan, ...]
    windows: geometry.Window   # the views' windows, f32 (JAX's ``win32``)


@functools.lru_cache(maxsize=8)
def build_fusion_plan(cfg: MergeConfig) -> FusionPlan:
    ranges = cfg.clamped_ranges()
    schedule = cfg.schedule
    n_levels = len(schedule)
    zr0, zr1 = cfg.zenith_range

    levels: List[LevelPlan] = []
    for level in range(n_levels):
        width = cfg.out_width // (2 ** (n_levels - 1 - level))
        height = cfg.out_height // (2 ** (n_levels - 1 - level))
        height0 = int(np.floor(height * zr0 / np.pi))
        height1 = int(np.ceil(height * zr1 / np.pi))
        bboxes = tuple(
            view_bbox(ranges[v], width, height, height0, height1)
            for v in range(ranges.shape[0])
        )
        cov = np.zeros((height, width), np.int32)
        for x_lo, x_hi, y_lo, y_hi in bboxes:
            if y_lo <= y_hi:
                cov[y_lo : y_hi + 1, x_lo : x_hi + 1] += 1
        inv_cov = np.where(cov > 0, 1.0 / np.maximum(cov, 1), 0.0).astype(np.float32)
        levels.append(LevelPlan(width, height, height0, height1,
                                schedule[level], bboxes, inv_cov))
    win = geometry.layout_windows(cfg.layout.fovs)
    win32 = geometry.Window(*(np.asarray(a, np.float32) for a in win))
    return FusionPlan(cfg=cfg, levels=tuple(levels), windows=win32)


def _pixel_coords(width: int, height: int, device=None):
    """Spherical coords of every equirect pixel (Depth.cpp:1591), in f32 on
    ``device`` as the JAX package computes them (an f32 iota)."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    azi = (x / (width - 1) * TWO_PI).expand(height, width)
    zen = (y / (height - 1) * np.pi)[:, None].expand(height, width)
    return azi, zen


def lap4(img):
    """5-point Laplacian: centre - 0.25*(left+right+up+down), x and y
    wrapping periodically (not the reference's flat-index seam, for which
    see :func:`lap4_refwrap`)."""
    return img - 0.25 * (
        torch.roll(img, 1, 1) + torch.roll(img, -1, 1)
        + torch.roll(img, 1, 0) + torch.roll(img, -1, 0))


def resample_view(pmap, window: geometry.Window, width: int, height: int):
    """A view's depth ``pmap`` (Hp, Wp[, C]) resampled nearest (like the
    reference) onto the full (height, width) equirect grid through its
    ``window``: f32 window coords on the pmap's device, as in JAX."""
    dev = pmap.device
    win = geometry.Window(*(torch.as_tensor(np.asarray(a, np.float32),
                                            device=dev) for a in window))
    azi, zen = _pixel_coords(width, height, dev)
    x, y = geometry.spherical_to_xy(win, azi, zen, xp=torch)
    return sample_unit_nearest(pmap, x, y)


@functools.lru_cache(maxsize=64)
def _view_gather_indices(cfg: MergeConfig, lvl_idx: int, view: int,
                         pmap_shape: Tuple[int, int]):
    """Flat pmap gather indices (i32) of one view's bbox+ring slab at a level.

    The equirect-pixel -> gnomonic -> pmap-pixel chain is static, so it is
    computed here in float64.  The slab extends the bbox by one ring so the
    5-point target Laplacian of the interior is exact.  Ring columns may be
    -1 or w: the reference computes their azimuth as xx/(width-1)*2pi
    (Depth.cpp:1591), periodic in the trig but not the mod-w column's
    azimuth, so they stay raw.
    """
    plan = build_fusion_plan(cfg)
    lvl = plan.levels[lvl_idx]
    x_lo, x_hi, y_lo, y_hi = lvl.bboxes[view]
    if y_lo > y_hi:
        return None
    w, h = lvl.width, lvl.height
    ph, pw = pmap_shape
    xs = np.arange(x_lo - 1, x_hi + 2, dtype=np.int64)
    ys = np.arange(y_lo - 1, y_hi + 2, dtype=np.int64)  # rows never clip
    azi = xs.astype(np.float64) / (w - 1) * TWO_PI
    zen = ys.astype(np.float64) / (h - 1) * np.pi
    ag, zg = np.meshgrid(azi, zen)
    win = geometry.window_at(geometry.layout_windows(cfg.layout.fovs), view)
    x, y = geometry.spherical_to_xy(win, ag, zg)
    pxi = np.clip((np.clip(x, 0, 1) * (pw - 1)).astype(np.int64), 0, pw - 1)
    pyi = np.clip((np.clip(y, 0, 1) * (ph - 1)).astype(np.int64), 0, ph - 1)
    return (pyi * pw + pxi).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _level0_gather_indices(cfg: MergeConfig, emap_shape: Tuple[int, int]):
    """Flat indices (i32) of the level-0 baseline resample (f64 host)."""
    lvl = build_fusion_plan(cfg).levels[0]
    he, we = emap_shape
    x = np.arange(lvl.width, dtype=np.float64) / (lvl.width - 1) * TWO_PI
    y = np.arange(lvl.height, dtype=np.float64) / (lvl.height - 1) * np.pi
    xi = np.clip((x / TWO_PI * (we - 1)).astype(np.int64), 0, we - 1)
    yi = np.clip((y / np.pi * (he - 1)).astype(np.int64), 0, he - 1)
    return (yi[:, None] * we + xi[None, :]).astype(np.int32)


@graphs.device_cache(maxsize=256)
def _on_device(fn, *key_and_device):
    """``fn(*key)`` as an int64 tensor on the device (None stays None)."""
    *key, device = key_and_device
    idx = fn(*key)
    return None if idx is None else \
        torch.from_numpy(idx.astype(np.int64)).to(device)


@graphs.device_cache(maxsize=16)
def _inv_cov(cfg: MergeConfig, lvl_idx: int, device: torch.device):
    return torch.from_numpy(build_fusion_plan(cfg).levels[lvl_idx].inv_cov
                            ).to(device)


def level_target(pmaps, plan: FusionPlan, lvl_idx: int, abcd=None):
    """Mean target-Laplacian images + covered mask for one pyramid level,
    for a batch of panoramas.

    Equivalent to the reference's mask build and renormalization
    (Depth.cpp:1487-1647): per view, the target at a covered pixel is the
    4-neighbor Laplacian of the view's reprojected depth; overlaps average.
    ``pmaps`` is a (B, V, Hp, Wp) tensor or a list of V per-view (B, h, w)
    stacks.  With ``abcd`` (B, V, 4), each view's cubic remap is applied to
    its gathered slab (remap and gather commute; slabs are smaller than the
    maps).  Each view is one gather for the whole batch.  Returns the (B,
    H, W) target and the (H, W) covered mask, which the batch shares.
    """
    cfg = plan.cfg
    lvl = plan.levels[lvl_idx]
    stacked = isinstance(pmaps, torch.Tensor)
    b = pmaps.shape[0] if stacked else pmaps[0].shape[0]
    device = pmaps.device if stacked else pmaps[0].device
    tgt_sum = torch.zeros((b, lvl.height, lvl.width), dtype=torch.float32,
                          device=device)
    for v, (x_lo, x_hi, y_lo, y_hi) in enumerate(lvl.bboxes):
        pm = pmaps[:, v] if stacked else pmaps[v]
        idx = _on_device(_view_gather_indices, cfg, lvl_idx, v,
                         tuple(pm.shape[-2:]), device)
        if idx is None:
            continue
        slab = as01_post(pm.reshape(b, -1)[:, idx])
        if abcd is not None:
            slab = apply_cubic(slab, abcd[:, v, None, None, :])
        lap = slab[:, 1:-1, 1:-1] - 0.25 * (
            slab[:, 1:-1, :-2] + slab[:, 1:-1, 2:] + slab[:, :-2, 1:-1]
            + slab[:, 2:, 1:-1])
        tgt_sum[:, y_lo : y_hi + 1, x_lo : x_hi + 1] += lap
    inv_cov = _inv_cov(cfg, lvl_idx, device)
    return tgt_sum * inv_cov, inv_cov > 0


def init_level0(emaps, lvl: LevelPlan, cfg: MergeConfig):
    """Level-0 buffers from the baseline emaps (..., He, We) -> (..., H, W)
    (Depth.cpp:1441-1465), through float64 host-built nearest-resample
    indices; leading axes are a batch."""
    idx = _on_device(_level0_gather_indices, cfg, tuple(emaps.shape[-2:]),
                     emaps.device)
    vals = as01_post(emaps.reshape(*emaps.shape[:-2], -1)[..., idx])
    rows = torch.arange(lvl.height, device=emaps.device)[:, None]
    in_band = (rows >= lvl.height0) & (rows <= lvl.height1)
    return torch.where(in_band, vals, 0.0).to(torch.float32)


def upsample2x(buf):
    """Nearest 2x upsample of the last two dims (Depth.cpp:1466-1485:
    prev[y/2, x/2])."""
    return buf.repeat_interleave(2, -2).repeat_interleave(2, -1)


def fuse_batched(emaps, pmaps, plan: FusionPlan, jacobi_fn=None, abcd=None):
    """Multiresolution fusion of a batch of panoramas, the counterpart of
    ``jax.vmap(fuse)``.  Returns (u16 panoramas (B, H, W), final f32
    buffers).

    ``emaps`` — (B, He, We) baseline equirect depths, 0~1.  ``pmaps`` —
    (B, V, Hp, Wp) perspective depths (or a list of V (B, h, w) stacks),
    0~1: registered, or raw with the per-view cubics ``abcd`` (B, V, 4)
    given.  ``jacobi_fn`` — the relaxation, with the signature of
    :func:`jacobi` (the default), over (B, H, W) stacks and a shared (H,
    W) mask.  Every operation is elementwise or a gather per panorama, so
    each panorama gets the bits it gets alone, and each level is one
    gather per view and one relaxation for the whole batch.
    """
    cfg = plan.cfg
    relax = jacobi_fn or jacobi
    buf = None
    for i, lvl in enumerate(plan.levels):
        buf = init_level0(emaps, lvl, cfg) if i == 0 else upsample2x(buf)
        target, covered = level_target(pmaps, plan, i, abcd=abcd)
        buf = relax(buf.contiguous(), target, covered, lvl.iterations,
                    cfg.jacobi_step, cfg.jacobi_reg)
    out = (torch.clamp(buf, 0.0, 1.0) * 65535.0).to(torch.uint16)
    return out, buf


def fuse(emap, pmaps, plan: FusionPlan, jacobi_fn=None, abcd=None):
    """Full multiresolution fusion of one panorama.  Returns (u16
    panorama, final f32 buffer): :func:`fuse_batched` on a batch of one.

    ``emap`` — baseline equirect depth (He, We[, C]), 0~1.  ``pmaps`` —
    (V, Hp, Wp) perspective depths (or a list of V maps), 0~1: registered,
    or raw with the per-view cubic ``abcd`` (V, 4) given.  The panorama is
    a ``torch.uint16`` tensor on the inputs' device.
    """
    emap2d = emap if emap.dim() == 2 else emap[..., 0]
    pm = (pmaps[None] if isinstance(pmaps, torch.Tensor)
          else [p[None] for p in pmaps])
    out, buf = fuse_batched(emap2d[None], pm, plan, jacobi_fn=jacobi_fn,
                            abcd=None if abcd is None else abcd[None])
    return out[0], buf[0]


@functools.lru_cache(maxsize=16)
def _smoothing_plan(cfg: MergeConfig, pmap_shapes, smooth_range: int):
    """The pastes and the smoothing mask of :func:`solve_depth_by_smoothing`
    at the finest level, on the host in float64: per view None (no
    footprint) or ((y0, y1, x_lo, x_hi), flat pmap indices (i32)) over
    the view's UNCLAMPED rows, and the (H, W) bool mask of pixels within
    ``smooth_range`` of a paste's edge, inside the zenith band and off the
    first and last column."""
    plan = build_fusion_plan(cfg)
    lvl_idx = len(plan.levels) - 1
    lvl = plan.levels[lvl_idx]
    h, w = lvl.height, lvl.width
    windows = geometry.layout_windows(cfg.layout.fovs)
    pastes = []
    smooth = np.zeros((h, w), bool)
    for v, (x_lo, x_hi, _, _) in enumerate(lvl.bboxes):
        if _view_gather_indices(cfg, lvl_idx, v, pmap_shapes[v]) is None:
            pastes.append(None)
            continue
        # SolveDepthBySmoothing walks the unclamped y range (no zenith-band
        # clamp, Depth.cpp:1797-1813): recompute it from the raw ranges
        rng = cfg.clamped_ranges()[v]
        y0 = _cround(rng[2] / np.pi * (h - 1))
        y1 = _cround(rng[3] / np.pi * (h - 1))
        xs = np.arange(x_lo, x_hi + 1)
        ys = np.arange(max(y0, 0), min(y1, h - 1) + 1)
        azi = xs.astype(np.float64) / (w - 1) * TWO_PI
        zen = ys.astype(np.float64) / (h - 1) * np.pi
        ag, zg = np.meshgrid(azi, zen)
        px, py = geometry.spherical_to_xy(geometry.window_at(windows, v),
                                          ag, zg)
        ph, pw = pmap_shapes[v]
        pxi = np.clip((np.clip(px, 0, 1) * (pw - 1)).astype(np.int64), 0,
                      pw - 1)
        pyi = np.clip((np.clip(py, 0, 1) * (ph - 1)).astype(np.int64), 0,
                      ph - 1)
        pastes.append(((int(ys[0]), int(ys[-1]), x_lo, x_hi),
                       (pyi * pw + pxi).astype(np.int32)))
        near = np.zeros((h, w), bool)
        near[ys[0]: ys[-1] + 1, x_lo: x_hi + 1] = True
        interior = np.zeros((h, w), bool)
        iy0, iy1 = ys[0] + smooth_range + 1, ys[-1] - smooth_range
        ix0, ix1 = x_lo + smooth_range + 1, x_hi - smooth_range
        if iy1 > iy0 and ix1 > ix0:
            interior[iy0:iy1, ix0:ix1] = True
        smooth |= near & ~interior
    band = np.zeros((h, w), bool)
    band[lvl.height0: lvl.height1 + 1, 1: w - 1] = True
    return tuple(pastes), smooth & band


@graphs.device_cache(maxsize=16)
def _smoothing_tables(cfg: MergeConfig, pmap_shapes, smooth_range: int,
                      device: torch.device):
    """:func:`_smoothing_plan` with its indices and mask on ``device``."""
    pastes, mask = _smoothing_plan(cfg, pmap_shapes, smooth_range)
    return (tuple(None if p is None else
                  (p[0], torch.from_numpy(p[1].astype(np.int64)).to(device))
                  for p in pastes),
            torch.from_numpy(mask).to(device))


def solve_depth_by_smoothing(pmaps, plan: FusionPlan, iterations: int = 500,
                             smooth_range: int = 10):
    """The reference's alternative trivial fusion (SolveDepthBySmoothing,
    Depth.cpp:1773-1878, disabled at Depth.cpp:919-922): each view's values
    are pasted into its footprint over its unclamped rows (later views
    overwrite earlier ones), the pixels within ``smooth_range`` of a
    footprint's edge relax toward their 4-neighbour average for
    ``iterations`` rounds, and the result is u16-quantized.  Returns (u16
    panorama, f32 buffer).

    ``pmaps`` is a (V, Hp, Wp) tensor or a list of V maps, 0~1 or u16.
    As in the JAX package the relaxation is a dense Jacobi where the
    reference's in-place scan is Gauss-Seidel (the path is disabled in the
    reference, so there is no output to match bit for bit).
    """
    lvl = plan.levels[-1]
    device = pmaps[0].device
    shapes = tuple(tuple(int(d) for d in pmaps[v].shape[-2:])
                   for v in range(len(lvl.bboxes)))
    pastes, mask = _smoothing_tables(plan.cfg, shapes, smooth_range, device)
    buf = torch.zeros((lvl.height, lvl.width), dtype=torch.float32,
                      device=device)
    for v, paste in enumerate(pastes):
        if paste is None:
            continue
        (y0, y1, x_lo, x_hi), idx = paste
        buf[y0: y1 + 1, x_lo: x_hi + 1] = as01_post(
            pmaps[v].reshape(-1)[idx])
    for _ in range(iterations):
        avg = 0.25 * (torch.roll(buf, 1, 1) + torch.roll(buf, -1, 1)
                      + torch.roll(buf, 1, 0) + torch.roll(buf, -1, 0))
        buf = torch.where(mask, buf + 0.5 * (avg - buf), buf)
    return (torch.clamp(buf, 0.0, 1.0) * 65535.0).to(torch.uint16), buf
