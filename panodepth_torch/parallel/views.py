"""View-parallel latency mode: one panorama's views spread over the ranks.

Counterpart of ``panodepth/parallel/views.py``.  The batched e2e graph
(``e2e.build_batched_e2e``) scales throughput by spreading panoramas over
``dp``; a request of one panorama still runs every stage on one device.
Here the per-view fan-out (view extraction, the perspective CNN, the
per-view registration fit and fusion targets: the reference's serial loop
over 15 windows, ``Main.cpp:242-516``) is spread over the ``vp`` ranks, so
one panorama's views run on several devices at once:

* every rank runs the baseline CNN on the whole panorama (replicated),
  extracts and infers its own ``vp / n`` views (the views padded to a
  multiple of ``n``, split contiguously: rank ``d`` takes views
  ``d * vp / n ..``), fits their cubics and adds their target-Laplacian
  slabs into a partial canvas per pyramid level: one ``graphs.Graphed``
  stage a rank;
* one reduce-scatter per level sums the ranks' canvases and leaves each
  rank its width shard of the target (half the bytes of an all-reduce);
* the relaxation runs width-sharded over the same ranks
  (``parallel.spatial.jacobi_local``, ring halos, the Jacobi kernel on the
  shards on the card), eagerly between the collectives, and the u16
  shards are all-gathered, so that every rank holds the panorama.

Numerics: the single-device graph's op order, but a pixel's sum over its
covering views runs as the ranks' partial sums added by the
reduce-scatter.  With contiguous views that is the single-device order
wherever a later rank's part of a pixel is one view (at ``5fold_leres``
over 2 or 4 ranks, every pixel of every level), so the fusion is bit-equal
to ``fusion.fuse`` on the graph's own views and coefficients.

Padded views repeat view 0's window; their registration weights and slab
masks are 0, so their fit degenerates to junk (even NaN) coefficients that
a ``where`` (never a multiply) keeps out of the canvases.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import debug as pdebug
from .. import graphs
from ..config import MergeConfig
from ..fusion import (_inv_cov, _view_gather_indices, build_fusion_plan,
                      init_level0, upsample2x)
from ..ops.projection import PACKED, extract_group, make_table, view_shape
from ..ops.sampling import as01_post
from ..registration import (_clamp, apply_cubic, build_sample_grids,
                            fit_cubic, grid_sample_indices)
from . import multihost as mh
from .mesh import Mesh, make_mesh
from .spatial import jacobi_local


def make_vp_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """The ``vp`` mesh: the ranks of ``multihost.initialize`` (one process
    on ``device`` without it) as one ring, ``make_mesh((1, n))``; ``n``
    must be the number of processes."""
    world = mh.world() if mh.initialized() else 1
    return make_mesh((1, world if n is None else n), device=device)


def _pad_views(arr: np.ndarray, vp: int) -> np.ndarray:
    """Zero-pad the leading (view) axis of a static table to ``vp``."""
    out = np.zeros((vp, *arr.shape[1:]), arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _registration_tables(cfg: MergeConfig, emap_shape: Tuple[int, int],
                         pmap_shape: Tuple[int, int], vp: int):
    """Stacked (vp, R, C) registration gather indices and weights: the
    float64 host quantization of ``registration.register_views``, padded
    views at weight 0."""
    g = build_sample_grids(cfg)
    exi, eyi, pxi, pyi = grid_sample_indices(g, emap_shape, pmap_shape)
    wgt = g.weight.astype(np.float32)
    return tuple(_pad_views(a, vp) for a in (exi, eyi, pxi, pyi, wgt))


def _level_tables(cfg: MergeConfig, lvl_idx: int,
                  pmap_shape: Tuple[int, int], vp: int):
    """Padded per-view slab tables of one pyramid level: (idx (vp, Mh, Mw)
    i32, mask (vp, Mh-2, Mw-2) f32, org (vp, 2) i32), the flat slab gather
    indices, the valid extent of each view's target-Laplacian block and
    the block's (y, x) origin in the level.  Views with an empty fusion
    footprint, and padding views, get an all-zero mask at origin (0, 0)."""
    lvl = build_fusion_plan(cfg).levels[lvl_idx]
    tabs = [_view_gather_indices(cfg, lvl_idx, v, pmap_shape)
            for v in range(len(lvl.bboxes))]
    mh_ = max([t.shape[0] for t in tabs if t is not None], default=3)
    mw = max([t.shape[1] for t in tabs if t is not None], default=3)
    idx = np.zeros((vp, mh_, mw), np.int32)
    mask = np.zeros((vp, mh_ - 2, mw - 2), np.float32)
    org = np.zeros((vp, 2), np.int32)
    for v, t in enumerate(tabs):
        if t is None:
            continue
        sh, sw = t.shape
        idx[v, :sh, :sw] = t
        mask[v, : sh - 2, : sw - 2] = 1.0
        x_lo, _, y_lo, _ = lvl.bboxes[v]
        org[v] = (y_lo, x_lo)
    return idx, mask, org


@graphs.device_cache(maxsize=16)
def _rank_tables(cfg: MergeConfig, emap_shape, pmap_shape, vp: int,
                 first: int, count: int, device: torch.device):
    """Rows ``first .. first + count`` (a rank's views) of the registration
    and level tables on ``device``: ``((exi, eyi, pxi, pyi) int64, weight
    f32)`` and per level ``(idx int64, mask f32)``."""
    views = slice(first, first + count)
    *idx, wgt = _registration_tables(cfg, emap_shape, pmap_shape, vp)
    reg = (tuple(torch.from_numpy(a[views].astype(np.int64)).to(device)
                 for a in idx),
           torch.from_numpy(wgt[views]).to(device))
    levels = []
    for lvl_idx in range(len(build_fusion_plan(cfg).levels)):
        li, lm, _ = _level_tables(cfg, lvl_idx, pmap_shape, vp)
        levels.append((torch.from_numpy(li[views].astype(np.int64)).to(device),
                       torch.from_numpy(lm[views]).to(device)))
    return reg, tuple(levels)


def build_latency_e2e(persp_model, cfg: MergeConfig,
                      mesh: Optional[Mesh] = None, view_width: int = 512,
                      base_model=None, base_w: int = 512,
                      baseline_shape: Optional[Tuple[int, int]] = None,
                      extract_dtype: str = "auto", halo: int = 1,
                      debug: bool = False, device="cuda"):
    """The one-panorama view-parallel graph over ``mesh``
    (:func:`make_vp_mesh`; one process on ``device`` when None).

    Returns ``fn(rgb) -> (out_u16 (H, W), abcd (V, 4), emap)``, or
    ``fn(rgb, baseline)`` when no ``base_model`` is given (then
    ``baseline_shape`` names the baseline's (h, w)); ``rgb`` is one (H, W,
    3) panorama, u8 or f32 0~1, ``emap`` the 0~1 baseline the views were
    registered against.  Every rank calls ``fn`` on the same panorama and
    every rank gets the whole output.  With ``debug`` it returns ``(out,
    abcd, emap, pmaps (V', h, w), per-level targets)``, ``V'`` the views
    padded to a multiple of the ranks.  The other arguments are
    ``e2e.build_batched_e2e``'s; the baseline CNN is fed by the bilinear
    resize (as JAX's latency graph, whatever ``PANODEPTH_BASE_FEED``
    says), ``halo`` is the width-sharded Jacobi's temporal-blocking depth.

    Needs a layout whose views share one shape at ``view_width`` (every
    built-in layout's do) and level widths divisible by the ranks.
    """
    from ..e2e import _resolve_extract_dtype, baseline_of, depths_of
    from ..pipeline import _as01, true_f32

    mesh = mesh if mesh is not None else make_vp_mesh(device=device)
    group, dev = mesh.sp_group or mh.world_group(), mesh.device
    if mesh.dp != 1:
        raise ValueError(f"latency mode runs on a vp mesh (1, n), got "
                         f"{(mesh.dp, mesh.sp)}")
    layout = cfg.layout
    nv, n, d = layout.num_views, group.size, group.index
    shapes = {view_shape(layout.fovs[i], view_width) for i in range(nv)}
    if len(shapes) != 1:
        raise ValueError(
            f"latency mode needs one view shape, layout has {shapes}; "
            "use the dp-batched e2e graph for mixed-aspect layouts")
    (h, w), = shapes
    vp = -(-nv // n) * n  # views padded to a multiple of the ranks
    plan = build_fusion_plan(cfg)
    for lvl in plan.levels:
        if lvl.width % n:
            raise ValueError(
                f"level width {lvl.width} not divisible by vp={n}")
    if base_model is None and baseline_shape is None:
        raise ValueError("need base_model or baseline_shape")
    table = _resolve_extract_dtype(extract_dtype)
    per = vp // n
    views = slice(d * per, (d + 1) * per)
    fovs = _pad_views(np.asarray(layout.fovs), vp)
    fovs[nv:] = layout.fovs[0]
    fovs_l = fovs[views]
    orgs = [_level_tables(cfg, l, (h, w), vp)[2][views]
            for l in range(len(plan.levels))]
    persp_model = persp_model.to(dev)
    if base_model is not None:
        base_model = base_model.to(dev)

    @true_f32()
    def rank_stage(rgb, baseline=None):
        """This rank's views of one panorama (1, H, W, 3): the baseline,
        its views' depths and cubics, each level's partial canvas and the
        level-0 buffer."""
        rgb01 = _as01(rgb)
        if baseline is None:
            emap = baseline_of(base_model, rgb, rgb01, table, base_w)
            pdebug.check("baseline net's output", emap)
        else:
            emap = _as01(baseline)
        emap = emap[0] if emap.dim() == 3 else emap[0, ..., 0]
        src = make_table(rgb if table in PACKED and rgb.dtype == torch.uint8
                         else rgb01, table)
        pmaps = depths_of(persp_model, extract_group(src, fovs_l, (h, w),
                                                     table)[0])
        pdebug.check("perspective net's output", pmaps)
        ((exi, eyi, pxi, pyi), wgt), ltabs = _rank_tables(
            cfg, tuple(emap.shape), (h, w), vp, d * per, per, dev)
        vidx = torch.arange(per, device=dev)[:, None, None]
        d0 = _clamp(as01_post(pmaps[vidx, pyi, pxi]))
        d1 = _clamp(as01_post(emap[eyi, exi]))
        abcd = fit_cubic(d0.reshape(per, -1), d1.reshape(per, -1),
                         wgt.reshape(per, -1))
        pm_flat = pmaps.reshape(per, -1)
        canvases = []
        for l, lvl in enumerate(plan.levels):
            idx, mask = ltabs[l]
            mh_, mw = idx.shape[1:]
            canvas = torch.zeros((lvl.height + mh_, lvl.width + mw),
                                 dtype=torch.float32, device=dev)
            for j in range(per):
                slab = apply_cubic(as01_post(pm_flat[j][idx[j]]), abcd[j])
                lap = slab[1:-1, 1:-1] - 0.25 * (
                    slab[1:-1, :-2] + slab[1:-1, 2:] + slab[:-2, 1:-1]
                    + slab[2:, 1:-1])
                # where, not multiply: padded and empty views carry junk
                # (even NaN) coefficients, and NaN * 0 = NaN
                lap = torch.where(mask[j] > 0, lap, 0.0)
                oy, ox = (int(v) for v in orgs[l][j])
                canvas[oy:oy + mh_ - 2, ox:ox + mw - 2] += lap
            canvases.append(canvas[:lvl.height, :lvl.width])
        return (emap, pmaps, abcd, init_level0(emap, plan.levels[0], cfg),
                canvases)

    stage = graphs.Graphed(rank_stage, dev, (persp_model, base_model),
                           name="views.rank_stage")

    @true_f32()
    def fuse_shards(buf0, canvases):
        """Each level's canvases summed and scattered over the ranks, its
        width shard relaxed; the u16 panorama gathered on every rank."""
        buf, targets = None, []
        for l, lvl in enumerate(plan.levels):
            wl = lvl.width // n
            cols = slice(d * wl, (d + 1) * wl)
            buf = buf0[:, cols] if l == 0 else upsample2x(buf)
            inv = _inv_cov(cfg, l, dev)[:, cols]
            tgt = mh.reduce_scatter(canvases[l], -1, group) * inv
            targets.append(tgt)
            buf = jacobi_local(buf.contiguous(), tgt, inv > 0,
                               lvl.iterations, cfg.jacobi_step,
                               cfg.jacobi_reg, group, halo=halo)
        pdebug.check("fusion result", buf)
        out = (torch.clamp(buf, 0.0, 1.0) * 65535.0).to(torch.uint16)
        return mh.all_gather(out, group, axis=-1), targets

    def fn(rgb, baseline=None):
        args = [torch.as_tensor(rgb, device=dev)[None]]
        if base_model is None:
            if baseline is None or tuple(baseline.shape[:2]) != tuple(
                    baseline_shape):
                raise ValueError(f"this latency graph takes (rgb, baseline "
                                 f"{tuple(baseline_shape)})")
            args.append(torch.as_tensor(baseline, device=dev)[None])
        emap, pmaps, abcd, buf0, canvases = stage(*args)
        out, targets = fuse_shards(buf0, canvases)
        abcd = mh.all_gather(abcd, group)[:nv]
        if not debug:
            return out, abcd, emap
        return (out, abcd, emap, mh.all_gather(pmaps, group),
                tuple(mh.all_gather(t.contiguous(), group, axis=-1)
                      for t in targets))

    return fn
