"""The on-device e2e graph: RGB panorama -> both CNNs -> merge -> u16 depth.

Counterpart of ``panodepth/e2e.py``.  The reference crosses a process
boundary twice: GL renders perspective views to disk, an external CNN turns
them into depth images, and separately produced baseline panoramas are
read from disk (``Main.cpp:438-474, 500-516``).  Here the chain runs on one
device with no pixels leaving it between stages:

    FastPanoNet(resize(rgb))        -> baseline panorama      (0~1)
    extract_views(rgb)              -> V perspective RGB views
    NFPerspectiveNet(views)         -> V perspective depths   (0~1)
    register_views + fuse           -> u16 panorama

The baseline may instead come from files (the reference's form).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
card the GroupNorms and the Jacobi run their CUDA kernels.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from . import io as pio
from . import metrics as pmetrics
from . import registration
from .config import MergeConfig
from .fusion import build_fusion_plan, fuse
from .kernels import groupnorm as kgroupnorm
from .kernels import jacobi as kjacobi
from .models import norm as pnorm
from .models import weights
from .models.perspective import predict_depth01
from .ops.projection import extract_group, view_groups
from .ops.resize import resize_bilinear, resize_bilinear_nhwc
from .pipeline import resolve_device, true_f32

EXTRACT_DTYPES = ("auto", "f32")


def _round32(v: int) -> int:
    """Next multiple of 32 (the CNNs' stride granularity), rounding up: the
    15 views of ``5fold_leres`` at view width 256 are 247x256 and run the
    perspective CNN at 256x256, its training resolution."""
    return max(32, -(-v // 32) * 32)


def _as01_img(x):
    """Integer images to f32 0~1 (uint8 / 255, uint16 / 65535); floats pass
    through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    if x.dtype == torch.uint16:
        return x.to(torch.float32) / 65535.0
    return x


def _resolve_extract_dtype(mode: str) -> str:
    """The view-extraction table type.  ``auto`` is ``f32``, the JAX
    package's choice off the TPU; its packed tables (``packed``,
    ``packed16``, ``pair16``, ``pair16d``, ``bf16``) are TPU-only and not
    ported."""
    if mode not in EXTRACT_DTYPES:
        raise ValueError(f"extract dtype {mode!r} is a TPU gather table and "
                         f"not ported; use one of {EXTRACT_DTYPES}")
    return "f32"


def _stack_if_uniform(maps):
    """Per-view maps as one (V, h, w) tensor when they share a shape (one
    gather per stage instead of one per view), else the list."""
    if len({tuple(m.shape) for m in maps}) == 1:
        return torch.stack(maps)
    return list(maps)


def full_pipeline(rgb, persp_model, base_model=None, baseline=None,
                  cfg: MergeConfig = MergeConfig(), view_width: int = 512,
                  jacobi: str = "auto", base_w: int = 512, device="cuda"):
    """RGB equirect (H, W, 3) -> (u16 (out_h, out_w), abcd, baseline, pmaps).

    Either a panoramic baseline model or a precomputed ``baseline`` map must
    be given.  The perspective CNN runs on each view resized to multiples of
    32, the baseline CNN at ``base_w`` wide: :func:`build_batched_e2e` on a
    batch of one.
    """
    _, models_stage, fuse_stage = build_batched_e2e(
        persp_model, cfg, view_width=view_width, base_model=base_model,
        base_w=base_w, jacobi=jacobi, device=device)
    rgb = torch.as_tensor(rgb)
    if baseline is None:
        bases, pmaps = models_stage(rgb[None])
    else:
        bases, pmaps = models_stage(rgb[None], torch.as_tensor(baseline)[None])
    out_u16, abcd = fuse_stage(bases, pmaps)
    return out_u16[0], abcd[0], bases[0], [p[0] for p in pmaps]


def load_model_checkpoint(ckpt_path: str, norm_dtype=None, device="cuda",
                          dtype=torch.bfloat16):
    """A net and its architecture dict from a ``*.params.npz`` checkpoint and
    its ``<model>.config.json`` sidecar (``models/weights.py``).

    ``norm_dtype`` is the GroupNorm output type (f32 when None, as the JAX
    package runs off the TPU); ``dtype`` the conv compute type (bf16, as
    in JAX).  Only ``perspective``/``nf`` and ``fastpano`` are ported.
    """
    arch = weights.read_arch(ckpt_path)
    model = weights.build_model(arch, dtype=dtype,
                                norm_dtype=norm_dtype or torch.float32)
    weights.load_params(model, weights.read_params_npz(ckpt_path))
    return model.to(resolve_device(device)).eval(), arch


def build_batched_e2e(persp_model, cfg: MergeConfig, view_width: int = 512,
                      base_model=None, base_w: int = 512,
                      extract_dtype: str = "auto", jacobi: str = "auto",
                      groupnorm: str = "auto", device="cuda"):
    """Batched e2e stages over (B, H, W, 3) RGB stacks (plus a (B, h, w)
    baseline stack when ``base_model`` is None).  Returns
    ``(full, models_stage, fuse_stage)``:

    - ``models_stage(rgbs[, baselines]) -> (baselines, pmaps)``: the
      baseline CNN, view extraction and the perspective CNN, every view of
      every panorama of the batch in one CNN call per view shape;
    - ``fuse_stage(baselines, pmaps) -> (out_u16, abcd)``: registration
      and fusion, one panorama after another;
    - ``full(rgbs[, baselines]) -> (out_u16, baselines)``: both.

    The nets are moved to ``device``; ``groupnorm`` is the route of the
    baseline CNN's GroupNorms and ``jacobi`` that of the relaxation
    (``auto``: the CUDA kernels on the card, the plain versions on the CPU).
    """
    _resolve_extract_dtype(extract_dtype)
    dev = resolve_device(device)
    relax = kjacobi.resolve(jacobi)
    kgroupnorm.resolve(groupnorm)
    persp_model = persp_model.to(dev)
    if base_model is not None:
        base_model = base_model.to(dev)
    layout = cfg.layout
    plan = build_fusion_plan(cfg)
    groups = list(view_groups(layout, view_width).items())

    # TF32 off while a stage runs, the caller's flags back after it
    @true_f32()
    def models_stage(rgbs, baselines=None):
        rgbs01 = _as01_img(torch.as_tensor(rgbs, device=dev))
        b = rgbs01.shape[0]
        if baselines is None:
            rb = resize_bilinear_nhwc(rgbs01, (base_w // 2, base_w))
            # the route is set per call: graphs built with other routes may
            # share this net
            baselines = pnorm.set_route(base_model, groupnorm)(rb)
        else:
            baselines = _as01_img(torch.as_tensor(baselines, device=dev))
        pmaps: List[torch.Tensor] = [None] * layout.num_views  # type: ignore
        for (h, w), idxs in groups:
            views = extract_group(rgbs01, layout.fovs[idxs], (h, w))
            flat = views.reshape(b * len(idxs), h, w, 3)
            nh, nw = _round32(h), _round32(w)
            if (nh, nw) != (h, w):
                flat = resize_bilinear_nhwc(flat, (nh, nw))
            depths = predict_depth01(persp_model, flat)
            if (nh, nw) != (h, w):
                depths = resize_bilinear(depths, (h, w))
            depths = depths.reshape(b, len(idxs), h, w)
            for j, i in enumerate(idxs):
                pmaps[i] = depths[:, j]
        return baselines, pmaps

    @true_f32()
    def fuse_stage(baselines, pmaps):
        outs, abcds = [], []
        for k in range(baselines.shape[0]):
            pm = _stack_if_uniform([p[k] for p in pmaps])
            abcd = registration.register_views(baselines[k], pm, cfg)
            out_u16, _ = fuse(baselines[k], pm, plan, jacobi_fn=relax,
                              abcd=abcd)
            outs.append(out_u16)
            abcds.append(abcd)
        return torch.stack(outs), torch.stack(abcds)

    def full(*args):
        baselines, pmaps = models_stage(*args)
        out_u16, _ = fuse_stage(baselines, pmaps)
        return out_u16, baselines

    return full, models_stage, fuse_stage


def run_batch_e2e(rgb_folder: str, gt_folder: str, result_folder: str,
                  persp_ckpt: str, cfg: MergeConfig = MergeConfig(),
                  baseline_ckpt: Optional[str] = None,
                  baseline_folder: Optional[str] = None,
                  dataset: str = "matterport", view_width=None, limit=None,
                  include=None, exclude=None, shard=None, batch_size: int = 1,
                  jacobi: str = "auto", extract_dtype: str = "auto",
                  infer_norm: str = "auto", base_width=None, log=print,
                  device="cuda"):
    """The model-mode batch: RGB -> models -> registration -> fusion.

    The perspective checkpoint is mandatory; the baseline comes from a
    second checkpoint or from baseline files (the reference's naming).
    ``batch_size`` panoramas run per call, the last chunk padded by
    repetition; decoding the next panorama and writing PNGs overlap the
    device work.  Writes ``<raw>.png`` and, where a gt exists,
    ``<raw>.aligned.txt``; skips a panorama whose ``<raw>.png`` exists.
    ``infer_norm`` is the GroupNorm output type: ``auto`` is f32, as the
    JAX package runs off the TPU, or ``f32`` / ``bf16``.  Returns the
    metrics of the gt-scored panoramas.
    """
    if infer_norm not in ("auto", "f32", "bf16"):
        raise ValueError(f"infer_norm must be auto, f32 or bf16, "
                         f"got {infer_norm!r}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    dev = resolve_device(device)
    norm_dtype = torch.bfloat16 if infer_norm == "bf16" else None
    persp_model, persp_arch = load_model_checkpoint(persp_ckpt, norm_dtype,
                                                    device=dev)
    if view_width is None:
        # the perspective CNN's training resolution (zoo/README.md)
        view_width = persp_arch.get("view_size", 512)
    base_model, base_w = None, 512
    if baseline_ckpt:
        base_model, base_arch = load_model_checkpoint(baseline_ckpt,
                                                      norm_dtype, device=dev)
        base_w = base_width or base_arch.get("pano_width", 512)
    full, _, _ = build_batched_e2e(
        persp_model, cfg, view_width=view_width, base_model=base_model,
        base_w=base_w, extract_dtype=extract_dtype, jacobi=jacobi,
        device=dev)

    rgb_files = pio.filter_files(pio.list_images(rgb_folder),
                                 include, exclude, limit, shard)
    os.makedirs(result_folder, exist_ok=True)
    log(f"[run_batch_e2e] {len(rgb_files)} panoramas, on-device models, "
        f"batch {batch_size}")

    def decode(f):
        raw = pio.raw_name(f)
        rgb = pio.load_image01(f).astype(np.float32)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        rgb = rgb[..., :3]
        base = None
        if base_model is None:
            base = pio.load_image01(pio.baseline_filename(
                baseline_folder, raw, result_folder))
            if base.ndim == 3:
                base = base[..., 0]
        gt_file = pio.gt_filename(gt_folder, raw, dataset)
        gt = pio.load_image01(gt_file) if os.path.exists(gt_file) else None
        return rgb, base, gt

    todo = []
    for i, f in enumerate(rgb_files):
        raw = pio.raw_name(f)
        if os.path.exists(os.path.join(result_folder, raw + ".png")):
            log(f"{i}/{len(rgb_files)} skip!")
            continue
        todo.append((i, f, raw))

    all_metrics: List[pmetrics.Metrics] = []
    times: List[float] = []
    writes = []

    def run(chunk):
        """chunk: list of (i, raw, rgb, baseline, gt); padded to the batch."""
        n = len(chunk)
        pad = [chunk[-1]] * (batch_size - n)
        args = [torch.as_tensor(np.stack([c[2] for c in chunk + pad]),
                                device=dev)]
        if base_model is None:
            args.append(torch.as_tensor(np.stack([c[3] for c in chunk + pad]),
                                        device=dev))
        t0 = time.monotonic()
        out_u16, baselines = full(*args)
        out_np = out_u16[:n].cpu().numpy()
        bases = baselines[:n]
        times.extend([(time.monotonic() - t0) * 1000 / n] * n)
        for j, (i, raw, _, _, gt) in enumerate(chunk):
            writes.append(pool.submit(
                pio.save_png16, os.path.join(result_folder, raw + ".png"),
                out_np[j]))
            if gt is None:
                continue
            m = pmetrics.paired_metrics(
                torch.as_tensor(gt, device=dev), bases[j],
                torch.as_tensor(out_np[j].astype(np.float32)
                                / np.float32(65535.0), device=dev),
                align_way=cfg.align_way, cap_depth=cfg.cap_depth,
                zenith_range=cfg.zenith_range)
            m.save(os.path.join(result_folder, raw + ".aligned.txt"))
            m.print()
            all_metrics.append(m)

    pool = ThreadPoolExecutor(max_workers=2)
    batch, cur_shape = [], None
    try:
        nxt = pool.submit(decode, todo[0][1]) if todo else None
        for k, (i, f, raw) in enumerate(todo):
            rgb, base, gt = nxt.result()
            nxt = (pool.submit(decode, todo[k + 1][1])
                   if k + 1 < len(todo) else None)
            shape = (rgb.shape, None if base is None else base.shape)
            # a batch ends when it is full or the input shape changes
            if batch and (shape != cur_shape or len(batch) == batch_size):
                run(batch)
                batch = []
            cur_shape = shape
            batch.append((i, raw, rgb, base, gt))
        if batch:
            run(batch)
        for job in writes:
            job.result()
    finally:
        pool.shutdown(wait=True)
    if times:
        log(f"[run_batch_e2e] done: {len(times)} panoramas, "
            f"time_Models_avg:n/a (one call) "
            f"time_Fuse_avg:{np.mean(times):.1f}")
    return all_metrics
