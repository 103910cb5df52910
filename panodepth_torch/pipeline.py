"""Stage A, the merge pipeline and the resumable batch loop.

Counterpart of the file mode of ``panodepth/pipeline.py``:

``extract_stage_a``   — perspective RGB views of every panorama written to
                        files, one gather per view-shape group for a batch
                        of panoramas (the reference renders them with GL,
                        ``Main.cpp:242-326``).
``merge_arrays``      — the device core (register every view -> cubic remap
                        -> multiresolution fusion -> u16), the compute of
                        ``MergeDepthMaps`` (reference ``Depth.cpp:754-930``).
``merge_depth_maps``  — file-in/file-out merge of one panorama with optional
                        gt scoring and the masked ``.res.png``/``.giv.png``
                        outputs (``Depth.cpp:933-1035``).
``run_batch``         — the dataset walker with skip-if-output-exists resume,
                        quarantine, ``manifest.json`` and rolling 5-image
                        metric reports (reference ``Main.cpp:489-685``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; if
CUDA is asked for and absent they raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from . import io as pio
from . import metrics as pmetrics
from . import registration
from .config import MergeConfig
from .fusion import build_fusion_plan, fuse
from .kernels import jacobi as kjacobi
from .ops.projection import extract_group, view_groups

REPORT_EVERY = 5  # rolling report period, in panoramas (Main.cpp:608-684)


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' (CLI --device cpu) to run on the CPU")
    return dev


@contextlib.contextmanager
def true_f32():
    """TF32 off for matmuls and cuDNN inside the block; the caller's flags
    are restored on exit.

    The registration Gram A^T A (registration._normal_solve4) squares the
    conditioning and must run in true f32, not TF32's 10-bit mantissa, and
    the f32 nets must not run cuDNN in TF32.  The flags are process-wide
    (another thread's work inside the block sees them too); on the CPU they
    change nothing.
    """
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _as01(x):
    """u16 input -> f32 0~1 (k / 65535); floats pass through.

    The merge normalizes before any gather: PyTorch runs few operations on
    uint16 CUDA tensors, and a cast is one of them.
    """
    if x.dtype == torch.uint16:
        return x.to(torch.float32) / 65535.0
    return x


def merge_arrays(emap, pmaps, cfg: MergeConfig, jacobi: str = "auto",
                 device="cuda"):
    """Device core: baseline emap + V perspective depths -> fused u16 pano.

    ``emap`` (He, We[, C]) and ``pmaps`` (V, Hp, Wp) are numpy arrays or
    tensors of 0~1 floats (or uint16), moved to ``device``.  ``jacobi`` is
    ``auto`` (the CUDA kernel on a CUDA device, the plain version on the
    CPU), ``kernel`` or ``torch`` (the plain version).  Returns
    (out_u16 (H, W) ``torch.uint16``, abcd (V, 4)), both on ``device``.
    """
    dev = resolve_device(device)
    emap = _as01(torch.as_tensor(emap, device=dev))
    pmaps = _as01(torch.as_tensor(pmaps, device=dev))
    with true_f32():
        abcd = registration.register_views(emap, pmaps, cfg)
        plan = build_fusion_plan(cfg)
        # the cubic remap is fused into the slab gathers (abcd=) instead of
        # transforming V full-size maps
        out_u16, _ = fuse(emap, pmaps, plan,
                          jacobi_fn=kjacobi.resolve(jacobi), abcd=abcd)
    return out_u16, abcd


def _load_inputs(baseline_filename, pmap_filenames):
    """Decode the baseline and every view (the reference loads them
    synchronously, Depth.cpp:754-787)."""
    return (pio.load_image01(baseline_filename),
            [pio.load_image01(f) for f in pmap_filenames])


@dataclasses.dataclass
class MergeOutput:
    out_u16: np.ndarray
    abcd: np.ndarray
    metrics: Optional[pmetrics.Metrics]
    # registration and fusion run as one call; its time counts as fusion
    time_fusion_ms: int


def merge_depth_maps(
    baseline_filename: str,
    pmap_filenames: List[str],
    out_filename: str,
    cfg: MergeConfig,
    gt_filename: Optional[str] = None,
    jacobi: str = "auto",
    device="cuda",
) -> MergeOutput:
    """File-level merge of one panorama (MergeDepthMaps parity).

    Registration and fusion run as one call; its time (host clock around
    work that ends in a device-to-host copy) is attributed to fusion.
    """
    dev = resolve_device(device)
    emap, views = _load_inputs(baseline_filename, pmap_filenames)
    shapes = {v.shape for v in views}
    if len(shapes) != 1:
        raise ValueError(f"perspective maps disagree in shape: {shapes}")
    pmaps = np.stack([v if v.ndim == 2 else v[..., 0] for v in views])

    t0 = time.monotonic()
    out_u16, abcd = merge_arrays(emap, pmaps, cfg, jacobi=jacobi, device=dev)
    out_u16 = out_u16.cpu().numpy()
    abcd = abcd.cpu().numpy()
    fus_ms = int((time.monotonic() - t0) * 1000)

    pio.save_png16(out_filename, out_u16)

    result = MergeOutput(out_u16, abcd, None, fus_ms)
    if gt_filename and os.path.exists(gt_filename):
        gt = pio.load_image01(gt_filename)
        result.metrics = pmetrics.paired_metrics(
            torch.as_tensor(gt, device=dev), torch.as_tensor(emap, device=dev),
            torch.as_tensor(out_u16.astype(np.float32) / np.float32(65535.0),
                            device=dev),
            align_way=cfg.align_way, cap_depth=cfg.cap_depth,
            zenith_range=cfg.zenith_range,
        )
        _save_masked_variants(out_filename, out_u16, emap, gt, cfg)
    return result


def _save_masked_variants(out_filename, out_u16, emap, gt, cfg: MergeConfig):
    """.res.png / .giv.png with gt-invalid pixels blacked/whited out.

    Mirrors reference Depth.cpp:949-1035.
    """
    gt2 = gt if gt.ndim == 2 else gt[..., 0]
    for tag, img_u16, h, w in (
        (".res.png", out_u16, out_u16.shape[0], out_u16.shape[1]),
        (".giv.png",
         pio.to_uint16(emap if emap.ndim == 2 else emap[..., 0]),
         emap.shape[0], emap.shape[1]),
    ):
        h0 = int(math.floor(h * cfg.zenith_range[0] / math.pi))
        h1 = int(math.ceil(h * cfg.zenith_range[1] / math.pi))
        ys = (np.arange(h) * (gt2.shape[0] / h)).astype(np.int64)
        xs = (np.arange(w) * (gt2.shape[1] / w)).astype(np.int64)
        g = gt2[np.clip(ys, 0, gt2.shape[0] - 1)[:, None],
                np.clip(xs, 0, gt2.shape[1] - 1)[None, :]]
        band = np.broadcast_to(
            (np.arange(h)[:, None] >= h0) & (np.arange(h)[:, None] <= h1), (h, w)
        )
        out = np.where(band, img_u16, 0)
        out = np.where(band & (g == 0), 0, out)
        out = np.where(band & (g >= 1 - 1e-4), 65535, out)
        pio.save_png16(out_filename + tag, out.astype(np.uint16))


@functools.lru_cache(maxsize=8)
def _extract_batched(cfg: MergeConfig, width: int, device: torch.device):
    """Stage-A extraction as one gather per view-shape group for a whole
    (B, H, W, 3) stack of panoramas on ``device``.  Returns (fn over the
    stack -> [(B, |idxs|, h, w, 3) per group], [(view_shape, view_indices),
    ...]).  Counterpart of ``_compiled_extract_batched``; the tap tables
    are cached per device by ``ops/projection``."""
    layout = cfg.layout
    groups = list(view_groups(layout, width).items())

    def fn(rgbs):
        return [extract_group(rgbs, layout.fovs[idxs], shape)
                for shape, idxs in groups]

    return fn, groups


def extract_stage_a(rgb_files, views_folder: str, cfg: MergeConfig,
                    width: int = 1024, pmap_ext: str = ".jpg",
                    batch_size: int = 4, log=print, device="cuda") -> int:
    """Extract perspective RGB views for every listed panorama (stage A).

    Panoramas are batched (grouped by image shape) so each gather covers
    one view-shape group for the whole batch; batch k+1 is submitted to the
    device before batch k is copied back and written, so its extraction
    overlaps the JPEG writes of batch k.  Panoramas whose view files all
    exist are skipped.  Returns the number extracted.
    """
    dev = resolve_device(device)
    layout = cfg.layout
    os.makedirs(views_folder, exist_ok=True)
    todo = []
    for f in rgb_files:
        raw = pio.raw_name(f)
        outs = pio.pmap_filenames(views_folder, raw, layout, ext=pmap_ext)
        if not all(os.path.exists(o) for o in outs):
            todo.append((f, outs))
    if not todo:
        return 0
    fn, groups = _extract_batched(cfg, width, dev)

    def submit(batch):
        rgbs = torch.as_tensor(np.stack([b[0] for b in batch]), device=dev)
        # the copies back are queued behind this batch's gathers only, so
        # collect() waits for this batch and not for the next one
        host = [v.to("cpu", non_blocking=True) for v in fn(rgbs)]
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        return batch, host, done

    def collect(pending):
        batch, host, done = pending
        if done is not None:
            done.synchronize()
        for g, (_, idxs) in enumerate(groups):
            arr = host[g].numpy()  # (B, |idxs|, h, w, C)
            for bi, (_, outs) in enumerate(batch):
                for j, vi in enumerate(idxs):
                    pio.save_jpg(outs[vi], arr[bi, j])

    pending = None
    batch = []
    cur_shape = None
    for f, outs in todo:
        rgb = pio.load_image01(f)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        rgb = rgb[..., :3]
        if batch and (rgb.shape != cur_shape or len(batch) == batch_size):
            nxt = submit(batch)
            if pending is not None:
                collect(pending)
            pending = nxt
            batch = []
        cur_shape = rgb.shape
        batch.append((rgb, outs))
    if batch:
        nxt = submit(batch)
        if pending is not None:
            collect(pending)
        pending = nxt
    if pending is not None:
        collect(pending)
    return len(todo)


def run_batch(
    rgb_folder: str,
    gt_folder: str,
    baseline_folder: str,
    result_folder: str,
    cfg: MergeConfig = MergeConfig(),
    views_folder: str = "test_images",
    dataset: str = "matterport",
    extract_rgb_views: bool = True,
    pmap_ext: str = ".jpg",
    log=print,
    limit: Optional[int] = None,
    include: Optional[List[str]] = None,
    exclude: Optional[List[str]] = None,
    shard: Optional[str] = None,
    batch_size: int = 1,
    jacobi: str = "auto",
    device="cuda",
) -> List[pmetrics.Metrics]:
    """Batch loop (CreateDepthPanoramas parity, Main.cpp:329-689).

    Stage A extracts perspective RGB views of every panorama into
    ``views_folder`` (unless ``extract_rgb_views`` is False), batching at
    least 4 panoramas per gather; an external depth model is expected to
    turn those into perspective depth maps with the same names; stage C
    merges whatever the folder holds under the layout's names, one panorama
    after another (``batch_size`` batches stage A only: the batched merge
    is not ported).  Already-produced results are skipped, which makes the
    batch resumable per panorama (Main.cpp:554-563); a panorama whose inputs
    fail to load is quarantined and the batch goes on.  ``limit``/``include``/``exclude``/
    ``shard`` are the runtime form of the reference's compile-time
    selection blocks (Main.cpp:357-407).  ``manifest.json`` records the
    completed, skipped and quarantined items with their times.
    """
    dev = resolve_device(device)
    rgb_files = pio.filter_files(pio.list_images(rgb_folder),
                                 include, exclude, limit, shard)
    log(f"[run_batch] {len(rgb_files)} RGB panoramas")
    layout = cfg.layout

    stage_a_ms = 0
    if extract_rgb_views and rgb_files:
        os.makedirs(views_folder, exist_ok=True)
        t0 = time.monotonic()
        extract_stage_a(rgb_files, views_folder, cfg, pmap_ext=pmap_ext,
                        batch_size=max(batch_size, 4), device=dev)
        stage_a_ms = int((time.monotonic() - t0) * 1000)
        log(f"[run_batch] stage A done in {stage_a_ms / 1000:.1f}s")

    os.makedirs(result_folder, exist_ok=True)
    all_metrics: List[pmetrics.Metrics] = []
    fusion_times: List[int] = []
    completed, skipped, quarantined = [], [], []

    for i, f in enumerate(rgb_files):
        raw = pio.raw_name(f)
        out_file = os.path.join(result_folder, raw + ".png")
        if os.path.exists(out_file):
            log(f"{i}/{len(rgb_files)} skip!")
            skipped.append(raw)
            continue
        try:
            res = merge_depth_maps(
                pio.baseline_filename(baseline_folder, raw, result_folder),
                pio.pmap_filenames(views_folder, raw, layout, ext=pmap_ext),
                out_file, cfg, pio.gt_filename(gt_folder, raw, dataset),
                jacobi=jacobi, device=dev)
        except (FileNotFoundError, ValueError, OSError) as e:
            log(f"{i}/{len(rgb_files)} FAILED ({e}); quarantined, continuing")
            quarantined.append({"name": raw, "error": str(e)})
            continue
        completed.append(raw)
        fusion_times.append(res.time_fusion_ms)
        if res.metrics is not None:
            res.metrics.save(os.path.join(result_folder, raw + ".aligned.txt"))
            all_metrics.append(res.metrics)
            res.metrics.print()
        if all_metrics and (i == len(rgb_files) - 1
                            or (i > 0 and i % REPORT_EVERY == 0)):
            _rolling_report(all_metrics, fusion_times, log)

    mname = ("manifest.json" if shard is None
             else f"manifest.{shard.replace('/', '-of-')}.json")
    with open(os.path.join(result_folder, mname), "w") as fp:
        json.dump({
            "completed": completed,
            "skipped": skipped,
            "quarantined": quarantined,
            "time_reg_ms": [],
            "time_fusion_ms": fusion_times,
            "stage_a_ms": stage_a_ms,
            "config": {"layout": cfg.layout_name,
                       "out_width": cfg.out_width},
        }, fp, indent=1)
    return all_metrics


def _rolling_report(ms: List[pmetrics.Metrics], fus, log):
    """Rolling averages in the reference's report shape (Main.cpp:608-684)."""
    n = len(ms)

    def avg(f):
        return sum(f(m) for m in ms) / n

    log("-" * 10)
    log(
        f"RMSE_given:{avg(lambda m: math.sqrt(m.mse_given)):.6f}"
        f" RMSE_result:{avg(lambda m: math.sqrt(m.mse_result)):.6f}"
        f" MAE_given:{avg(lambda m: m.mae_given):.6f}"
        f" MAE_result_avg:{avg(lambda m: m.mae_result):.6f}"
        f" MRE_given:{avg(lambda m: m.mre_given):.6f}"
        f" MRE_result_avg:{avg(lambda m: m.mre_result):.6f}"
        f" RMSElog_given:{avg(lambda m: math.sqrt(m.mselog_given)):.6f}"
        f" RMSElog_result:{avg(lambda m: math.sqrt(m.mselog_result)):.6f}"
        f" delta1_given:{avg(lambda m: m.delta1_given):.6f}"
        f" delta1_result:{avg(lambda m: m.delta1_result):.6f}"
        f" delta2_given:{avg(lambda m: m.delta2_given):.6f}"
        f" delta2_result:{avg(lambda m: m.delta2_result):.6f}"
        f" delta3_given:{avg(lambda m: m.delta3_given):.6f}"
        f" delta3_result:{avg(lambda m: m.delta3_result):.6f}"
    )
    if fus:
        log(f"time_Reg_avg:n/a (fused graph)"
            f" time_Laplacian_avg:{sum(fus) / len(fus):.1f}")
    log("-" * 10)
