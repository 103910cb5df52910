"""The on-device e2e graph: RGB panorama -> both CNNs -> merge -> u16 depth.

Counterpart of ``panodepth/e2e.py``.  The reference crosses a process
boundary twice: GL renders perspective views to disk, an external CNN turns
them into depth images, and separately produced baseline panoramas are
read from disk (``Main.cpp:438-474, 500-516``).  Here the chain runs on one
device with no pixels leaving it between stages:

    baseline CNN(resize(rgb))       -> baseline panorama      (0~1)
    extract_views(rgb)              -> V perspective RGB views
    perspective CNN(views)          -> V perspective depths   (0~1)
    register_views + fuse           -> u16 panorama

``run_batch_e2e(latency=True)`` runs one panorama at a time through the
view-parallel graph of ``parallel/views.py`` instead, its views spread
over the ranks of a process group.

The baseline CNN is any zoo family (FastPanoNet, the UniFuse-class
PanoBaselineNet, HorizonDepthNet, BiFuseNet, SliceNet), the perspective
CNN NFPerspectiveNet or the GN PerspectiveDepthNet (or its int8 graph,
``load_model_checkpoint(quantize=True)``); the baseline may
instead come from files (the reference's form).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the card the
GroupNorms, the int8 convs and the Jacobi run their CUDA kernels.

Options of the JAX package, with its defaults off the TPU: the views'
gather table (``extract_dtype``: ``auto`` is ``f32``; ``bf16``,
``packed``, ``packed16``, ``pair16``, ``pair16d``), the baseline CNN's
feed (``PANODEPTH_BASE_FEED``: ``bilinear``, or ``box``, the
integer-factor box mean of a u8 panorama) and the perspective net's 99th
percentile (``PANODEPTH_P99``: ``sort``, ``topk``, ``approx``).  The two
variables are read when a stage runs (so when it is captured or
exported, as JAX reads them when it traces) and join the key of the
stages' CUDA graphs.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from . import debug, graphs
from . import io as pio
from . import metrics as pmetrics
from . import registration
from .config import MergeConfig
from .fusion import build_fusion_plan, fuse_batched
from .kernels import groupnorm as kgroupnorm
from .kernels import jacobi as kjacobi
from .kernels import qconv as kqconv
from .models import norm as pnorm
from .models import weights
from .models.layers import set_qconv_route
from .models.perspective import predict_depth01
from .models.quantize import quantize_perspective
from .ops.projection import PACKED, extract_group, make_table, view_groups
from .ops.resize import resize_bilinear, resize_bilinear_nhwc
from .pipeline import (_as01, _double_buffered, _host_sync, _runs,
                       _to_device_async, _to_host_async, resolve_device,
                       true_f32)

EXTRACT_DTYPES = ("auto", "f32", "bf16", "packed", "packed16", "pair16",
                  "pair16d")
BASE_FEEDS = ("bilinear", "box")
# the environment variables the models stage reads when it runs
STAGE_ENV = ("PANODEPTH_BASE_FEED", "PANODEPTH_P99")


def _round32(v: int) -> int:
    """Next multiple of 32 (the CNNs' stride granularity), rounding up: the
    15 views of ``5fold_leres`` at view width 256 are 247x256 and run the
    perspective CNN at 256x256, its training resolution."""
    return max(32, -(-v // 32) * 32)


def _resolve_extract_dtype(mode: str) -> str:
    """The view-extraction table (a key of ``ops.projection.TABLES``).
    ``auto`` is ``f32``, the JAX package's choice off the TPU (on the TPU
    it takes ``pair16`` for u8 panoramas); every other mode is itself:
    ``bf16`` samples a bf16 copy, ``packed`` one int32 word a pixel (exact
    for 8-bit sources), ``packed16`` RGB565, ``pair16`` the 565 codes of a
    pixel pair (bit for bit ``packed16``'s views), ``pair16d`` the same
    Bayer-dithered."""
    if mode not in EXTRACT_DTYPES:
        raise ValueError(f"extract dtype must be one of {EXTRACT_DTYPES}, "
                         f"got {mode!r}")
    return "f32" if mode == "auto" else mode


def base_feed() -> str:
    """``PANODEPTH_BASE_FEED``: ``bilinear`` (the default) or ``box``."""
    feed = os.environ.get("PANODEPTH_BASE_FEED", "bilinear")
    if feed not in BASE_FEEDS:
        raise ValueError(f"PANODEPTH_BASE_FEED must be one of {BASE_FEEDS}, "
                         f"got {feed!r}")
    return feed


def box_feed(rgbs_u8, size):
    """The baseline CNN's input as the integer-factor box mean of u8
    panoramas (B, H, W, 3) at ``size`` (h, w), in bf16
    (``panodepth/e2e.py:313-325``).  The sums of the u8 values are exact in
    f32; the mean and the ``/ 255`` are one multiply by the f32 product of
    the f32 reciprocals, the constant XLA folds them into in the jitted
    graph.  Eager JAX divides twice, which moves 70-85 % of the f32 values
    by an ulp and, in the tests' samples, no bf16 value."""
    b, hh, ww, _ = rgbs_u8.shape
    h, w = size
    fh, fw = hh // h, ww // w
    scale = np.float32(np.float32(1.0 / (fh * fw)) * np.float32(1.0 / 255.0))
    sums = rgbs_u8.reshape(b, h, fh, w, fw, 3).to(torch.float32).sum((2, 4))
    return (sums * float(scale)).to(torch.bfloat16)


def baseline_of(base_model, rgb, rgb01, table: str, base_w: int,
                groupnorm: str = "auto", feed: str = "bilinear"):
    """The baseline CNN on one panorama (1, H, W, 3), ``rgb`` as given and
    ``rgb01`` in 0~1: its input the ``box`` feed where ``feed`` asks for
    it, the panorama is u8 and the feed's size divides it (JAX's gate),
    else the antialiased bilinear resize, on bf16 for every table but
    ``f32``."""
    size = (base_w // 2, base_w)
    if (feed == "box" and rgb.dtype == torch.uint8
            and rgb.shape[1] % size[0] == 0 and rgb.shape[2] % size[1] == 0):
        rb = box_feed(rgb, size)
    else:
        src = rgb01 if table == "f32" else rgb01.to(torch.bfloat16)
        rb = resize_bilinear_nhwc(src, size)
    # the route is set per call: graphs built with other routes may share
    # this net
    return pnorm.set_route(base_model, groupnorm)(rb)


def depths_of(persp_model, views, groupnorm: str = "auto",
              qconv: str = "auto"):
    """The perspective CNN on one panorama's views of a shape (n, h, w, 3),
    at multiples of 32 and back."""
    h, w = views.shape[1:3]
    nh, nw = _round32(h), _round32(w)
    if (nh, nw) != (h, w):
        views = resize_bilinear_nhwc(views, (nh, nw))
    net = set_qconv_route(pnorm.set_route(persp_model, groupnorm), qconv)
    depths = predict_depth01(net, views)
    if (nh, nw) != (h, w):
        depths = resize_bilinear(depths, (h, w))
    return depths


def _stack_if_uniform(maps):
    """Per-view (B, h, w) maps as one (B, V, h, w) tensor when they share a
    shape (one gather per stage instead of one per view), else the list."""
    if len({tuple(m.shape) for m in maps}) == 1:
        return torch.stack(maps, 1)
    return list(maps)


def full_pipeline(rgb, persp_model, base_model=None, baseline=None,
                  cfg: MergeConfig = MergeConfig(), view_width: int = 512,
                  jacobi: str = "auto", base_w: int = 512, device="cuda"):
    """RGB equirect (H, W, 3) -> (u16 (out_h, out_w), abcd, baseline, pmaps).

    Either a panoramic baseline model or a precomputed ``baseline`` map must
    be given.  The perspective CNN runs on each view resized to multiples of
    32, the baseline CNN at ``base_w`` wide: the eager stages of
    :func:`build_batched_e2e` on a batch of one.
    """
    dev = resolve_device(device)
    _, models_stage, fuse_stage = build_batched_e2e(
        persp_model, cfg, view_width=view_width, base_model=base_model,
        base_w=base_w, jacobi=jacobi, device=dev)
    args = [torch.as_tensor(rgb, device=dev)[None]]
    if baseline is not None:
        args.append(torch.as_tensor(baseline, device=dev)[None])
    bases, pmaps = models_stage.eager(*args)
    out_u16, abcd = fuse_stage.eager(bases, pmaps)
    return out_u16[0], abcd[0], bases[0], [p[0] for p in pmaps]


def load_model_checkpoint(ckpt_path: str, norm_dtype=None, device="cuda",
                          dtype=torch.bfloat16, quantize: bool = False):
    """A net and its architecture dict from a ``*.params.npz`` checkpoint and
    its ``<model>.config.json`` sidecar (``models/weights.py``).

    ``norm_dtype`` is the GroupNorm output type (f32 when None, as the JAX
    package runs off the TPU); ``dtype`` the conv compute type (bf16, as
    in JAX).  Every kind of the JAX loader is built (``weights.build_model``).
    ``quantize`` (GN perspective checkpoints only, as in JAX) returns the
    int8 graph: the trained convs quantized by ``models/quantize.py``.  The
    net is for inference: in eval mode, no parameter requiring grad (a net
    to train comes from ``weights.build_model``).
    """
    arch = weights.read_arch(ckpt_path)
    kind, variant = arch["model"], arch.get("variant", "gn")
    if quantize and not (kind == "perspective" and variant == "gn"):
        raise ValueError("int8 PTQ supports GN perspective checkpoints "
                         f"only, got {kind}/{variant}")
    model = weights.build_model(arch, dtype=dtype,
                                norm_dtype=norm_dtype or torch.float32)
    weights.load_params(model, weights.read_params_npz(ckpt_path))
    if quantize:
        model = quantize_perspective(model)
    model.requires_grad_(False)
    return model.to(resolve_device(device)).eval(), arch


def build_batched_e2e(persp_model, cfg: MergeConfig, view_width: int = 512,
                      base_model=None, base_w: int = 512,
                      extract_dtype: str = "auto", jacobi: str = "auto",
                      groupnorm: str = "auto", qconv: str = "auto",
                      device="cuda", mesh=None):
    """Batched e2e stages over (B, H, W, 3) RGB stacks (plus a (B, h, w)
    baseline stack when ``base_model`` is None).  Returns
    ``(full, models_stage, fuse_stage)``, each a ``graphs.Graphed``:
    replayed from a CUDA graph per input shape on the card (the
    counterpart of the JAX package's jitted stages), eager on the CPU, and
    eager anywhere as ``.eager``:

    - ``models_stage(rgbs[, baselines]) -> (baselines, pmaps)``: the
      baseline CNN, view extraction and the perspective CNN;
    - ``fuse_stage(baselines, pmaps) -> (out_u16, abcd)``: registration
      (one panorama at a time) and fusion (the whole batch at once, the
      counterpart of the JAX package's vmapped stage);
    - ``full(rgbs[, baselines]) -> (out_u16, baselines)``: both.

    Each net runs one panorama per call: the baseline CNN on one panorama
    (a two-branch net's cube faces are that panorama's six), the
    perspective CNN on one panorama's views of a shape.  cuDNN then sees
    the shapes of a batch of one at any batch size, and a panorama's output
    does not depend on its batch.  Inside a graph the extra launches cost
    no host time.

    ``extract_dtype`` is the views' gather table
    (:func:`_resolve_extract_dtype`); every table but ``f32`` feeds the
    baseline CNN's bilinear resize bf16, as in JAX.  The nets are moved
    to ``device``; ``groupnorm`` is the route of both
    nets' GroupNorms, ``qconv`` that of the int8 perspective graph's convs
    and ``jacobi`` that of the relaxation (``auto``: the CUDA kernels on the
    card, the plain versions on the CPU).

    With ``mesh`` (``parallel.mesh.make_mesh()``) the stages are data
    parallel over its ranks, on the rank's device (``device`` is then
    ignored): each takes the global batch, runs this rank's ``B / dp``
    rows through its graph, and gathers every output over the ranks after
    the replay (``parallel.mesh.DataParallel``).  The forward needs no
    collective, as in JAX; ``B`` must be divisible by ``dp``.
    """
    table = _resolve_extract_dtype(extract_dtype)
    dev = mesh.device if mesh is not None else resolve_device(device)
    relax = kjacobi.resolve(jacobi)
    kgroupnorm.resolve(groupnorm)
    kqconv.resolve(qconv)
    persp_model = persp_model.to(dev)
    if base_model is not None:
        base_model = base_model.to(dev)
    layout = cfg.layout
    plan = build_fusion_plan(cfg)
    groups = list(view_groups(layout, view_width).items())

    # TF32 off while a stage runs (and so while it is captured), the
    # caller's flags back after it
    @true_f32()
    def models_stage(rgbs, baselines=None):
        rgbs01 = _as01(rgbs)
        b = rgbs01.shape[0]
        if baselines is None:
            feed = base_feed()
            baselines = torch.cat([
                baseline_of(base_model, rgbs[k:k + 1], rgbs01[k:k + 1],
                            table, base_w, groupnorm, feed)
                for k in range(b)])
            debug.check("baseline net's output", baselines)
        else:
            baselines = _as01(baselines)
        # the packed tables straight from a u8 panorama, as in JAX
        src = make_table(rgbs if table in PACKED and rgbs.dtype == torch.uint8
                         else rgbs01, table)
        pmaps: List[torch.Tensor] = [None] * layout.num_views  # type: ignore
        for (h, w), idxs in groups:
            views = extract_group(src, layout.fovs[idxs], (h, w), table)
            depths = torch.stack([depths_of(persp_model, views[k], groupnorm,
                                            qconv) for k in range(b)])
            for j, i in enumerate(idxs):
                pmaps[i] = depths[:, j]
        debug.check("perspective net's output", pmaps)
        return baselines, pmaps

    @true_f32()
    def fuse_stage(baselines, pmaps):
        pm = _stack_if_uniform(pmaps)
        abcd = registration.register_views_batched(baselines, pm, cfg)
        debug.check("registration result", abcd)
        out_u16, buf = fuse_batched(baselines, pm, plan, jacobi_fn=relax,
                                    abcd=abcd)
        debug.check("fusion result", buf)
        return out_u16, abcd

    def full(*args):
        baselines, pmaps = models_stage(*args)
        out_u16, _ = fuse_stage(baselines, pmaps)
        return out_u16, baselines

    nets = (persp_model, base_model)
    stages = (graphs.Graphed(full, dev, nets, name="e2e.full", env=STAGE_ENV),
              graphs.Graphed(models_stage, dev, nets,
                             name="e2e.models_stage", env=STAGE_ENV),
              graphs.Graphed(fuse_stage, dev, name="e2e.fuse_stage"))
    if mesh is None:
        return stages
    from .parallel.mesh import DataParallel

    return tuple(DataParallel(stage, mesh) for stage in stages)


def run_batch_e2e(rgb_folder: str, gt_folder: str, result_folder: str,
                  persp_ckpt: str, cfg: MergeConfig = MergeConfig(),
                  baseline_ckpt: Optional[str] = None,
                  baseline_folder: Optional[str] = None,
                  dataset: str = "matterport", view_width=None, limit=None,
                  include=None, exclude=None, shard=None,
                  profile: bool = False, batch_size: int = 1,
                  stream: str = "auto", jacobi: str = "auto",
                  extract_dtype: str = "auto", infer_norm: str = "auto",
                  persp_int8: bool = False, base_width=None, log=print,
                  device="cuda", latency: bool = False,
                  latency_halo: int = 10):
    """The model-mode batch: RGB -> models -> registration -> fusion.

    The perspective checkpoint is mandatory; the baseline comes from a
    second checkpoint or from baseline files (the reference's naming).
    ``batch_size`` panoramas run per call of the graph, the last chunk
    padded by repetition (the padding discarded); batch k+1 is submitted
    before batch k is read back, decoding the next panoramas and writing
    PNGs overlap the device work.  Writes ``<raw>.png`` and, where a gt
    exists, ``<raw>.aligned.txt``; skips a panorama whose ``<raw>.png``
    exists.

    ``profile`` runs the models and registration+fusion as two separately
    timed graphs with a host sync between (the reference's time_Reg /
    time_Laplacian split, Main.cpp:667-681) and logs each item's split.
    ``stream`` — "on"/"off"/"auto": send integer-source inputs to the
    device at their own width (uint8 RGB, uint16 baselines) and normalize
    there; "auto" is off, the JAX package's choice off the TPU.
    ``infer_norm`` is the GroupNorm output type: ``auto`` is f32, as the
    JAX package runs off the TPU, or ``f32`` / ``bf16``.  ``persp_int8``
    runs the perspective CNN as the int8 graph (GN checkpoints only).

    ``latency`` is the single-request mode: each panorama's views are
    spread over the ranks of ``parallel.multihost.initialize`` (one
    process without it) by the view-parallel graph
    (``parallel.views.build_latency_e2e``, one per baseline shape), one
    panorama a call, the next one decoding meanwhile; ``batch_size``,
    ``jacobi`` and ``profile``'s split do not apply (logged as ignored).
    Every rank takes the same panoramas and holds each output; rank 0
    writes the files.  ``latency_halo`` is the temporal-blocking depth of
    the width-sharded Jacobi's halo exchanges.  Returns the metrics of the
    gt-scored panoramas.
    """
    if infer_norm not in ("auto", "f32", "bf16"):
        raise ValueError(f"infer_norm must be auto, f32 or bf16, "
                         f"got {infer_norm!r}")
    if stream not in ("auto", "on", "off"):
        raise ValueError(f"stream must be auto, on or off, got {stream!r}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    dev = resolve_device(device)
    norm_dtype = torch.bfloat16 if infer_norm == "bf16" else None
    persp_model, persp_arch = load_model_checkpoint(
        persp_ckpt, norm_dtype, device=dev, quantize=persp_int8)
    if view_width is None:
        # the perspective CNN's training resolution (zoo/README.md)
        view_width = persp_arch.get("view_size", 512)
    base_model, base_w = None, 512
    if baseline_ckpt:
        base_model, base_arch = load_model_checkpoint(baseline_ckpt,
                                                      norm_dtype, device=dev)
        # the fixed-width families' column decoders run at their training
        # width only (panodepth/e2e.py:519-523)
        base_w = base_width or base_arch.get("pano_width", 512)
        if base_width and base_arch.get("model") in ("hohonet", "slicenet"):
            raise SystemExit(f"--base-width: {base_arch['model']} has a "
                             f"fixed-width decoder; run it at its training "
                             f"width {base_arch.get('pano_width', 512)}")
    if latency:
        from .parallel.views import build_latency_e2e, make_vp_mesh

        mesh = make_vp_mesh(device=dev)
        if batch_size != 1:
            log("[run_batch_e2e] --latency runs one panorama per launch; "
                "ignoring --batch-size")
        if jacobi != "auto":
            log("[run_batch_e2e] --latency always relaxes with the "
                "width-sharded Jacobi; ignoring --jacobi")
        if profile:
            log("[run_batch_e2e] --latency profiles whole-graph ms only "
                "(the sharded stages fuse; no per-stage split)")
        lat_cache = {}

        def lat_fn_for(base):
            key = None if base_model is not None else tuple(base.shape[:2])
            if key not in lat_cache:
                lat_cache[key] = build_latency_e2e(
                    persp_model, cfg, mesh, view_width=view_width,
                    base_model=base_model, base_w=base_w,
                    baseline_shape=key, extract_dtype=extract_dtype,
                    halo=latency_halo)
            return lat_cache[key]
    else:
        full, models_stage, fuse_stage = build_batched_e2e(
            persp_model, cfg, view_width=view_width, base_model=base_model,
            base_w=base_w, extract_dtype=extract_dtype, jacobi=jacobi,
            device=dev)

    rgb_files = pio.filter_files(pio.list_images(rgb_folder),
                                 include, exclude, limit, shard)
    os.makedirs(result_folder, exist_ok=True)
    log(f"[run_batch_e2e] {len(rgb_files)} panoramas, on-device models, "
        + (f"view-parallel latency mode over {mesh.sp} ranks" if latency
           else f"batch {batch_size}")
        + (", profiled stages" if profile else ""))
    stream_on = stream == "on"

    def load(f):
        """Decode, keeping the source's integer width when streaming."""
        if stream_on:
            r = pio.load_image_int(f)
            if r is not None:
                return r[0]
        return pio.load_image01(f).astype(np.float32)

    def decode(f):
        raw = pio.raw_name(f)
        rgb = load(f)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        rgb = rgb[..., :3]
        base = None
        if base_model is None:
            base = load(pio.baseline_filename(baseline_folder, raw,
                                              result_folder))
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

    if latency:
        return _run_latency(todo, decode, lat_fn_for, mesh, cfg,
                            result_folder, len(rgb_files), profile, log)

    all_metrics: List[pmetrics.Metrics] = []
    models_times: List[float] = []
    fuse_times: List[float] = []
    writes = []

    def submit(chunk):
        """chunk: list of (i, raw, rgb, baseline, gt); padded to the batch
        by repeating its last item."""
        n = len(chunk)
        pad = [chunk[-1]] * (batch_size - n)
        args = [_to_device_async(np.stack([c[2] for c in chunk + pad]), dev)]
        if base_model is None:
            args.append(_to_device_async(
                np.stack([c[3] for c in chunk + pad]), dev))
        times = None
        with debug.where("panoramas " + ", ".join(c[1] for c in chunk)):
            if profile:
                t0 = time.monotonic()
                baselines, pmaps = models_stage(*args)
                _host_sync(pmaps[0][:1, :1, :1])
                t1 = time.monotonic()
                out_u16, _ = fuse_stage(baselines, pmaps)
                _host_sync(out_u16[:1, :1, :1])
                times = ((t1 - t0) * 1000 / n,
                         (time.monotonic() - t1) * 1000 / n)
            else:
                out_u16, baselines = full(*args)
        # the copies back wait for this batch only, not for the next one
        host, done = _to_host_async((out_u16[:n], baselines[:n]), dev)
        return chunk, host, done, times

    def collect(pending):
        chunk, (out_u16, bases), done, times = pending
        if done is not None:
            done.synchronize()
        out_np = out_u16.numpy()
        if times is not None:
            models_ms, fuse_ms = times
            models_times.extend([models_ms] * len(chunk))
            fuse_times.extend([fuse_ms] * len(chunk))
        for j, (i, raw, _, _, gt) in enumerate(chunk):
            writes.append(pool.submit(
                pio.save_png16, os.path.join(result_folder, raw + ".png"),
                out_np[j]))
            if gt is not None:
                m = pmetrics.paired_metrics(
                    torch.as_tensor(gt, device=dev),
                    bases[j].to(dev),
                    torch.as_tensor(out_np[j].astype(np.float32)
                                    / np.float32(65535.0), device=dev),
                    align_way=cfg.align_way, cap_depth=cfg.cap_depth,
                    zenith_range=cfg.zenith_range)
                m.save(os.path.join(result_folder, raw + ".aligned.txt"))
                m.print()
                all_metrics.append(m)
            if profile:
                log(f"{i}/{len(rgb_files)} {raw}: models {models_ms:.1f} ms, "
                    f"reg+fusion {fuse_ms:.1f} ms")

    def decoded():
        """(input shape, chunk item) of each panorama to do, the next one
        decoding on the pool while this one is batched."""
        nxt = pool.submit(decode, todo[0][1]) if todo else None
        for k, (i, _, raw) in enumerate(todo):
            rgb, base, gt = nxt.result()
            nxt = (pool.submit(decode, todo[k + 1][1])
                   if k + 1 < len(todo) else None)
            yield ((rgb.shape, rgb.dtype.str,
                    None if base is None else (base.shape, base.dtype.str)),
                   (i, raw, rgb, base, gt))

    pool = ThreadPoolExecutor(max_workers=2)
    try:
        _double_buffered(_runs(decoded(), batch_size), submit, collect)
        for job in writes:
            job.result()
    finally:
        pool.shutdown(wait=True)
    if todo:
        split = (f"time_Models_avg:{np.mean(models_times):.1f} "
                 f"time_Fuse_avg:{np.mean(fuse_times):.1f}" if profile else
                 "time_Models_avg:n/a (fused graph; use --profile) "
                 "time_Fuse_avg:n/a (fused graph; use --profile)")
        log(f"[run_batch_e2e] done: {len(todo)} panoramas, " + split)
    return all_metrics


def _run_latency(todo, decode, fn_for, mesh, cfg: MergeConfig,
                 result_folder: str, n_files: int, profile: bool, log):
    """``run_batch_e2e``'s latency loop: one panorama a call of the
    view-parallel graph on every rank, the next one decoding meanwhile;
    rank 0 writes ``<raw>.png`` and ``<raw>.aligned.txt``, every rank
    returns the metrics.  The ranks meet at a barrier when rank 0's files
    are written, so that a run after this one skips the same panoramas on
    every rank."""
    from .parallel import multihost as mh

    writer = mesh.rank == 0
    all_metrics: List[pmetrics.Metrics] = []
    times, writes = [], []
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        nxt = pool.submit(decode, todo[0][1]) if todo else None
        for k, (i, _, raw) in enumerate(todo):
            rgb, base, gt = nxt.result()
            nxt = (pool.submit(decode, todo[k + 1][1])
                   if k + 1 < len(todo) else None)
            fn = fn_for(base)
            t0 = time.monotonic()
            with debug.where("panorama " + raw):
                out_u16, _, emap = fn(rgb) if base is None else fn(rgb, base)
            out_np = out_u16.cpu().numpy()
            ms = (time.monotonic() - t0) * 1000
            times.append(ms)
            if writer:
                writes.append(pool.submit(
                    pio.save_png16, os.path.join(result_folder, raw + ".png"),
                    out_np))
            if gt is not None:
                m = pmetrics.paired_metrics(
                    torch.as_tensor(gt, device=mesh.device), emap,
                    torch.as_tensor(out_np.astype(np.float32)
                                    / np.float32(65535.0),
                                    device=mesh.device),
                    align_way=cfg.align_way, cap_depth=cfg.cap_depth,
                    zenith_range=cfg.zenith_range)
                if writer:
                    m.save(os.path.join(result_folder, raw + ".aligned.txt"))
                    m.print()
                all_metrics.append(m)
            if profile:
                log(f"{i}/{n_files} {raw}: latency e2e {ms:.1f} ms")
        for job in writes:
            job.result()
    finally:
        pool.shutdown(wait=True)
    mh.barrier("latency-written")
    if times:
        log(f"[run_batch_e2e] done: {len(times)} panoramas, "
            f"time_e2e_avg:{np.mean(times):.1f} (view-parallel)")
    return all_metrics
