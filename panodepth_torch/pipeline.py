"""Stage A, the merge pipeline and the resumable batch loop.

Counterpart of the file mode of ``panodepth/pipeline.py``:

``extract_stage_a``   — perspective RGB views of every panorama written to
                        files, one gather per view-shape group for a batch
                        of panoramas (the reference renders them with GL,
                        ``Main.cpp:242-326``).
``merge_arrays``      — the device core (register every view -> cubic remap
                        -> multiresolution fusion -> u16), the compute of
                        ``MergeDepthMaps`` (reference ``Depth.cpp:754-930``),
                        run eagerly.
``compiled_merge``    — the same, replayed from a CUDA graph on the card
                        (``graphs.Graphed``, the counterpart of ``jax.jit``);
                        ``compiled_merge_staged`` as two graphs,
                        registration then fusion; ``compiled_merge_batched``
                        and ``compiled_merge_staged_batched`` over a batch
                        of panoramas (the counterparts of ``jax.vmap``).
``merge_depth_maps``  — file-in/file-out merge of one panorama with optional
                        gt scoring and the masked ``.res.png``/``.giv.png``
                        outputs (``Depth.cpp:933-1035``).
``merge_many``        — the streamed, double-buffered batched merge of many
                        panoramas.  Both file merges decode a panorama's
                        PNGs on the native prefetcher's threads
                        (``utils/nativeio.py``), as the JAX package does.
``run_batch``         — the dataset walker with skip-if-output-exists resume,
                        quarantine, ``manifest.json`` and rolling 5-image
                        metric reports (reference ``Main.cpp:489-685``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; if
CUDA is asked for and absent they raise.  On the CPU the compiled forms run
eagerly.
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

from . import debug, graphs
from . import io as pio
from . import metrics as pmetrics
from . import registration
from .config import MergeConfig
from .fusion import build_fusion_plan, fuse_batched
from .kernels import jacobi as kjacobi
from .ops.projection import extract_group, view_groups
from .utils import nativeio

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
    """Integer inputs -> f32 0~1 (uint8 k / 255, uint16 k / 65535); floats
    pass through.

    The merge and the e2e graph normalize before any gather: PyTorch runs
    few operations on uint16 CUDA tensors, and a cast is one of them.  The
    divisor is a tensor on the input's device: on the card PyTorch
    multiplies by the reciprocal of a Python-number divisor, which can miss
    the host decoder's k / 65535 by an ulp.
    """
    for dtype, scale in ((torch.uint8, 255.0), (torch.uint16, 65535.0)):
        if x.dtype == dtype:
            return x.to(torch.float32) / torch.full((), scale,
                                                    device=x.device)
    return x


def _merge_fn(cfg: MergeConfig, jacobi: str):
    """The merge as a pure function of device tensors over a batch: (emaps
    (B, He, We[, C]), pmaps (B, V, Hp, Wp)) -> (out_u16 (B, H, W), abcd
    (B, V, 4)).  Registration runs one panorama at a time, so a panorama's
    coefficients are the bits it gets alone (a batched Gram product may take
    another algorithm for another batch); fusion runs the whole batch at
    once, the cubic remap fused into its slab gathers (``abcd=``)."""
    relax = kjacobi.resolve(jacobi)
    plan = build_fusion_plan(cfg)

    @true_f32()
    def merge(emaps, pmaps):
        emaps, pmaps = _first_channel(_as01(emaps)), _as01(pmaps)
        abcd = registration.register_views_batched(emaps, pmaps, cfg)
        debug.check("registration result", abcd)
        out_u16, buf = fuse_batched(emaps, pmaps, plan, jacobi_fn=relax,
                                    abcd=abcd)
        debug.check("fusion result", buf)
        return out_u16, abcd

    return merge


def _staged_fns(cfg: MergeConfig, jacobi: str):
    """Registration and fusion of a batch as two pure functions:
    ``register(emaps, pmaps) -> (abcd, registered pmaps)`` and
    ``fuse_registered(emaps, registered pmaps) -> out_u16``.  Gather and
    the cubic remap commute, so the pair gives the bits of
    :func:`_merge_fn`."""
    relax = kjacobi.resolve(jacobi)
    plan = build_fusion_plan(cfg)

    @true_f32()
    def register(emaps, pmaps):
        emaps, pmaps = _first_channel(_as01(emaps)), _as01(pmaps)
        abcd = registration.register_views_batched(emaps, pmaps, cfg)
        debug.check("registration result", abcd)
        return abcd, registration.apply_cubic(pmaps, abcd[..., None, None, :])

    @true_f32()
    def fuse_registered(emaps, pmaps_reg):
        out_u16, buf = fuse_batched(_first_channel(_as01(emaps)), pmaps_reg,
                                    plan, jacobi_fn=relax)
        debug.check("fusion result", buf)
        return out_u16

    return register, fuse_registered


def _first_channel(emaps):
    """(B, He, We, C) baselines -> their first channel; (B, He, We) pass."""
    return emaps[..., 0] if emaps.dim() == 4 else emaps


def _one(fn):
    """``fn`` over a batch as a function of one panorama."""
    def one(*args):
        out = fn(*(a[None] for a in args))
        return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]

    return one


def merge_arrays(emap, pmaps, cfg: MergeConfig, jacobi: str = "auto",
                 device="cuda"):
    """Device core: baseline emap + V perspective depths -> fused u16 pano,
    run eagerly (the form the compiled ones are held against).

    ``emap`` (He, We[, C]) and ``pmaps`` (V, Hp, Wp) are numpy arrays or
    tensors of 0~1 floats (or uint16), moved to ``device``.  ``jacobi`` is
    ``auto`` (the CUDA kernel on a CUDA device, the plain version on the
    CPU), ``kernel`` or ``torch`` (the plain version).  Returns
    (out_u16 (H, W) ``torch.uint16``, abcd (V, 4)), both on ``device``.
    """
    dev = resolve_device(device)
    return _one(_merge_fn(cfg, jacobi))(torch.as_tensor(emap, device=dev),
                                        torch.as_tensor(pmaps, device=dev))


@functools.lru_cache(maxsize=32)
def compiled_merge(cfg: MergeConfig, jacobi: str = "auto", device="cuda"):
    """:func:`merge_arrays` replayed from a CUDA graph per input shape
    (``graphs.Graphed``; eager on the CPU): ``fn(emap, pmaps) -> (out_u16,
    abcd)``, the counterpart of the JAX package's cached jit."""
    return graphs.Graphed(_one(_merge_fn(cfg, jacobi)),
                          resolve_device(device), name="compiled_merge")


@functools.lru_cache(maxsize=32)
def compiled_merge_staged(cfg: MergeConfig, jacobi: str = "auto",
                          device="cuda"):
    """Registration and fusion as two graphs, ``(reg_fn, fuse_fn)``:
    ``reg_fn(emap, pmaps) -> (abcd, registered pmaps)``, ``fuse_fn(emap,
    registered pmaps) -> out_u16``.

    Used by the profiling path to report the reference's time_Reg /
    time_Laplacian split (Main.cpp:667-681); the single graph is faster
    and is the default.
    """
    dev = resolve_device(device)
    reg, fus = _staged_fns(cfg, jacobi)
    return (graphs.Graphed(_one(reg), dev, name="compiled_merge_staged.reg"),
            graphs.Graphed(_one(fus), dev, name="compiled_merge_staged.fuse"))


@functools.lru_cache(maxsize=8)
def compiled_merge_batched(cfg: MergeConfig, jacobi: str = "auto",
                           device="cuda"):
    """The merge of a batch, ``fn(emaps (B, He, We), pmaps (B, V, Hp, Wp))
    -> (out_u16 (B, H, W), abcd (B, V, 4))``, from one CUDA graph per
    shape: the counterpart of ``jax.jit(jax.vmap(merge_arrays))``.  Each
    panorama gets the bits of its batch-1 merge."""
    return graphs.Graphed(_merge_fn(cfg, jacobi), resolve_device(device),
                          name="compiled_merge_batched")


@functools.lru_cache(maxsize=8)
def compiled_merge_staged_batched(cfg: MergeConfig, jacobi: str = "auto",
                                  device="cuda"):
    """Batched registration and fusion as two graphs: the profiling
    counterpart of :func:`compiled_merge_batched` (a host sync between the
    stages yields the time_Reg / time_Laplacian split, Main.cpp:667-681)."""
    dev = resolve_device(device)
    reg, fus = _staged_fns(cfg, jacobi)
    return (graphs.Graphed(reg, dev, name="compiled_merge_staged_batched.reg"),
            graphs.Graphed(fus, dev,
                           name="compiled_merge_staged_batched.fuse"))


def _host_sync(x):
    """Wait for ``x`` (and the work before it) by copying it to the host."""
    return x.cpu()


def _to_device_async(arr: np.ndarray, dev: torch.device):
    """A host array as a tensor that a graph's input copy can read without
    blocking: pinned on the card's host, as it is on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.pin_memory() if dev.type == "cuda" else t


def _runs(keyed, size: int):
    """Lists of up to ``size`` consecutive items of one key, from an
    iterable of (key, item) pairs: a batch ends when it is full or the key
    (the input shape) changes."""
    batch, cur = [], None
    for key, item in keyed:
        if batch and (key != cur or len(batch) == size):
            yield batch
            batch = []
        cur = key
        batch.append(item)
    if batch:
        yield batch


def _double_buffered(batches, submit, collect):
    """``submit(batch)`` for each batch, and ``collect`` of a batch's
    result only after the next batch is submitted, so the host's work on
    batch k overlaps the device's on batch k+1."""
    pending = None
    for batch in batches:
        submitted = submit(batch)
        if pending is not None:
            collect(pending)
        pending = submitted
    if pending is not None:
        collect(pending)


def _to_host_async(tensors, dev: torch.device):
    """Start the device-to-host copies of ``tensors`` behind the work queued
    so far; returns (host tensors, an event to wait on or None)."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    done = None
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
    return host, done


def _load_inputs(baseline_filename, pmap_filenames):
    """Decode the baseline and every view (the reference loads them
    synchronously, Depth.cpp:754-787): all PNGs on the native prefetcher's
    threads, else one after another (``io.load_image01``, where a PFM's
    0~1 mapping lives).  The same arrays either way."""
    files = [baseline_filename] + list(pmap_filenames)
    if all(f.lower().endswith(".png") for f in files):
        with nativeio.BatchPrefetcher(files, threads=8) as pf:
            imgs = [pio._to01(pf.get(i)) for i in range(len(files))]
        return imgs[0], imgs[1:]
    return (pio.load_image01(baseline_filename),
            [pio.load_image01(f) for f in pmap_filenames])


@dataclasses.dataclass
class MergeOutput:
    out_u16: np.ndarray
    abcd: np.ndarray
    metrics: Optional[pmetrics.Metrics]
    # per-item registration time; None when the stages ran as one graph
    # and the split is not observable (reported as unavailable rather than
    # 0; the reference prints a real split, Main.cpp:667-681)
    time_reg_ms: Optional[int]
    time_fusion_ms: int


def _score(out_filename, out_u16, emap, gt_filename, cfg, dev):
    """Metrics against the gt file (None without one) and the masked
    variants."""
    if not (gt_filename and os.path.exists(gt_filename)):
        return None
    gt = pio.load_image01(gt_filename)
    metrics = pmetrics.paired_metrics(
        torch.as_tensor(gt, device=dev), torch.as_tensor(emap, device=dev),
        torch.as_tensor(out_u16.astype(np.float32) / np.float32(65535.0),
                        device=dev),
        align_way=cfg.align_way, cap_depth=cfg.cap_depth,
        zenith_range=cfg.zenith_range,
    )
    _save_masked_variants(out_filename, out_u16, emap, gt, cfg)
    return metrics


def merge_depth_maps(
    baseline_filename: str,
    pmap_filenames: List[str],
    out_filename: str,
    cfg: MergeConfig,
    gt_filename: Optional[str] = None,
    jacobi: str = "auto",
    profile: bool = False,
    device="cuda",
) -> MergeOutput:
    """File-level merge of one panorama (MergeDepthMaps parity).

    By default registration and fusion run as one graph
    (:func:`compiled_merge`), whose time (host clock around work that ends
    in a device-to-host copy) is attributed to fusion, the dominant stage.
    With ``profile=True`` the two stages run as separate graphs with a host
    sync between, filling the reference's time_Reg / time_Laplacian split
    (Main.cpp:667-681) at a small pipelining cost.
    """
    dev = resolve_device(device)
    emap, views = _load_inputs(baseline_filename, pmap_filenames)
    shapes = {v.shape for v in views}
    if len(shapes) != 1:
        raise ValueError(f"perspective maps disagree in shape: {shapes}")
    pmaps = np.stack([v if v.ndim == 2 else v[..., 0] for v in views])

    if profile:
        reg_fn, fuse_fn = compiled_merge_staged(cfg, jacobi, dev)
        t0 = time.monotonic()
        abcd, pmaps_reg = reg_fn(emap, pmaps)
        abcd = _host_sync(abcd).numpy()
        t1 = time.monotonic()
        out_u16 = fuse_fn(emap, pmaps_reg).cpu().numpy()
        t2 = time.monotonic()
        reg_ms, fus_ms = int((t1 - t0) * 1000), int((t2 - t1) * 1000)
    else:
        t0 = time.monotonic()
        out_u16, abcd = compiled_merge(cfg, jacobi, dev)(emap, pmaps)
        out_u16 = out_u16.cpu().numpy()
        abcd = abcd.cpu().numpy()
        reg_ms, fus_ms = None, int((time.monotonic() - t0) * 1000)

    pio.save_png16(out_filename, out_u16)
    metrics = _score(out_filename, out_u16, emap, gt_filename, cfg, dev)
    return MergeOutput(out_u16, abcd, metrics, reg_ms, fus_ms)


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
        return (batch,) + _to_host_async(fn(rgbs), dev)

    def collect(pending):
        batch, host, done = pending
        if done is not None:
            done.synchronize()
        for g, (_, idxs) in enumerate(groups):
            arr = host[g].numpy()  # (B, |idxs|, h, w, C)
            for bi, (_, outs) in enumerate(batch):
                for j, vi in enumerate(idxs):
                    pio.save_jpg(outs[vi], arr[bi, j])

    def loaded():
        for f, outs in todo:
            rgb = pio.load_image01(f)
            if rgb.ndim == 2:
                rgb = np.stack([rgb] * 3, -1)
            rgb = rgb[..., :3]
            yield rgb.shape, (rgb, outs)

    _double_buffered(_runs(loaded(), batch_size), submit, collect)
    return len(todo)


def merge_many(
    items,
    cfg: MergeConfig,
    batch_size: int = 4,
    jacobi: str = "auto",
    log=print,
    profile: bool = False,
    stream_u16: str = "auto",
    device="cuda",
):
    """Streamed batched merge of many panoramas.

    ``items`` — list of dicts with keys ``baseline``, ``pmaps`` (list of
    filenames), ``out``, and optional ``gt``.  Consecutive items of one
    input shape form device batches of ``batch_size`` (a batch ends early
    where the shape changes; a short batch is padded by repeating its last
    item, and the padding is neither written nor scored).  Each batch is
    decoded only when it is about to be submitted, and batch k+1 is decoded
    and submitted before batch k is read back, so the host's reads, writes
    and metrics overlap the device's work, and the host holds at most two
    batches of inputs; the inputs go to the device from pinned memory.
    Returns a list of :class:`MergeOutput` in input order; an item whose
    inputs fail to load gets None and is reported via ``log``.

    With ``profile=True`` registration and fusion run as separate graphs
    with a host sync after each, so each item carries a real time_Reg /
    time_Laplacian split (and the batches do not overlap); otherwise the
    split is unavailable (``time_reg_ms=None``).

    ``stream_u16`` — "on"/"off"/"auto": send integer-source inputs to the
    device as uint16 (half the host-to-device bytes) and normalize there.
    "auto" is off, the JAX package's choice off the TPU.  The device's
    k / 65535 is a true division, so "on" gives the bits of "off".
    """
    if stream_u16 not in ("auto", "on", "off"):
        raise ValueError(f"stream_u16 must be auto, on or off, got "
                         f"{stream_u16!r}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    dev = resolve_device(device)
    results: List[Optional[MergeOutput]] = [None] * len(items)

    def loaded():
        for i, it in enumerate(items):
            try:
                emap, views = _load_inputs(it["baseline"], it["pmaps"])
                pm = np.stack([v if v.ndim == 2 else v[..., 0]
                               for v in views])
                emap = emap if emap.ndim == 2 else emap[..., 0]
                # integer-source inputs stream as uint16; k/255 and k/65535
                # round-trip the u16 re-quantization exactly, so only float
                # PFMs are excluded
                files = [it["baseline"]] + list(it["pmaps"])
                if stream_u16 == "on" and not any(
                        f.lower().endswith(".pfm") for f in files):
                    emap = np.round(emap * 65535.0).astype(np.uint16)
                    pm = np.round(pm * 65535.0).astype(np.uint16)
            except (FileNotFoundError, ValueError, OSError) as e:
                log(f"[merge_many] item {i} FAILED ({e}); quarantined")
                continue
            yield (emap.shape, pm.shape, pm.dtype.str), (i, emap, pm)

    if profile:
        reg_fn, fuse_fn = compiled_merge_staged_batched(cfg, jacobi, dev)
    else:
        fn = compiled_merge_batched(cfg, jacobi, dev)

    def submit(chunk):
        n = len(chunk)
        pad = [chunk[-1]] * (batch_size - n)  # to the captured batch shape
        emaps = np.stack([c[1] for c in chunk + pad])
        pmaps = np.stack([c[2] for c in chunk + pad])
        emaps_h, pmaps_h = (_to_device_async(emaps, dev),
                            _to_device_async(pmaps, dev))
        t0 = time.monotonic()
        times = None
        names = ", ".join(os.path.basename(items[c[0]]["out"])
                          for c in chunk)
        with debug.where(f"panoramas {names}"):
            if profile:
                abcd, pmaps_reg = reg_fn(emaps_h, pmaps_h)
                _host_sync(abcd)
                t1 = time.monotonic()
                out_u16 = _host_sync(fuse_fn(emaps_h, pmaps_reg))
                times = (int((t1 - t0) * 1000 / n),
                         int((time.monotonic() - t1) * 1000 / n))
            else:
                out_u16, abcd = fn(emaps_h, pmaps_h)
        # the copies back wait for this batch only, not for the next one
        host, done = _to_host_async((out_u16, abcd), dev)
        return chunk, emaps, host, done, t0, times

    def collect(pending):
        chunk, emaps, (out_u16, abcd), done, t0, times = pending
        if done is not None:
            done.synchronize()
        out_u16, abcd = out_u16.numpy(), abcd.numpy()
        reg_ms, ms = times or (None, int((time.monotonic() - t0) * 1000
                                         / len(chunk)))
        if emaps.dtype == np.uint16:  # undo the streaming quantization
            emaps = emaps.astype(np.float32) / np.float32(65535.0)
        for j, (i, _, _) in enumerate(chunk):
            it = items[i]
            pio.save_png16(it["out"], out_u16[j])
            metrics = _score(it["out"], out_u16[j], emaps[j], it.get("gt"),
                             cfg, dev)
            results[i] = MergeOutput(out_u16[j], abcd[j], metrics, reg_ms, ms)

    _double_buffered(_runs(loaded(), batch_size), submit, collect)
    return results


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
    profile: bool = False,
    batch_size: int = 1,
    stream: str = "auto",
    jacobi: str = "auto",
    device="cuda",
) -> List[pmetrics.Metrics]:
    """Batch loop (CreateDepthPanoramas parity, Main.cpp:329-689).

    Stage A extracts perspective RGB views of every panorama into
    ``views_folder`` (unless ``extract_rgb_views`` is False), batching at
    least 4 panoramas per gather; an external depth model is expected to
    turn those into perspective depth maps with the same names; stage C
    merges whatever the folder holds under the layout's names: one
    panorama after another through :func:`merge_depth_maps`, or with
    ``batch_size > 1`` through :func:`merge_many` (``stream`` is its
    ``stream_u16``).  ``profile`` splits registration from fusion in time.
    Already-produced results are skipped, which makes the batch resumable
    per panorama (Main.cpp:554-563); a panorama whose inputs fail to load
    is quarantined and the batch goes on.  ``limit``/``include``/
    ``exclude``/``shard`` are the runtime form of the reference's
    compile-time selection blocks (Main.cpp:357-407).  ``manifest.json``
    records the completed, skipped and quarantined items with their times.
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
    reg_times: List[int] = []
    fusion_times: List[int] = []
    completed, skipped, quarantined = [], [], []

    todo = []
    for i, f in enumerate(rgb_files):
        raw = pio.raw_name(f)
        out_file = os.path.join(result_folder, raw + ".png")
        if os.path.exists(out_file):
            log(f"{i}/{len(rgb_files)} skip!")
            skipped.append(raw)
            continue
        todo.append(dict(
            index=i, raw=raw, out=out_file,
            baseline=pio.baseline_filename(baseline_folder, raw,
                                           result_folder),
            gt=pio.gt_filename(gt_folder, raw, dataset),
            pmaps=pio.pmap_filenames(views_folder, raw, layout, ext=pmap_ext),
        ))

    def record(i, raw, res):
        completed.append(raw)
        if res.time_reg_ms is not None:
            reg_times.append(res.time_reg_ms)
        fusion_times.append(res.time_fusion_ms)
        if res.metrics is not None:
            res.metrics.save(os.path.join(result_folder, raw + ".aligned.txt"))
            all_metrics.append(res.metrics)
            res.metrics.print()
        if all_metrics and (i == len(rgb_files) - 1
                            or (i > 0 and i % REPORT_EVERY == 0)):
            _rolling_report(all_metrics, reg_times, fusion_times, log)

    if batch_size > 1:
        results = merge_many(todo, cfg, batch_size=batch_size, jacobi=jacobi,
                             log=log, profile=profile, stream_u16=stream,
                             device=dev)
        for it, res in zip(todo, results):
            if res is None:
                quarantined.append({"name": it["raw"], "error": "load/merge"})
            else:
                record(it["index"], it["raw"], res)
    else:
        for it in todo:
            i, raw = it["index"], it["raw"]
            try:
                with debug.where(f"panorama {raw}"):
                    res = merge_depth_maps(it["baseline"], it["pmaps"],
                                           it["out"], cfg, it["gt"],
                                           jacobi=jacobi, profile=profile,
                                           device=dev)
            except (FileNotFoundError, ValueError, OSError) as e:
                log(f"{i}/{len(rgb_files)} FAILED ({e}); quarantined, "
                    "continuing")
                quarantined.append({"name": raw, "error": str(e)})
                continue
            record(i, raw, res)

    mname = ("manifest.json" if shard is None
             else f"manifest.{shard.replace('/', '-of-')}.json")
    with open(os.path.join(result_folder, mname), "w") as fp:
        json.dump({
            "completed": completed,
            "skipped": skipped,
            "quarantined": quarantined,
            "time_reg_ms": reg_times,
            "time_fusion_ms": fusion_times,
            "stage_a_ms": stage_a_ms,
            "config": {"layout": cfg.layout_name,
                       "out_width": cfg.out_width},
        }, fp, indent=1)
    return all_metrics


def _rolling_report(ms: List[pmetrics.Metrics], reg, fus, log):
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
    reg_avg = (f"{sum(reg) / len(reg):.1f}" if reg
               else "n/a (fused graph; use --profile)")
    if fus:
        log(f"time_Reg_avg:{reg_avg}"
            f" time_Laplacian_avg:{sum(fus) / len(fus):.1f}")
    log("-" * 10)
