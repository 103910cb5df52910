"""Training data from files: (rgb, gt) pairs in the reference's folder
layouts, decoded on host threads, assembled into numpy batches.

Counterpart of ``panodepth/models/data.py``.  Pairs are discovered with
the naming conventions of the reference's batch run (``Main.cpp:496-549``),
and two batch shapes are made:

* panoramic batches ``(rgb (B, H, W, 3), depth (B, H, W), valid (B, H,
  W))`` at ``(width / 2, width)``, nearest-resized;
* perspective batches: a random viewing window per sample, through which
  the RGB and the gt depth are gathered (float64 window math of
  :mod:`panodepth_torch.geometry` on the host), the distribution stage A
  produces at inference.

The random streams are JAX's: ``RandomState(seed)`` draws the epoch
shuffles and the windows on the caller's thread, ``RandomState(seed +
0x5EED)`` the augmentation inside the lookahead thread, in the same order,
so the same files and seeds give the same batches.  A batch's files are
decoded as JAX decodes them: where every file is a PNG, by one native
``BatchPrefetcher(files, threads=DECODE_THREADS)`` (``utils/nativeio.py``,
outside the GIL), else by the port's codecs (``io.load_image01``; their
``ctypes`` calls release the GIL) on up to :data:`DECODE_THREADS` threads.
Each sample's resize or view gather and augmentation run on those
threads.  The batches stay
numpy: the training loop copies them to the device.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import geometry
from .. import io as pio
from ..utils import nativeio

DECODE_THREADS = 8


def discover_pairs(rgb_folder: str, gt_folder: str,
                   dataset: str = "matterport") -> List[Tuple[str, str]]:
    """(rgb, gt) file pairs via the reference naming conventions; an RGB
    file without its gt file is left out."""
    pairs = []
    for f in pio.list_images(rgb_folder):
        gt = pio.gt_filename(gt_folder, pio.raw_name(f), dataset)
        if os.path.exists(gt):
            pairs.append((f, gt))
    return pairs


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64)
    return img[ys[:, None], xs[None, :]]


def _load_pair_chunk(chunk: List[Tuple[str, str]],
                     threads: int = DECODE_THREADS, prepare=None) -> list:
    """Decode a chunk of (rgb, gt) pairs, a pair per task on up to
    ``threads`` threads (1: one after another on the caller's thread); with
    ``prepare``, each task returns ``prepare(i, rgb, gt)`` of its pair i
    instead of the arrays (the per-sample work of a batch, on the same
    threads).  Where every file is a PNG, the tasks take their files from
    one native ``BatchPrefetcher`` decoding the chunk on ``threads``
    threads.  The results are those of a serial run, in the chunk's order;
    a file that fails raises, naming it."""
    files = [f for pair in chunk for f in pair]
    pf = None
    if all(f.lower().endswith(".png") for f in files):
        pf = nativeio.BatchPrefetcher(files, threads=threads)

    def load(i):
        if pf is None:
            rgb, gt = (pio.load_image01(f) for f in chunk[i])
        else:
            rgb, gt = (pio._to01(pf.get(2 * i + k)) for k in (0, 1))
        return (rgb, gt) if prepare is None else prepare(i, rgb, gt)

    n = min(threads, len(chunk))
    try:
        if n <= 1:
            return [load(i) for i in range(len(chunk))]
        with ThreadPoolExecutor(n) as pool:
            return list(pool.map(load, range(len(chunk))))
    finally:
        if pf is not None:
            pf.close()


def _prefetched(items, fn):
    """Map ``fn`` over ``items`` with one-item lookahead on a background
    thread, so decoding batch k+1 overlaps the training step on batch k."""
    with ThreadPoolExecutor(1) as ex:
        fut = None
        for item in items:
            nxt = ex.submit(fn, item)
            if fut is not None:
                yield fut.result()
            fut = nxt
        if fut is not None:
            yield fut.result()


def _to_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.stack([img] * 3, -1)
    return img[..., :3]


def _augment_draws(rng: np.random.RandomState, n: int, width: int,
                   pano: bool):
    """Each sample's (roll, flip, gain) of :func:`augment_batch`, drawn in
    JAX's order: ``randint(width)`` (pano), ``rand()``, ``uniform(0.8,
    1.2)`` per sample."""
    draws = []
    for _ in range(n):
        s = int(rng.randint(width)) if pano else 0
        draws.append((s, rng.rand() < 0.5, rng.uniform(0.8, 1.2)))
    return draws


def _augment_sample(rgb, depth, valid, draw):
    """One sample's augmentation by its draw (roll, flip, gain)."""
    s, flip, gain = draw
    if s:
        rgb, depth, valid = (np.roll(a, s, axis=1) for a in (rgb, depth,
                                                             valid))
    if flip:
        rgb, depth, valid = rgb[:, ::-1], depth[:, ::-1], valid[:, ::-1]
    return np.clip(rgb * gain, 0.0, 1.0), depth, valid


def augment_batch(rgb: np.ndarray, depth: np.ndarray, valid: np.ndarray,
                  rng: np.random.RandomState, pano: bool = False):
    """Geometry-correct training augmentation, per sample, on copies:

    * ``pano``: a circular azimuth roll (an equirect panorama is periodic
      in azimuth: the same scene from another heading);
    * a horizontal flip with p = 0.5 (a mirrored scene is a scene);
    * a photometric gain x0.8..1.2 on the RGB only, clipped to [0, 1]
      (depth does not depend on exposure).

    The spatial transforms move rgb, depth and valid together; the draws
    are JAX's, in its order (:func:`_augment_draws`).  The batch iterators
    apply the same per sample on the decoding threads.
    """
    draws = _augment_draws(rng, rgb.shape[0], rgb.shape[2], pano)
    return _stacked(_augment_sample(rgb[i], depth[i], valid[i], d)
                    for i, d in enumerate(draws))


def _stacked(samples):
    """(rgb, depth, valid) batches of per-sample triples: f32, f32, bool."""
    rgbs, depths, valids = zip(*samples)
    return (np.stack(rgbs).astype(np.float32),
            np.stack(depths).astype(np.float32), np.stack(valids))


def _epochs(pairs, batch_size, rng, shuffle, epochs):
    """The chunks of ``batch_size`` pairs of each epoch (a shuffle of
    ``rng`` each, the tail that fills no batch left out), ``epochs`` times
    or forever."""
    epoch = 0
    while epochs is None or epoch < epochs:
        order = (rng.permutation(len(pairs)) if shuffle
                 else np.arange(len(pairs)))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            yield [pairs[k] for k in order[start:start + batch_size]]
        epoch += 1


def _need(pairs, batch_size):
    if len(pairs) < batch_size:
        raise ValueError(
            f"need at least batch_size={batch_size} pairs, have {len(pairs)}")


def pano_batches(pairs: List[Tuple[str, str]], batch_size: int,
                 width: int = 512, shuffle: bool = True,
                 seed: int = 0, epochs: Optional[int] = None,
                 augment: bool = False
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Panoramic (rgb, depth, valid) batches at (width / 2, width)."""
    h, w = width // 2, width
    _need(pairs, batch_size)
    rng = np.random.RandomState(seed)
    # the augmentation stream is drawn only inside assemble (the lookahead
    # thread), the shuffle stream only on the caller's thread
    aug_rng = np.random.RandomState(seed + 0x5EED)

    def assemble(chunk):
        # the batch's augmentation drawn here, in order, applied per sample
        draws = _augment_draws(aug_rng, len(chunk), w, True) if augment \
            else None

        def prepare(i, rgb, depth):
            depth = depth if depth.ndim == 2 else depth[..., 0]
            d = _resize_nearest(depth, h, w)
            out = (_resize_nearest(_to_rgb(rgb), h, w), d, d >= 1e-4)
            return out if draws is None else _augment_sample(*out, draws[i])

        return _stacked(_load_pair_chunk(chunk, prepare=prepare))

    yield from _prefetched(_epochs(pairs, batch_size, rng, shuffle, epochs),
                           assemble)


def _sample_window(rng: np.random.RandomState):
    """A random viewing window in the reference's field-of-view regime."""
    fovx = rng.uniform(math.radians(60), math.radians(100))
    fovy = rng.uniform(math.radians(60), math.radians(100))
    azi_c = rng.uniform(0, 2 * math.pi)
    zen_c = rng.uniform(math.radians(45), math.radians(135))
    return (azi_c - fovx / 2, azi_c + fovx / 2,
            zen_c - fovy / 2, zen_c + fovy / 2)


def _gather_view(img: np.ndarray, fov, h: int, w: int,
                 nearest: bool) -> np.ndarray:
    """``img`` gathered through window ``fov`` at (h, w): float64 window
    math, a nearest tap (the RGB's rounded, the depth's truncated)."""
    win = geometry.make_window(*fov, xp=np)
    xs = (np.arange(w) + 0.5) / w
    ys = (np.arange(h) + 0.5) / h
    xg, yg = np.meshgrid(xs, ys)
    azi, zen = geometry.xy_to_spherical(win, xg, yg, xp=np)
    ih, iw = img.shape[:2]
    xi = np.clip(((azi % (2 * math.pi)) / (2 * math.pi) * (iw - 1)
                  + (0 if nearest else 0.5)).astype(np.int64), 0, iw - 1)
    yi = np.clip((zen / math.pi * (ih - 1)).astype(np.int64), 0, ih - 1)
    return img[yi, xi]


def perspective_batches(pairs: List[Tuple[str, str]], batch_size: int,
                        view_size: int = 256, shuffle: bool = True,
                        seed: int = 0, epochs: Optional[int] = None,
                        augment: bool = False
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]:
    """Perspective (rgb, depth, valid) crops of (view_size, view_size):
    each sample a random window on a panorama of the chunk, RGB and gt
    gathered through it with the geometry stage A uses."""
    _need(pairs, batch_size)
    rng = np.random.RandomState(seed)
    aug_rng = np.random.RandomState(seed + 0x5EED)

    def assemble(work):
        chunk, fovs = work
        draws = _augment_draws(aug_rng, len(chunk), view_size, False) \
            if augment else None

        def prepare(i, rgb, depth):
            depth = depth if depth.ndim == 2 else depth[..., 0]
            d = _gather_view(depth, fovs[i], view_size, view_size,
                             nearest=True)
            out = (_gather_view(_to_rgb(rgb), fovs[i], view_size, view_size,
                                nearest=False), d, d >= 1e-4)
            return out if draws is None else _augment_sample(*out, draws[i])

        return _stacked(_load_pair_chunk(chunk, prepare=prepare))

    def work_items():
        # the windows are drawn here, on the caller's thread, so that one
        # stream serves the shuffle and the windows in JAX's order
        for chunk in _epochs(pairs, batch_size, rng, shuffle, epochs):
            yield chunk, [_sample_window(rng) for _ in chunk]

    yield from _prefetched(work_items(), assemble)
