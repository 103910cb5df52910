"""``panodepth_torch.models.data`` against ``panodepth.models.data`` on the
same files and seeds: pair discovery, the panoramic and perspective
batches with and without augmentation (across an epoch boundary, and with
``epochs`` ending), ``augment_batch``, and the threaded decode.

Bars: with PNG RGB files both packages decode the same integers, so every
batch is bit-equal (the views' float64 window math included).  With JPEG
RGB files the two decoders differ (the port's codec against Pillow's
libjpeg-turbo): the ROADMAP's pinned codec bar, 1.01/255 outside the
16x16 MCUs (and one pixel around) that hold a flip and 3 levels inside
them, with flips in at most 1e-3 of the pixels (tests/test_torch_stage_a.py).
"""

import os

import numpy as np
import pytest

from panodepth import io as jio
from panodepth.models import data as jdata

from panodepth_torch import io as tio
from panodepth_torch.models import data as tdata

from conftest import make_equirect

N_PAIRS = 5


def _fields(i):
    """An RGB panorama and its gt depth (64 x 128), made from seed i."""
    rng = np.random.RandomState(100 + i)
    base = make_equirect(128, 64)
    rgb = np.stack([np.roll(base, 9 * c + i, axis=1) for c in range(3)], -1)
    rgb = np.clip(rgb * 0.8 + 0.2 * rng.rand(64, 128, 3), 0, 1)
    depth = np.clip(make_equirect(128, 64) * (0.7 + 0.05 * i)
                    + 0.05 * rng.rand(64, 128), 0, 1)
    depth[20:24, 30 + 7 * i:40 + 7 * i] = 0.0  # a hole: invalid pixels
    return rgb.astype(np.float32), depth.astype(np.float32)


def _dataset(root, ext=".png", n=N_PAIRS):
    rgb_dir, gt_dir = os.path.join(root, "rgb"), os.path.join(root, "gt")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for i in range(n):
        rgb, depth = _fields(i)
        tio.save_jpg(os.path.join(rgb_dir, f"p{i}_rgb{ext}"), rgb)
        tio.save_png16(os.path.join(gt_dir, f"p{i}_depth.png"),
                       tio.to_uint16(depth))
    return rgb_dir, gt_dir


@pytest.fixture(scope="module")
def png_pairs(tmp_path_factory):
    return jdata.discover_pairs(*_dataset(str(tmp_path_factory.mktemp("p")),
                                          ".png"), dataset="stanford2d3d")


def _take(it, n):
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_discover_pairs_equal(tmp_path):
    rgb_dir, gt_dir = _dataset(str(tmp_path))
    # an RGB file without its gt, and one that is no image, are left out
    tio.save_jpg(os.path.join(rgb_dir, "orphan_rgb.png"),
                 np.zeros((4, 8, 3), np.float32))
    open(os.path.join(rgb_dir, "notes.txt"), "w").close()
    for ds, n in (("matterport", N_PAIRS), ("stanford2d3d", N_PAIRS),
                  ("replica", 0)):  # replica's gt is <raw>.pfm
        want = jdata.discover_pairs(rgb_dir, gt_dir, ds)
        assert tdata.discover_pairs(rgb_dir, gt_dir, ds) == want
        assert len(want) == n


@pytest.mark.parametrize("augment", [False, True])
def test_pano_batches_bit_equal(png_pairs, augment):
    """Five pairs at batch 2: two batches an epoch, the fifth pair left out;
    four batches cross the epoch boundary (a new shuffle)."""
    kw = dict(batch_size=2, width=64, seed=5, augment=augment)
    want = _take(jdata.pano_batches(png_pairs, **kw), 4)
    got = _take(tdata.pano_batches(png_pairs, **kw), 4)
    _equal(got, want)
    rgb, depth, valid = got[0]
    assert rgb.shape == (2, 32, 64, 3) and depth.shape == (2, 32, 64)
    assert valid.dtype == bool and valid.any() and not valid.all()


@pytest.mark.parametrize("augment", [False, True])
def test_perspective_batches_bit_equal(png_pairs, augment):
    kw = dict(batch_size=2, view_size=32, seed=7, augment=augment)
    want = _take(jdata.perspective_batches(png_pairs, **kw), 4)
    got = _take(tdata.perspective_batches(png_pairs, **kw), 4)
    _equal(got, want)
    assert got[0][0].shape == (2, 32, 32, 3) and got[0][1].std() > 0.01


@pytest.mark.parametrize("kind", ["pano", "perspective"])
def test_epochs_end_and_unshuffled(png_pairs, kind):
    if kind == "pano":
        make = lambda m, **kw: m.pano_batches(png_pairs, 2, width=64, **kw)
    else:
        make = lambda m, **kw: m.perspective_batches(png_pairs, 2,
                                                     view_size=32, **kw)
    for kw in (dict(epochs=2, seed=1), dict(epochs=1, shuffle=False)):
        want = list(make(jdata, **kw))
        got = list(make(tdata, **kw))
        assert len(got) == 2 * kw["epochs"]
        _equal(got, want)
    with pytest.raises(ValueError, match="at least batch_size"):
        next(tdata.pano_batches(png_pairs[:1], 2))


def test_augment_batch_equal_and_geometry_correct():
    rng0 = np.random.RandomState(3)
    B, H, W = 4, 8, 16
    depth = rng0.rand(B, H, W).astype(np.float32) + 0.01
    depth[:, 2:4, 5:9] = 0.0
    valid = depth >= 1e-4
    rgb = rng0.rand(B, H, W, 3).astype(np.float32)
    before = [a.copy() for a in (rgb, depth, valid)]
    for pano, seed in ((True, 7), (False, 11)):
        want = jdata.augment_batch(rgb, depth, valid,
                                   np.random.RandomState(seed), pano=pano)
        got = tdata.augment_batch(rgb, depth, valid,
                                  np.random.RandomState(seed), pano=pano)
        _equal([got], [want])
        out_rgb, out_d, out_v = got
        for i in range(B):
            # the validity pattern moved with the depth; rolls and flips
            # permute columns
            np.testing.assert_array_equal(out_v[i], out_d[i] >= 1e-4)
            np.testing.assert_array_equal(np.sort(out_d[i], axis=None),
                                          np.sort(depth[i], axis=None))
            if not pano:
                assert (np.array_equal(out_d[i], depth[i])
                        or np.array_equal(out_d[i], depth[i][:, ::-1]))
    _equal([(rgb, depth, valid)], [before])  # the inputs are untouched


def test_threaded_decode_equals_serial(tmp_path):
    rgb_dir, gt_dir = _dataset(str(tmp_path), ".jpg")
    pairs = tdata.discover_pairs(rgb_dir, gt_dir, "stanford2d3d")
    serial = tdata._load_pair_chunk(pairs, threads=1)
    pooled = tdata._load_pair_chunk(pairs, threads=8)
    assert len(serial) == len(pooled) == N_PAIRS
    for (a, b), (c, d) in zip(serial, pooled):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert a.shape == (64, 128, 3) and b.dtype == np.float32


def test_threaded_decode_names_a_failing_file(tmp_path):
    rgb_dir, gt_dir = _dataset(str(tmp_path), ".jpg")
    pairs = tdata.discover_pairs(rgb_dir, gt_dir, "stanford2d3d")
    bad = pairs[2][0]
    with open(bad, "r+b") as fp:  # keep the SOI marker, break the rest
        fp.seek(2)
        fp.write(b"\x00" * 64)
    with pytest.raises(ValueError, match=os.path.basename(bad)):
        tdata._load_pair_chunk(pairs, threads=8)
    with pytest.raises(ValueError, match=os.path.basename(bad)):
        next(tdata.pano_batches(pairs, 5, width=64, shuffle=False))


def _mcu_mask(flips):
    """Pixels of the 16x16 MCUs that hold a flip, and one pixel around."""
    h, w = flips.shape
    mh, mw = -(-h // 16), -(-w // 16)
    pad = np.zeros((mh * 16, mw * 16), bool)
    pad[:h, :w] = flips
    mcu = pad.reshape(mh, 16, mw, 16).any(axis=(1, 3))
    m = np.repeat(np.repeat(mcu, 16, 0), 16, 1)[:h, :w]
    m[1:] |= m[:-1].copy()
    m[:-1] |= m[1:].copy()
    m[:, 1:] |= m[:, :-1].copy()
    m[:, :-1] |= m[:, 1:].copy()
    return m


def test_jpeg_pano_batches_within_the_codec_bar(tmp_path):
    """The same JPEG files through both decoders: depth and valid (16-bit
    PNGs) bit-equal, the RGB within the pinned codec bar."""
    pairs = jdata.discover_pairs(*_dataset(str(tmp_path), ".jpg"),
                                 dataset="stanford2d3d")
    kw = dict(batch_size=2, width=128, seed=3, shuffle=False, epochs=1)
    want = list(jdata.pano_batches(pairs, **kw))
    got = list(tdata.pano_batches(pairs, **kw))
    flipped = total = 0
    for (gr, gd, gv), (wr, wd, wv) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gv, wv)
        diff = np.abs(gr - wr) * 255
        for k in range(gr.shape[0]):
            flips = (diff[k] > 1.01).any(-1)
            near = _mcu_mask(flips)
            assert diff[k][~near].max(initial=0) <= 1.01
            assert diff[k].max() <= 3 + 1e-3
            flipped += int(flips.sum())
            total += flips.size
    assert flipped <= 1e-3 * total, (flipped, total)
    # the JPEG decode itself: the port's io against the JAX package's
    a = tio.load_image01(pairs[0][0])
    b = jio.load_image01(pairs[0][0])
    assert np.abs(a - b).max() * 255 <= 3 + 1e-3
