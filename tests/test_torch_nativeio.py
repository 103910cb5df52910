"""The port's native PNG codec and prefetcher
(``panodepth_torch/utils/nativeio.py`` over ``csrc/pngio.cpp``).

The library is built here with g++ and zlib, as on the card's host.  Its
decodes are held bit-equal to the Python twin (``io.read_png_py``) on
files whose rows carry every filter, written here row by row, on Pillow's
files and on the port's own; ``load_image01`` is held to the JAX
package's (its Pillow route, the JAX library being unbuilt).  Its files
decode to their input under the twin and Pillow, and equal the twin's
bytes where both run one zlib.  Every file the twin refuses, and 1/2/4-bit
files, are refused with a ValueError naming the file.  The prefetcher's
contract, ``read_image_f32`` on PFMs, the file paths of the merge and the
trainer on both routes, and the build's hash are checked too.
"""

import os
import shutil
import struct
import time
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from panodepth import io as jio

from panodepth_torch import io as tio
from panodepth_torch import pipeline as tpipeline
from panodepth_torch.kernels import _build
from panodepth_torch.models import data as tdata
from panodepth_torch.utils import nativeio

from torch_port_common import tiny_scene

torch.set_num_threads(1)  # xdist runs several workers on a few cores

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filtered(raw, bpp, kinds):
    """Rows of unfiltered bytes ``raw`` (H, stride) with row y filtered by
    ``kinds[y % len(kinds)]``, each prefixed by its filter byte."""
    x = raw.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :x.shape[1] - bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :x.shape[1] - bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    for y in range(x.shape[0]):
        k = kinds[y % len(kinds)]
        out[y, 0] = k
        out[y, 1:] = (x[y] - preds[k][y]) & 0xFF
    return out


def _png(arr, kinds=(2,), parts=1, header=None, data=None):
    """A PNG of ``arr`` (uint8 / uint16, (H, W) or (H, W, C)) with the row
    filters ``kinds``, its IDAT split into ``parts`` chunks; ``header``
    overrides IHDR's fields, ``data`` the inflated image data."""
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    h, w = arr.shape[:2]
    raw = arr.astype(">u2" if depth == 16 else np.uint8).view(np.uint8)
    raw = raw.reshape(h, -1)
    if data is None:
        data = _filtered(raw, channels * depth // 8, kinds).tobytes()
    z = zlib.compress(data, 6)
    cuts = np.linspace(0, len(z), parts + 1).astype(int)
    fields = dict(dict(w=w, h=h, depth=depth, colour=_COLOUR[channels],
                       interlace=0), **(header or {}))
    ihdr = struct.pack(">IIBBBBB", fields["w"], fields["h"], fields["depth"],
                       fields["colour"], 0, 0, fields["interlace"])
    return (_SIG + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(b"IDAT", z[c0:c1])
                       for c0, c1 in zip(cuts[:-1], cuts[1:]))
            + _chunk(b"IEND", b""))


def _image(dtype, channels, shape, seed):
    rng = np.random.RandomState(seed)
    hi = 65536 if dtype == np.uint16 else 256
    full = shape if channels == 1 else (*shape, channels)
    return rng.randint(0, hi, full).astype(dtype)


FILTERS = [(0, 1, 2, 3, 4), (4,), (3,), (1, 4, 3)]


@pytest.mark.parametrize("kinds", FILTERS, ids=lambda k: "f" + "".join(
    map(str, k)))
@pytest.mark.parametrize("shape", [(7, 13), (5, 1), (1, 9), (16, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16],
                         ids=["u8", "u16"])
def test_decode_equals_the_twin_and_jax(tmp_path, dtype, channels, shape,
                                        kinds):
    arr = _image(dtype, channels, shape, seed=channels * 100 + shape[1])
    parts = 1 + (shape[0] + len(kinds)) % 3
    f = tmp_path / "f.png"
    f.write_bytes(_png(arr, kinds, parts))
    got = nativeio.decode_png(str(f))
    twin = tio.read_png_py(str(f))
    assert got.dtype == twin.dtype == dtype
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(nativeio.decode_png(f.read_bytes()), got)
    np.testing.assert_array_equal(tio.read_png(str(f)), got)
    loaded = tio.load_image01(str(f))
    assert loaded.dtype == np.float32
    np.testing.assert_array_equal(loaded, tio._to01(twin))
    if dtype == np.uint8 or channels == 1:  # Pillow keeps 16 bits for gray
        np.testing.assert_array_equal(loaded, jio.load_image01(str(f)))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_pillow_written_files(tmp_path, mode, optimize):
    rng = np.random.RandomState(len(mode))
    if mode == "I;16":
        arr = np.cumsum(rng.randint(0, 900, (23, 41)), axis=1).astype(
            np.uint16)
        img = Image.fromarray(arr)
    else:
        c = len(mode)
        shape = (23, 41) if c == 1 else (23, 41, c)
        # smooth rows make Pillow's adaptive filter pick every kind
        arr = (np.cumsum(rng.randint(0, 9, shape), axis=1) % 256).astype(
            np.uint8)
        img = Image.fromarray(arr, mode)
    f = tmp_path / "p.png"
    img.save(f, optimize=optimize)
    got = nativeio.decode_png(str(f))
    np.testing.assert_array_equal(got, tio.read_png_py(str(f)))
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(tio.load_image01(str(f)),
                                  jio.load_image01(str(f)))


def test_jax_written_files_load_like_the_jax_package(tmp_path):
    rng = np.random.RandomState(3)
    u16 = np.cumsum(rng.randint(0, 300, (40, 70)), axis=1).astype(np.uint16)
    f = str(tmp_path / "j.png")
    jio.save_png16(f, u16)
    np.testing.assert_array_equal(nativeio.decode_png(f), u16)
    np.testing.assert_array_equal(tio.load_image01(f), jio.load_image01(f))
    np.testing.assert_array_equal(nativeio.read_image_f32(f),
                                  jio.load_image01(f))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("kind", ["u8 gray", "u8 rgb", "u16 gray",
                                  "u16 rgb"])
def test_encode_round_trips(tmp_path, kind, level):
    dtype = np.uint16 if kind.startswith("u16") else np.uint8
    arr = _image(dtype, 3 if kind.endswith("rgb") else 1, (19, 27),
                 seed=level)
    data = nativeio.encode_png(arr, level)
    assert data == tio.png_bytes(arr, level)
    np.testing.assert_array_equal(tio.read_png_py("e", data), arr)
    np.testing.assert_array_equal(nativeio.decode_png(data), arr)
    f = tmp_path / "e.png"
    nativeio.write_png(str(f), arr, level)
    assert f.read_bytes() == data
    if dtype == np.uint8 or kind == "u16 gray":
        np.testing.assert_array_equal(np.asarray(Image.open(f)), arr)


def test_encode_bytes_equal_the_twins_under_one_zlib(tmp_path):
    lib_zlib = nativeio.zlib_info()["version"]
    if lib_zlib != zlib.ZLIB_RUNTIME_VERSION:
        pytest.skip(f"the library runs zlib {lib_zlib}, Python's zlib module "
                    f"{zlib.ZLIB_RUNTIME_VERSION}: deflate's bytes may differ")
    rng = np.random.RandomState(7)
    smooth = np.cumsum(rng.randint(0, 200, (64, 96)), axis=0).astype(
        np.uint16)
    for arr, level in ((smooth, 1), (smooth, 6), (_image(np.uint8, 3, (9, 12),
                                                         1), 6),
                       (_image(np.uint8, 1, (1, 5), 2), 9)):
        assert nativeio.encode_png(arr, level) == tio.png_bytes_py(arr, level)
    f = str(tmp_path / "s.png")
    tio.save_png16(f, smooth)
    with open(f, "rb") as fp:
        assert fp.read() == tio.png_bytes_py(smooth, tio.png_level())
    nativeio.write_png16(f, smooth.astype(np.int64), level=1)
    with open(f, "rb") as fp:
        assert fp.read() == tio.png_bytes_py(smooth, 1)
    # big-endian samples and strided views encode as their values
    assert nativeio.encode_png(smooth.astype(">u2"), 1) == \
        tio.png_bytes_py(smooth, 1)
    assert nativeio.encode_png(smooth[:, ::2], 1) == \
        tio.png_bytes_py(np.ascontiguousarray(smooth[:, ::2]), 1)


def test_encode_refuses_what_png_bytes_does_not_take():
    with pytest.raises(ValueError, match="uint8 or uint16"):
        nativeio.encode_png(np.zeros((3, 4), np.float32), 1)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        nativeio.encode_png(np.zeros((3, 4, 4), np.uint8), 1)
    with pytest.raises(ValueError, match="deflate level"):
        nativeio.encode_png(np.zeros((3, 4), np.uint8), 42)
    with pytest.raises(zlib.error):
        tio.png_bytes_py(np.zeros((3, 4), np.uint8), 42)
    with pytest.raises(ValueError, match="2-D"):
        nativeio.write_png16("x.png", np.zeros((2, 3, 3), np.uint16))


def _refused_files():
    """(label, bytes) of files the decoders refuse, and the words the
    native decoder's message has."""
    good = _png(_image(np.uint8, 1, (6, 8), 0), (0, 4))
    gray = _image(np.uint8, 1, (6, 8), 1)
    ihdr_at = 8
    idat_at = ihdr_at + 25
    lying = bytearray(good)
    lying[idat_at:idat_at + 4] = struct.pack(">I", 0xFFFFFF)
    bad_crc = bytearray(good)
    bad_crc[idat_at + 10] ^= 0xFF
    bad_filter = _png(gray, data=bytes([5] + [0] * 8) * 6)
    return [
        ("lying IDAT length", bytes(lying), "truncated"),
        ("IHDR only, absurd size", _SIG + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 1 << 30, 1 << 30, 8, 0, 0, 0, 0)), "truncated"),
        ("absurd size with a small IDAT", _png(gray, header=dict(
            w=1 << 30, h=1 << 30)), "cannot hold"),
        ("junk", b"definitely not a png, far beyond 33 bytes....",
         "not a PNG"),
        ("bad CRC", bytes(bad_crc), "CRC"),
        ("cut in IDAT", good[:-20], "truncated"),
        ("cut in the signature", good[:5], "not a PNG"),
        ("no IEND", good[:-12], "truncated"),
        ("no IHDR", _SIG + _chunk(b"IEND", b""), "without IHDR"),
        ("interlaced", _png(gray, header=dict(interlace=1)), "unsupported"),
        ("1-bit", _png(gray, header=dict(depth=1)), "unsupported"),
        ("2-bit", _png(gray, header=dict(depth=2)), "unsupported"),
        ("4-bit", _png(gray, header=dict(depth=4)), "unsupported"),
        ("colour type 5", _png(gray, header=dict(colour=5)), "unsupported"),
        ("short data", _png(gray, data=bytes(9 * 5)), "expected"),
        ("long data", _png(gray, data=bytes(9 * 7)), "expected"),
        ("corrupt stream", _SIG + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 8, 6, 8, 0, 0, 0, 0)) + _chunk(b"IDAT", b"x" * 40)
         + _chunk(b"IEND", b""), "corrupt"),
        ("bad row filter", bad_filter, "row filter"),
    ]


@pytest.mark.parametrize("label,data,words", _refused_files(),
                         ids=[r[0] for r in _refused_files()])
def test_refusals_name_the_file(tmp_path, label, data, words):
    f = tmp_path / "refused.png"
    f.write_bytes(data)
    with pytest.raises(ValueError, match=words) as e:
        nativeio.decode_png(str(f))
    assert str(f) in str(e.value)
    with pytest.raises(ValueError, match="request body"):
        nativeio.decode_png(data, "request body")
    with pytest.raises(ValueError):
        tio.read_png(str(f))
    with pytest.raises((ValueError, struct.error)):
        tio.read_png_py(str(f))


def test_palette_refused_like_the_twin(tmp_path):
    f = tmp_path / "p.png"
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)).convert(
        "P").save(f)
    for read in (nativeio.decode_png, tio.read_png_py):
        with pytest.raises(ValueError, match="unsupported PNG"):
            read(str(f))


def test_unreadable_files_raise_os_errors(tmp_path):
    missing = str(tmp_path / "missing.png")
    with pytest.raises(FileNotFoundError) as e:
        nativeio.decode_png(missing)
    assert e.value.filename == missing
    with pytest.raises(FileNotFoundError):
        tio.load_image01(missing)
    with pytest.raises(IsADirectoryError):
        nativeio.decode_png(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        nativeio.write_png(str(tmp_path / "no" / "x.png"),
                           np.zeros((2, 2), np.uint8), 1)


def _files(tmp_path, n, kinds=(4,)):
    out = []
    for i in range(n):
        arr = _image(np.uint16, 1, (9 + i, 11), seed=i)
        f = tmp_path / f"v{i}.png"
        f.write_bytes(_png(arr, kinds))
        out.append(str(f))
    return out


def test_prefetcher_gives_serial_decodes_in_order(tmp_path):
    files = _files(tmp_path, 12)
    jpg = str(tmp_path / "rgb.png")  # a JPEG under a PNG name, as io reads
    jio.save_jpg(jpg.replace(".png", ".jpg"), np.random.RandomState(0).rand(
        16, 24, 3))
    shutil.move(jpg.replace(".png", ".jpg"), jpg)
    files.insert(5, jpg)
    with nativeio.BatchPrefetcher(files, threads=4) as pf:
        assert len(pf) == len(files)
        got = [pf.get(i) for i in reversed(range(len(files)))][::-1]
    for f, g in zip(files, got):
        want = tio.read_image(f)
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)
        if f != jpg:
            np.testing.assert_array_equal(g, tio.read_png_py(f))


def test_prefetcher_errors_stay_with_their_item(tmp_path):
    files = _files(tmp_path, 5)
    files[2] = str(tmp_path / "missing.png")
    (tmp_path / "junk.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)
    files[4] = str(tmp_path / "junk.png")
    pf = nativeio.BatchPrefetcher(files, threads=3)
    try:
        np.testing.assert_array_equal(pf.get(0), tio.read_png_py(files[0]))
        with pytest.raises(FileNotFoundError) as e:
            pf.get(2)
        assert e.value.filename == files[2]
        np.testing.assert_array_equal(pf.get(3), tio.read_png_py(files[3]))
        with pytest.raises(ValueError, match="junk.png"):
            pf.get(4)
        with pytest.raises(ValueError, match="taken already"):
            pf.get(0)
        with pytest.raises(IndexError):
            pf.get(5)
        np.testing.assert_array_equal(pf.get(1), tio.read_png_py(files[1]))
    finally:
        pf.close()
    pf.close()  # twice is fine
    with pytest.raises(ValueError, match="closed"):
        pf.get(1)


def test_prefetcher_close_before_any_get_returns_promptly(tmp_path):
    big = np.random.RandomState(0).randint(0, 65536, (512, 512)).astype(
        np.uint16)
    f = tmp_path / "big.png"
    f.write_bytes(_png(big, (4,)))
    t0 = time.monotonic()
    pf = nativeio.BatchPrefetcher([str(f)] * 4000, threads=2)
    pf.close()
    # two workers finish the file each has started and take no other: a
    # run of all 4000 would take seconds
    assert time.monotonic() - t0 < 1.0
    with nativeio.BatchPrefetcher([], threads=8) as empty:
        assert len(empty) == 0


def test_prefetcher_threads_follow_the_affinity(tmp_path, monkeypatch):
    files = _files(tmp_path, 6)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    assert nativeio._ncpu() == 1
    with nativeio.BatchPrefetcher(files, threads=8) as pf:
        assert pf.threads == 1
        np.testing.assert_array_equal(pf.get(5), tio.read_png_py(files[5]))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2})
    assert nativeio._ncpu() == 3
    with nativeio.BatchPrefetcher(files, threads=8) as pf:
        assert pf.threads == 3
    with nativeio.BatchPrefetcher(files[:2], threads=8) as pf:
        assert pf.threads == 2


@pytest.mark.parametrize("kind,endian", [(b"Pf", "<"), (b"Pf", ">"),
                                         (b"PF", "<"), (b"PF", ">")])
def test_read_image_f32_reads_pfm_as_load_pfm(tmp_path, kind, endian):
    rng = np.random.RandomState(len(endian))
    shape = (5, 7) if kind == b"Pf" else (5, 7, 3)
    img = (rng.rand(*shape).astype(np.float32) - 0.3) * 9
    f = str(tmp_path / "x.pfm")
    with open(f, "wb") as fp:
        fp.write(kind + b"\n7 5\n" + (b"-1.0" if endian == "<" else b"1.0")
                 + b"\n" + img.astype(endian + "f4").tobytes() + b"tail")
    got = nativeio.read_image_f32(f)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, tio.load_pfm(f))
    np.testing.assert_array_equal(got, img)


def _scene_files(root, kinds, serial=False):
    """test2's scene at 64 wide as u16 PNG files filtered with ``kinds``:
    the baseline and the views; the arrays the Python twin decodes.  With
    ``serial``, the last file is named ``.jpg`` (a PNG all the same, as
    ``io.read_image`` tells files by their bytes), which takes a load off
    the prefetcher's route."""
    sc = tiny_scene()
    os.makedirs(root, exist_ok=True)
    maps = [sc["emap"]] + list(sc["pmaps"])
    files = []
    for i, m in enumerate(maps):
        last = serial and i == len(maps) - 1
        f = os.path.join(root, f"m{i}.{'jpg' if last else 'png'}")
        with open(f, "wb") as fp:
            fp.write(_png(tio.to_uint16(m), kinds))
        files.append(f)
    return sc, files, [tio._to01(tio.read_png_py(f)) for f in files]


class _Counting(nativeio.BatchPrefetcher):
    made = 0

    def __init__(self, *a, **k):
        type(self).made += 1
        super().__init__(*a, **k)


@pytest.mark.parametrize("route", ["prefetcher", "serial"])
def test_load_inputs_routes(tmp_path, monkeypatch, route):
    _, files, want = _scene_files(str(tmp_path), (4, 3),
                                  serial=route == "serial")
    _Counting.made = 0
    monkeypatch.setattr(nativeio, "BatchPrefetcher", _Counting)
    emap, views = tpipeline._load_inputs(files[0], files[1:])
    assert _Counting.made == (route == "prefetcher")
    for g, w in zip([emap] + views, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        tpipeline._load_inputs(files[0] + ".missing", files[1:])


@pytest.mark.parametrize("prepare", [False, True])
@pytest.mark.parametrize("route", ["prefetcher", "serial"])
def test_load_pair_chunk_routes(tmp_path, monkeypatch, route, prepare):
    _, files, want = _scene_files(str(tmp_path), (3, 4, 1),
                                  serial=route == "serial")
    chunk = [(files[0], files[1]), (files[2], files[0]), (files[1], files[-1])]
    _Counting.made = 0
    monkeypatch.setattr(nativeio, "BatchPrefetcher", _Counting)
    fn = (lambda i, rgb, gt: (i, rgb.sum(), gt)) if prepare else None
    got = tdata._load_pair_chunk(chunk, threads=3, prepare=fn)
    assert _Counting.made == (route == "prefetcher")
    index = {f: w for f, w in zip(files, want)}
    for i, ((r, g), out) in enumerate(zip(chunk, got)):
        if prepare:
            assert out[0] == i and out[1] == index[r].sum()
            np.testing.assert_array_equal(out[2], index[g])
        else:
            np.testing.assert_array_equal(out[0], index[r])
            np.testing.assert_array_equal(out[1], index[g])
    bad = [(files[0], files[1]), (files[2], str(tmp_path / "gone.png"))]
    with pytest.raises(FileNotFoundError, match="gone.png"):
        tdata._load_pair_chunk(bad, threads=2)


def test_merge_from_paeth_files_equals_the_twins_arrays(tmp_path,
                                                         monkeypatch):
    sc, files, want = _scene_files(str(tmp_path), (4, 3, 4, 4))
    out = tpipeline.merge_depth_maps(files[0], files[1:],
                                     str(tmp_path / "out.png"), sc["tcfg"],
                                     device="cpu")
    monkeypatch.setattr(tpipeline, "_load_inputs",
                        lambda b, p: (want[0], want[1:]))
    plain = tpipeline.merge_depth_maps(files[0], files[1:],
                                       str(tmp_path / "plain.png"),
                                       sc["tcfg"], device="cpu")
    np.testing.assert_array_equal(out.out_u16, plain.out_u16)
    np.testing.assert_array_equal(tio.read_png_py(str(tmp_path / "out.png")),
                                  plain.out_u16)
    assert (tmp_path / "out.png").read_bytes() == (
        tmp_path / "plain.png").read_bytes()


def test_library_path_follows_the_link_flags(monkeypatch):
    assert "pngio" in _build.HOST_SOURCES
    assert _build.source_path("pngio").name == "pngio.cpp"
    before = _build.library_path("pngio")
    assert before.name.startswith("libpngio-")
    monkeypatch.setitem(_build.LINK_FLAGS, "pngio", ("-pthread", "-lz"))
    assert _build.library_path("pngio") != before
    monkeypatch.setitem(_build.LINK_FLAGS, "pngio", ())
    assert _build.library_path("pngio") != before
    info = nativeio.zlib_info()
    assert info["version"] and info["header"]
