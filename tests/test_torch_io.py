"""The port's PNG codec (stdlib zlib + numpy), BMP reader, writers and
dataset naming.

PNGs written by Pillow (through the JAX package's writers) and PNGs
filtered here row by row with each of the five PNG filters decode to the
same pixels Pillow reads; the port's own 16-bit files read back exactly
in both packages.  BMPs, ``load_image_int``, ``save_png8``, ``save_pfm``
and ``save_jpg`` agree with the JAX package on the same files, and files
the port writes load the same through both packages.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from panodepth import io as jio
from panodepth.config import five_fold_leres as jax_five_fold_leres

from panodepth_torch import io as tio
from panodepth_torch.config import five_fold_leres

torch.set_num_threads(1)  # xdist runs several workers on a few cores


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(arr, filters):
    """A PNG whose row y carries filter ``filters[y % len(filters)]``,
    filtered byte by byte from the specification."""
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    raw = arr.astype(">u2" if depth == 16 else np.uint8).tobytes()
    h, w = arr.shape[:2]
    stride = len(raw) // h
    bpp = channels * depth // 8
    out, prior = bytearray(), bytes(stride)
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        kind = filters[y % len(filters)]
        out.append(kind)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
            out.append((x - pred) & 0xFF)
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint16, 1),
                                            (np.uint8, 3), (np.uint8, 4),
                                            (np.uint16, 3), (np.uint8, 2)])
def test_all_five_filters_decode(tmp_path, dtype, channels):
    rng = np.random.RandomState(channels)
    hi = 65536 if dtype == np.uint16 else 256
    shape = (11, 9) if channels == 1 else (11, 9, channels)
    arr = rng.randint(0, hi, shape).astype(dtype)
    f = tmp_path / "f.png"
    f.write_bytes(_encode(arr, (0, 1, 2, 3, 4)))
    got = tio.read_png(str(f))
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == dtype
    if dtype == np.uint8 or channels == 1:  # Pillow keeps 16 bits only for gray
        np.testing.assert_array_equal(np.asarray(Image.open(f)).astype(dtype),
                                      arr)


def test_pillow_written_pngs_read_like_the_jax_package(tmp_path):
    rng = np.random.RandomState(5)
    smooth = np.cumsum(rng.randint(0, 300, (40, 70)), axis=1).astype(np.uint16)
    jio.save_png16(str(tmp_path / "a.png"), smooth)
    Image.fromarray((smooth >> 8).astype(np.uint8), "L").save(tmp_path / "b.png")
    Image.fromarray(rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)).save(
        tmp_path / "c.png", optimize=True)
    for name in ("a.png", "b.png", "c.png"):
        got = tio.load_image01(str(tmp_path / name))
        want = jio.load_image01(str(tmp_path / name))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_save_png16_reads_back_in_both_packages(tmp_path):
    rng = np.random.RandomState(0)
    data = rng.randint(0, 65536, (16, 32)).astype(np.uint16)
    f = str(tmp_path / "x.png")
    tio.save_png16(f, data)
    np.testing.assert_array_equal(tio.read_png(f), data)
    back = (jio.load_image01(f) * 65535.0 + 0.5).astype(np.uint16)
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(tio.load_image01(f), jio.load_image01(f))


def test_png_reader_refuses_what_it_does_not_take(tmp_path):
    f = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(f)
    with pytest.raises(ValueError, match="unsupported PNG"):
        tio.read_png(str(f))
    good = _encode(np.zeros((3, 3), np.uint8), (0,))
    bad = bytearray(good)
    bad[-20] ^= 0xFF  # corrupt the IDAT body
    f.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        tio.read_png(str(f))
    f.write_bytes(good[:-15])  # cut inside the IDAT chunk
    with pytest.raises(ValueError, match="truncated"):
        tio.read_png(str(f))


def test_pfm_and_jpeg_load_like_the_jax_package(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.rand(8, 12).astype(np.float32) * 5
    f = str(tmp_path / "x.pfm")
    jio.save_pfm(f, img)
    np.testing.assert_array_equal(tio.load_pfm(f), img)
    for mono360 in (False, True):
        np.testing.assert_array_equal(tio.load_image01(f, mono360),
                                      jio.load_image01(f, mono360))
    jpg = str(tmp_path / "y.jpg")
    jio.save_jpg(jpg, rng.rand(16, 24))
    np.testing.assert_array_equal(tio.load_image01(jpg), jio.load_image01(jpg))


def test_filename_conventions_match_jax():
    for folder in ("out_slicenet/", "unifuse_res/", "hohonet/", "plain/"):
        assert tio.baseline_filename("b/", "x", folder) == \
            jio.baseline_filename("b/", "x", folder)
    for raw, ds in (("area_rgb_1", "matterport"), ("scene_rgb", "replica"),
                    ("a_color", "suncg"), ("area_rgb_1", "stanford2d3d")):
        assert tio.gt_filename("g/", raw, ds) == jio.gt_filename("g/", raw, ds)
    assert tio.pmap_filenames("v/", "img", five_fold_leres(), ".png") == \
        jio.pmap_filenames("v/", "img", jax_five_fold_leres(), ".png")
    assert tio.raw_name("a/b/c.d.png") == jio.raw_name("a/b/c.d.png")
    files = [f"f{i}_{'x' if i % 3 else 'y'}.png" for i in range(12)]
    for kw in (dict(include=["x"]), dict(exclude=["y"], limit=3),
               dict(shard="1/4"), dict(include=["f1"], shard="0/2", limit=2)):
        assert tio.filter_files(files, **kw) == jio.filter_files(files, **kw)
    with pytest.raises(ValueError, match="shard"):
        tio.filter_files(files, shard="4/4")


def test_list_images(tmp_path):
    for name in ("b.png", "a.jpg", "c.txt", "d.PFM"):
        (tmp_path / name).write_bytes(b"")
    assert tio.list_images(str(tmp_path)) == jio.list_images(str(tmp_path))
    assert [os.path.basename(p) for p in tio.list_images(str(tmp_path))] == \
        ["a.jpg", "b.png", "d.PFM"]


def _bmp_variants(rgb, gray):
    """BMPs Pillow writes (8-bit gray, 24-bit, 32-bit from RGBA), a
    top-down copy of the 24-bit one, and a 32-bit BI_BITFIELDS file with an
    alpha mask (V4 header), written here."""
    out = {}
    for name, img in (("gray", Image.fromarray(gray, "L")),
                      ("rgb24", Image.fromarray(rgb)),
                      ("rgbx32", Image.fromarray(np.dstack(
                          [rgb, np.full(rgb.shape[:2], 77, np.uint8)])))):
        buf = io.BytesIO()
        img.save(buf, "BMP")
        out[name] = buf.getvalue()
    # the 24-bit file with its rows in file order reversed and height < 0
    data = bytearray(out["rgb24"])
    h, w = rgb.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    rows = bytes(data[54:54 + h * stride])
    flipped = b"".join(rows[(h - 1 - y) * stride:(h - y) * stride]
                       for y in range(h))
    data[22:26] = struct.pack("<i", -h)
    out["rgb24_topdown"] = bytes(data[:54]) + flipped
    alpha = (np.arange(h * w).reshape(h, w) % 251).astype(np.uint8)
    bgra = np.dstack([rgb[..., ::-1], alpha])[::-1]
    header = struct.pack("<IiiHHIIiiII", 108, w, h, 1, 32, 3, bgra.size, 0,
                         0, 0, 0)
    header += struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    header += bytes(108 - len(header))
    out["rgba32_bitfields"] = (b"BM" + struct.pack("<IHHI", 14 + 108
                                                   + bgra.size, 0, 0, 122)
                               + header + bgra.tobytes())
    return out


def test_bmp_reader_matches_pillow(tmp_path):
    rng = np.random.RandomState(3)
    rgb = rng.randint(0, 256, (7, 13, 3)).astype(np.uint8)  # 13: row padding
    gray = rng.randint(0, 256, (7, 13)).astype(np.uint8)
    for name, data in _bmp_variants(rgb, gray).items():
        f = tmp_path / f"{name}.bmp"
        f.write_bytes(data)
        want = np.asarray(Image.open(f))
        got = tio.read_image(str(f))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(tio.load_image01(str(f)),
                                      jio.load_image01(str(f)))


def test_bmp_reader_refuses_colour_palettes(tmp_path):
    f = tmp_path / "p.bmp"
    img = Image.fromarray(np.arange(12, dtype=np.uint8).reshape(3, 4), "L")
    img = img.convert("P", palette=Image.Palette.ADAPTIVE, colors=4)
    img.putpalette([255, 0, 0, 0, 255, 0, 0, 0, 255, 9, 9, 9])
    img.save(f)
    with pytest.raises(ValueError, match="colour palette"):
        tio.read_image(str(f))


def test_load_image_int_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    u16 = rng.randint(0, 65536, (9, 11)).astype(np.uint16)
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    jio.save_png16(str(tmp_path / "a.png"), u16)
    Image.fromarray(rgb).save(tmp_path / "b.png")
    jio.save_jpg(str(tmp_path / "c.jpg"), rgb / 255.0)
    Image.fromarray(rgb).save(tmp_path / "d.bmp")
    jio.save_pfm(str(tmp_path / "e.pfm"), rng.rand(4, 5))
    for name in ("a.png", "b.png", "c.jpg", "d.bmp"):
        got, gs = tio.load_image_int(str(tmp_path / name))
        want, ws = jio.load_image_int(str(tmp_path / name))
        assert gs == ws and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tio.load_image_int(str(tmp_path / "e.pfm")) is None
    assert jio.load_image_int(str(tmp_path / "e.pfm")) is None


def test_writers_read_back_in_both_packages(tmp_path):
    rng = np.random.RandomState(6)
    m = rng.rand(10, 17).astype(np.float32)
    rgb = rng.rand(10, 17, 3).astype(np.float32)
    tio.save_png8(str(tmp_path / "t8.png"), m)
    jio.save_png8(str(tmp_path / "j8.png"), m)
    for name in ("t8.png", "j8.png"):
        for loader in (tio.load_image01, jio.load_image01):
            np.testing.assert_array_equal(loader(str(tmp_path / name)),
                                          jio.load_image01(
                                              str(tmp_path / "j8.png")))
    tio.save_pfm(str(tmp_path / "t.pfm"), rgb * 7)
    jio.save_pfm(str(tmp_path / "j.pfm"), rgb * 7)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    for mono in (False, True):
        np.testing.assert_array_equal(tio.load_image01(str(tmp_path / "t.pfm"),
                                                       mono),
                                      jio.load_image01(str(tmp_path / "t.pfm"),
                                                       mono))
    # save_jpg follows the name as Pillow does: .jpg is JPEG, .png 8-bit PNG
    for ext in (".jpg", ".png"):
        for img in (m, rgb):
            tio.save_jpg(str(tmp_path / f"t{ext}"), img)
            jio.save_jpg(str(tmp_path / f"j{ext}"), img)
            a = tio.load_image01(str(tmp_path / f"t{ext}"))
            b = jio.load_image01(str(tmp_path / f"j{ext}"))
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(jio.load_image01(
                str(tmp_path / f"t{ext}")), b)
    with pytest.raises(ValueError, match="save_jpg writes"):
        tio.save_jpg(str(tmp_path / "x.tif"), m)


def test_save_png16_level_env(tmp_path, monkeypatch):
    """PANODEPTH_PNG_LEVEL / level= set the (lossless) deflate level of
    save_png16, as in the JAX package (tests/test_cli_tools.py)."""
    monkeypatch.delenv("PANODEPTH_PNG_LEVEL", raising=False)
    y, x = np.mgrid[0:64, 0:128]
    img = (1000 + 40 * np.sin(x / 9.0) + 8 * y).astype(np.uint16)
    f1, f6 = str(tmp_path / "l1.png"), str(tmp_path / "l6.png")
    tio.save_png16(f1, img, level=1)
    tio.save_png16(f6, img, level=6)
    assert os.path.getsize(f6) < os.path.getsize(f1)
    for f in (f1, f6):
        np.testing.assert_array_equal(
            (tio.load_image01(f) * 65535 + 0.5).astype(np.uint16), img)
    fdef = str(tmp_path / "default.png")
    tio.save_png16(fdef, img)
    assert os.path.getsize(fdef) == os.path.getsize(f1)
    monkeypatch.setenv("PANODEPTH_PNG_LEVEL", "6")
    fenv = str(tmp_path / "env.png")
    tio.save_png16(fenv, img)
    assert os.path.getsize(fenv) == os.path.getsize(f6)


def test_cli_png_level_sets_the_variable(tmp_path, monkeypatch):
    from panodepth_torch import cli

    # set through monkeypatch first, so that the CLI's own setting is
    # undone after the test
    monkeypatch.setenv("PANODEPTH_PNG_LEVEL", "1")
    for d in ("rgb", "gt", "base"):
        (tmp_path / d).mkdir()
    assert cli.main(["0", str(tmp_path / "rgb"), str(tmp_path / "gt"),
                     str(tmp_path / "base"), str(tmp_path / "res"),
                     "--device", "cpu", "--no-extract",
                     "--png-level", "6"]) == 0
    assert os.environ["PANODEPTH_PNG_LEVEL"] == "6"
