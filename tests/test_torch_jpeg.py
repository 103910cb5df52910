"""The port's JPEG codec (``panodepth_torch/csrc/jpeg.cpp`` through
``panodepth_torch.jpeg``) against Pillow, the JAX package's codec.

* Decode: bit-equal (same dtype, shape and pixels) to the JAX package's
  ``load_image01`` x 255 on files Pillow writes: gray and RGB, sizes 1x1 to
  247x256 (and one 988x1024), subsampling 4:4:4 / 4:2:2 / 4:2:0, quality
  50 / 75 / 95 / 100, with and without restart markers.
* Encode: Pillow decodes the port's file to the same pixels as the JAX
  package's ``save_jpg`` file of the same u8 array; the files are also
  byte-equal (the same markers, tables and entropy-coded bytes).
* Files the codec does not take raise ``ValueError`` naming the file.
"""

import io
import itertools

import numpy as np
import pytest
from PIL import Image

from panodepth import io as jio

from panodepth_torch import io as tio
from panodepth_torch import jpeg

SIZES = ((1, 1), (5, 7), (37, 53), (247, 256))


def _image(h, w, channels, seed):
    """u8 test image: smooth colour fields, texture and noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    planes = [np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) * 80 + 128
              for k in range(channels)]
    img = np.stack(planes, -1) + rng.normal(0, 25, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pillow_jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _jax_u8(path):
    """The JAX package's decode of ``path`` as the u8 it came from."""
    f = jio.load_image01(str(path))
    return np.round(f * np.float32(255)).astype(np.uint8)


@pytest.mark.parametrize("mode,subsampling,quality", list(itertools.product(
    ("L", "RGB"), (0, 1, 2), (50, 75, 95, 100))))
def test_decode_is_bit_equal_to_pillow(tmp_path, mode, subsampling, quality):
    channels = 1 if mode == "L" else 3
    for k, ((h, w), restart) in enumerate(itertools.product(SIZES, (0, 2))):
        arr = _image(h, w, channels, seed=k + 7 * quality + subsampling)
        kw = dict(quality=quality, subsampling=subsampling)
        if restart:
            kw["restart_marker_blocks"] = restart
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(_pillow_jpeg(arr, **kw))
        want = _jax_u8(path)
        got = jpeg.decode(path.read_bytes(), str(path))
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape, ((h, w), restart)
        assert np.array_equal(got, want), ((h, w), restart)
        # the loader the pipeline uses gives the JAX package's floats
        assert np.array_equal(tio.load_image01(str(path)),
                              jio.load_image01(str(path)))


def test_decode_large_rgb_with_restarts(tmp_path):
    arr = _image(988, 1024, 3, seed=3)
    path = tmp_path / "big.jpg"
    path.write_bytes(_pillow_jpeg(arr, quality=95, restart_marker_blocks=7))
    assert np.array_equal(jpeg.decode(path.read_bytes()), _jax_u8(path))


@pytest.mark.parametrize("channels", (1, 3))
def test_encode_matches_pillow(tmp_path, channels):
    same_bytes = []
    for k, (h, w) in enumerate(SIZES + ((988, 1024),)):
        arr = _image(h, w, channels, seed=100 + k)
        ours = tmp_path / f"ours{k}.jpg"
        theirs = tmp_path / f"theirs{k}.jpg"
        tio.save_jpg(str(ours), (arr + 0.5) / 255.0)  # truncates back to arr
        jio.save_jpg(str(theirs), (arr + 0.5) / 255.0)
        assert np.array_equal(np.asarray(Image.open(ours)),
                              np.asarray(Image.open(theirs))), (h, w)
        same_bytes.append(ours.read_bytes() == theirs.read_bytes())
        assert ours.read_bytes() == jpeg.encode(arr, 95)
    # not only the pixels: the whole file, entropy-coded bytes included
    assert all(same_bytes), same_bytes


@pytest.mark.parametrize("quality", (10, 50, 75, 100))
def test_encode_matches_pillow_at_other_qualities(quality):
    for channels in (1, 3):
        arr = _image(37, 53, channels, seed=quality)
        assert jpeg.encode(arr, quality) == _pillow_jpeg(arr, quality=quality)


def test_round_trip_through_both_decoders():
    arr = _image(64, 96, 3, seed=11)
    data = jpeg.encode(arr)
    assert np.array_equal(jpeg.decode(data),
                          np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("kind,reason", [
    ("progressive", "progressive"),
    ("cmyk", "four-component"),
    ("truncated", "truncated"),
    ("png", "not a JPEG"),
])
def test_refusals_name_the_file(tmp_path, kind, reason):
    arr = _image(40, 48, 3, seed=5)
    if kind == "progressive":
        data = _pillow_jpeg(arr, quality=90, progressive=True)
    elif kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif kind == "truncated":
        data = _pillow_jpeg(arr)[:-300]
    else:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        data = buf.getvalue()
    path = tmp_path / f"{kind}.jpg"
    with pytest.raises(ValueError, match=reason) as e:
        jpeg.decode(data, str(path))
    assert str(path) in str(e.value)


def test_encode_refuses_what_jpeg_does_not_hold():
    with pytest.raises(TypeError, match="uint8"):
        jpeg.encode(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        jpeg.encode(np.zeros((4, 4, 4), np.uint8))


def test_codec_build_is_hash_keyed_and_raises_with_the_compilers_output(
        tmp_path, monkeypatch):
    from panodepth_torch.kernels import _build

    path = _build.library_path("jpeg")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libjpeg-")
    assert "jpeg" in _build.HOST_SOURCES and "jpeg" not in _build.SOURCES
    assert _build.source_path("jpeg").name == "jpeg.cpp"
    # a source that does not compile: the error carries g++'s own message
    (tmp_path / "jpeg.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"failed on csrc/jpeg\.cpp") as e:
        _build.build(["jpeg"])
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))
    # no compiler: a clear error, and nothing else is tried
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build(["jpeg"])
