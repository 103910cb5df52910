"""The cubemap projections of the port (``panodepth_torch.ops.cubemap``) and
the one-tap equirect sampler (``ops.sampling.sample_equirect_nearest_mc``)
against the JAX package's (``panodepth.ops.cubemap``,
``panodepth.ops.sampling``), on numpy inputs made from a seed.

Tolerances:

* The host tables (``_face_dirs``, ``_cube_lookup``) are the same numpy
  code: equal.
* Cube -> equirect gathers with those tables and blends in f32 in the
  same op order: equal, bilinear and nearest.
* Equirect -> cube: JAX takes ``arctan2``/``arccos`` of the face
  directions in f32 on its device, the port in float64 on the host,
  rounded once to f32; the angles differ by a few f32 ulps (XLA on the
  CPU differs from the correctly rounded angle at 11-20 % of the pixels),
  so each bilinear weight moves by a few ulps of its tap coordinate (up to
  ~W * 2^-24): held within 2e-6 * W for inputs in [0, 1).  The nearest
  taps pick the same pixels at the sizes below (no coordinate lies within
  those ulps of a tap's midpoint): equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.ops import cubemap as jcube
from panodepth.ops import sampling as jsampling

from panodepth_torch.ops import cubemap as tcube
from panodepth_torch.ops import sampling as tsampling

torch.set_num_threads(1)

SIZES = [(16, 32, 8), (32, 64, 16), (64, 128, 32), (128, 256, 64)]


@pytest.mark.parametrize("face_size", [1, 8, 32, 128])
def test_host_tables_equal_jax(face_size):
    np.testing.assert_array_equal(tcube._FACES, jcube._FACES)
    np.testing.assert_array_equal(tcube._face_dirs(face_size),
                                  jcube._face_dirs(face_size))
    for got, want in zip(tcube._cube_lookup(2 * face_size, 4 * face_size,
                                            face_size),
                         jcube._cube_lookup(2 * face_size, 4 * face_size,
                                            face_size)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,s", SIZES)
@pytest.mark.parametrize("taps", ["bilinear", "nearest"])
def test_equirect_to_cubemap_matches_jax(h, w, s, taps):
    img = np.random.RandomState(h + w).rand(h, w, 3).astype(np.float32)
    want = np.asarray(jcube.equirect_to_cubemap(jnp.asarray(img), s, taps))
    got = tcube.equirect_to_cubemap(torch.tensor(img), s, taps).numpy()
    assert got.shape == want.shape == (6, s, s, 3)
    if taps == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * w)


@pytest.mark.parametrize("h,w,s", SIZES)
@pytest.mark.parametrize("taps", ["bilinear", "nearest"])
def test_cubemap_to_equirect_matches_jax(h, w, s, taps):
    faces = np.random.RandomState(s).rand(6, s, s, 4).astype(np.float32)
    want = np.asarray(jcube.cubemap_to_equirect(jnp.asarray(faces), h, w,
                                                taps))
    got = tcube.cubemap_to_equirect(torch.tensor(faces), h, w, taps).numpy()
    assert got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("taps", ["bilinear", "nearest"])
def test_bf16_features_promote_as_in_jax(taps):
    """Bilinear taps blend a bf16 map with f32 weights into f32 (JAX's
    promotion); nearest taps keep bf16.  Both ways round."""
    rng = np.random.RandomState(9)
    img = rng.rand(32, 64, 5).astype(np.float32)
    faces = rng.rand(6, 16, 16, 5).astype(np.float32)
    jdt = lambda a: jnp.asarray(a, jnp.bfloat16)
    tdt = lambda a: torch.tensor(a).to(torch.bfloat16)
    want_c = jcube.equirect_to_cubemap(jdt(img), 16, taps)
    got_c = tcube.equirect_to_cubemap(tdt(img), 16, taps)
    want_e = jcube.cubemap_to_equirect(jdt(faces), 32, 64, taps)
    got_e = tcube.cubemap_to_equirect(tdt(faces), 32, 64, taps)
    out = torch.bfloat16 if taps == "nearest" else torch.float32
    assert got_c.dtype == got_e.dtype == out
    assert str(want_c.dtype) == str(want_e.dtype) == str(out).split(".")[1]
    np.testing.assert_array_equal(got_e.float().numpy(),
                                  np.asarray(want_e, np.float32))
    np.testing.assert_allclose(got_c.float().numpy(),
                               np.asarray(want_c, np.float32), rtol=0,
                               atol=2e-6 * 64)


def test_nchw_forms_batch_and_match_the_channels_last_forms():
    """The nets' NCHW forms: (N, C, H, W) -> (N*6, C, S, S), image-major,
    and back; each image as it is alone."""
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.rand(3, 5, 32, 64).astype(np.float32))
    for taps in ("bilinear", "nearest"):
        cube = tcube.equirect_to_cube_nchw(x, 16, taps)
        assert cube.shape == (18, 5, 16, 16)
        for i in range(3):
            alone = tcube.equirect_to_cubemap(x[i].permute(1, 2, 0), 16,
                                              taps)
            assert torch.equal(cube[6 * i:6 * i + 6],
                               alone.permute(0, 3, 1, 2))
        back = tcube.cube_to_equirect_nchw(cube, 32, 64, taps)
        assert back.shape == (3, 5, 32, 64)
        for i in range(3):
            alone = tcube.cubemap_to_equirect(
                cube[6 * i:6 * i + 6].permute(0, 2, 3, 1), 32, 64, taps)
            assert torch.equal(back[i], alone.permute(2, 0, 1))
    with pytest.raises(ValueError, match="taps"):
        tcube.equirect_to_cube_nchw(x, 16, "bicubic")


def test_round_trip_keeps_a_smooth_field():
    """Equirect -> cube -> equirect of a smooth field comes back close,
    in both packages alike (the orientation of every face is right)."""
    h, w = 64, 128
    az = (np.arange(w) + 0.5) / w * 2 * np.pi
    ze = (np.arange(h) + 0.5) / h * np.pi
    field = (0.5 + 0.3 * np.sin(az)[None, :] * np.sin(ze)[:, None]
             + 0.1 * np.cos(ze)[:, None]).astype(np.float32)[..., None]
    got = tcube.cubemap_to_equirect(
        tcube.equirect_to_cubemap(torch.tensor(field), 32), h, w).numpy()
    want = np.asarray(jcube.cubemap_to_equirect(
        jcube.equirect_to_cubemap(jnp.asarray(field), 32), h, w))
    assert float(np.abs(got - field).max()) < 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * w)


@pytest.mark.parametrize("channels", [None, 3])
def test_sample_equirect_nearest_mc_matches_jax(channels):
    rng = np.random.RandomState(12)
    shape = (24, 48) + (() if channels is None else (channels,))
    img = rng.rand(*shape).astype(np.float32)
    azi = rng.uniform(-1.0, 7.5, (40, 30)).astype(np.float32)
    zen = rng.uniform(-0.2, 3.4, (40, 30)).astype(np.float32)
    want = np.asarray(jsampling.sample_equirect_nearest_mc(
        jnp.asarray(img), jnp.asarray(azi), jnp.asarray(zen)))
    got = tsampling.sample_equirect_nearest_mc(
        torch.tensor(img), torch.tensor(azi), torch.tensor(zen)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the one tap is always one of the bilinear sampler's four
    taps = tsampling._bilinear_coords(24, 48, torch.tensor(azi),
                                      torch.tensor(zen))
    xn, yn = tsampling.nearest_of(taps)
    assert bool(((xn == taps[0]) | (xn == taps[1])).all())
    assert bool(((yn == taps[2]) | (yn == taps[3])).all())


def test_device_tables_are_cached_per_shape():
    tcube._cube_taps.cache_clear()
    x = torch.rand(1, 2, 16, 32)
    for _ in range(3):
        tcube.equirect_to_cube_nchw(x, 8)
    info = tcube._cube_taps.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    tcube.equirect_to_cube_nchw(x, 8, "nearest")
    assert tcube._cube_taps.cache_info().misses == 2
