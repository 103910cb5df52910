"""The gather tables, their samplers, ``rotate_equirect`` and the bf16
downsample of the port against the JAX package (``panodepth/ops/
sampling.py``, ``ops/projection.py``, ``jax.image.resize``), on the same
numpy inputs made from a seed; mirrors ``tests/test_sampling.py:70-205``.

Bars: every table bit-equal to JAX's (the port keeps JAX's uint32 words
as int32 and its uint16 codes as int16: compared as int32, the 565 codes
through ``& 0xFFFF``); every sampler on the same table bit-equal (the
same f32 operations in the same order); ``pair16`` bit-equal to
``packed16``; ``rotate_equirect`` within 1e-5 on white noise (its rays
come from f32 trigonometry, which the frameworks round differently by an
ulp; bilinear sampling is continuous); the views of each table within
1e-4 (the extraction's f32 ray angles, as in
``tests/test_torch_projection.py``); the bf16 downsample bit-equal to
the jitted JAX resize at the e2e graph's ratios.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.config import LAYOUTS as JAX_LAYOUTS
from panodepth.ops import projection as jproj
from panodepth.ops import sampling as js

from panodepth_torch.config import LAYOUTS as PORT_LAYOUTS
from panodepth_torch.ops import projection as tproj
from panodepth_torch.ops import resize as tresize
from panodepth_torch.ops import sampling as ts

torch.set_num_threads(1)


def _sources(seed):
    """An 8-bit RGB panorama as uint8, as its f32 k/255, and f32 noise."""
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (32, 64, 3)).astype(np.uint8)
    return dict(u8=u8, f8=u8.astype(np.float32) / 255.0,
                noise=rng.rand(32, 64, 3).astype(np.float32))


def _coords(seed, n=(10, 11)):
    """Ray angles around and beyond the seam and both poles."""
    rng = np.random.RandomState(seed)
    azi = rng.uniform(-1, 7.5, n).astype(np.float32)
    azi.flat[:4] = [0.0, 2 * np.pi - 1e-4, -1e-4, 2 * np.pi]
    zen = rng.uniform(-0.3, np.pi + 0.3, n).astype(np.float32)
    return azi, zen


def _as_int32(table):
    """A port table's bits as JAX's values: int32 words as they are, int16
    565 codes through ``& 0xFFFF``."""
    t = table.to(torch.int32)
    return (t & 0xFFFF).numpy() if table.dtype == torch.int16 else t.numpy()


# (JAX pack, JAX sampler, port pack, port sampler, port dtype)
TABLES = {
    "packed": (js.pack_rgb_u32, js.sample_equirect_bilinear_packed,
               ts.pack_rgb_u32, ts.sample_equirect_bilinear_packed,
               torch.int32),
    "packed16": (js.pack_rgb565_u16, js.sample_equirect_bilinear_packed565,
                 ts.pack_rgb565_u16, ts.sample_equirect_bilinear_packed565,
                 torch.int16),
    "packed16d": (lambda r: js.pack_rgb565_u16(r, dither=True),
                  js.sample_equirect_bilinear_packed565,
                  lambda r: ts.pack_rgb565_u16(r, dither=True),
                  ts.sample_equirect_bilinear_packed565, torch.int16),
    "pair16": (js.pack_rgb565_pair_u32,
               js.sample_equirect_bilinear_packed565pair,
               ts.pack_rgb565_pair_u32,
               ts.sample_equirect_bilinear_packed565pair, torch.int32),
    "pair16d": (lambda r: js.pack_rgb565_pair_u32(r, dither=True),
                js.sample_equirect_bilinear_packed565pair,
                lambda r: ts.pack_rgb565_pair_u32(r, dither=True),
                ts.sample_equirect_bilinear_packed565pair, torch.int32),
}


@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("src", ["u8", "f8", "noise"])
def test_table_and_sampler_bit_equal_to_jax(name, src):
    jpack, jsamp, tpack, tsamp, dtype = TABLES[name]
    img = _sources(9)[src]
    want = np.asarray(jpack(jnp.asarray(img)))
    got = tpack(torch.tensor(img))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_as_int32(got),
                                  want.astype(np.int64).astype(np.uint32)
                                  .view(np.int32))
    azi, zen = _coords(10)
    ws = np.asarray(jsamp(jnp.asarray(want), jnp.asarray(azi),
                          jnp.asarray(zen)))
    gs = tsamp(got, torch.tensor(azi), torch.tensor(zen)).numpy()
    assert gs.dtype == np.float32 and gs.shape == (10, 11, 3)
    np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("dither", [False, True])
def test_pair16_bit_equal_to_packed16_and_its_layout(dither):
    """The pair table's high 16 bits are the 565 table, its low 16 the 565
    table rolled one pixel west (the seam's wrap baked in), and its
    sampler gives the 565 sampler's values bit for bit, at the seam too
    (tests/test_sampling.py:134-171)."""
    rng = np.random.RandomState(13)
    rgb = torch.tensor(rng.randint(0, 256, (32, 64, 3)).astype(np.uint8))
    azi = np.concatenate([rng.uniform(0, 2 * math.pi, 80),
                          rng.uniform(2 * math.pi - 0.02, 2 * math.pi, 20)])
    azi = torch.tensor(azi.astype(np.float32).reshape(10, 10))
    zen = torch.tensor(rng.uniform(0, math.pi, (10, 10)).astype(np.float32))
    p16 = ts.pack_rgb565_u16(rgb, dither=dither)
    pair = ts.pack_rgb565_pair_u32(rgb, dither=dither)
    code = p16.to(torch.int32) & 0xFFFF
    assert torch.equal((pair >> 16) & 0xFFFF, code)
    assert torch.equal(pair & 0xFFFF, torch.roll(code, -1, 1))
    assert torch.equal(ts.sample_equirect_bilinear_packed565pair(pair, azi,
                                                                 zen),
                       ts.sample_equirect_bilinear_packed565(p16, azi, zen))


def test_packed_sampler_matches_f32_for_u8_sources():
    """The packed path on an 8-bit source equals the f32 bilinear path up
    to f32 rounding (tests/test_sampling.py:88-104), and the 565 path up to
    half a 5/6/5 step per channel."""
    srcs = _sources(9)
    azi, zen = (torch.tensor(a) for a in _coords(11))
    ref = ts.sample_equirect_bilinear(torch.tensor(srcs["f8"]), azi, zen)
    for src in ("u8", "f8"):
        rgb = torch.tensor(srcs[src])
        got = ts.sample_equirect_bilinear_packed(ts.pack_rgb_u32(rgb), azi,
                                                 zen)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=2e-6)
        got565 = ts.sample_equirect_bilinear_packed565(
            ts.pack_rgb565_u16(rgb), azi, zen)
        bound = torch.tensor([0.5 / 31, 0.5 / 63, 0.5 / 31]) + 1e-5
        assert bool(((got565 - ref).abs() <= bound).all())


@pytest.mark.parametrize("v", [0.317, 0.5161, 0.713])
def test_dithered_565_bounds_match_jax(v):
    """Bayer-dithered 565 on constant inputs between two codes: each
    channel within one step, 4x4-block means within 0.3 step, the dither
    firing, and the codes JAX's (tests/test_sampling.py:174-205)."""
    rgb = np.full((8, 8, 3), v, np.float32)
    p = ts.pack_rgb565_u16(torch.tensor(rgb), dither=True)
    code = (p.to(torch.int32) & 0xFFFF).numpy()
    np.testing.assert_array_equal(
        code, np.asarray(js.pack_rgb565_u16(jnp.asarray(rgb), dither=True)))
    for ch, scale in (((code >> 11) & 0x1F, 31.0), ((code >> 5) & 0x3F, 63.0),
                      (code & 0x1F, 31.0)):
        err = ch.astype(np.float64) / scale - v
        assert np.max(np.abs(err)) <= 1.0 / scale + 1e-9
        assert np.max(np.abs(err.reshape(2, 4, 2, 4).mean((1, 3)))) \
            <= 0.3 / scale
    assert len(np.unique(code)) > 1
    plain = ts.pack_rgb565_u16(torch.tensor(rgb))
    assert len(torch.unique(plain)) == 1


def test_bayer_offsets_and_decode565_match_jax():
    for h, w in ((4, 4), (7, 9), (16, 32)):
        np.testing.assert_array_equal(ts._bayer_offsets(h, w).numpy(),
                                      np.asarray(js._bayer_offsets(h, w)))
    codes = np.arange(0, 65536, 7, dtype=np.int32)
    np.testing.assert_array_equal(
        ts._decode565(torch.tensor(codes)).numpy(),
        np.asarray(js._decode565(jnp.asarray(codes))))


@pytest.mark.parametrize("kw", [{}, dict(yaw=2 * math.pi / 63),
                                dict(yaw=0.2, pitch=0.4, roll=-0.7),
                                dict(pitch=1.0, out_shape=(16, 40))])
def test_rotate_equirect_matches_jax(kw):
    rng = np.random.RandomState(5)
    img = rng.rand(32, 64).astype(np.float32)
    want = np.asarray(js.rotate_equirect(jnp.asarray(img), **kw))
    got = ts.rotate_equirect(torch.tensor(img), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rgb = rng.rand(32, 64, 3).astype(np.float32)
    np.testing.assert_allclose(
        ts.rotate_equirect(torch.tensor(rgb), **kw).numpy(),
        np.asarray(js.rotate_equirect(jnp.asarray(rgb), **kw)), rtol=0,
        atol=1e-5)


def test_rotate_equirect_identity_and_yaw():
    """tests/test_sampling.py:70-85 on the port."""
    img = np.random.RandomState(5).rand(32, 64).astype(np.float32)
    ident = ts.rotate_equirect(torch.tensor(img)).numpy()
    np.testing.assert_allclose(ident[8:24, :-1], img[8:24, :-1], atol=0.08)
    rolled = ts.rotate_equirect(torch.tensor(img),
                                yaw=2 * math.pi / 63).numpy()
    np.testing.assert_allclose(rolled[8:24, 1:-2],
                               np.roll(img, -1, 1)[8:24, 1:-2], atol=0.08)


@pytest.mark.parametrize("table,jpack,jsamp", [
    ("packed", js.pack_rgb_u32, js.sample_equirect_bilinear_packed),
    ("packed16", js.pack_rgb565_u16, js.sample_equirect_bilinear_packed565),
    ("pair16", js.pack_rgb565_pair_u32,
     js.sample_equirect_bilinear_packed565pair),
    ("pair16d", lambda r: js.pack_rgb565_pair_u32(r, dither=True),
     js.sample_equirect_bilinear_packed565pair),
    ("bf16", lambda r: r.astype(jnp.bfloat16), None)])
def test_extract_view_with_each_table_matches_jax(table, jpack, jsamp):
    """A view sampled from each table, as the JAX package's ``sampler=``
    samples it (the e2e graph's form), from a u8 panorama."""
    rgb = np.random.RandomState(1).randint(0, 256, (64, 128, 3)).astype(
        np.uint8)
    jl, tl = JAX_LAYOUTS["5fold_leres"](), PORT_LAYOUTS["5fold_leres"]()
    src = rgb.astype(np.float32) / 255.0 if table == "bf16" else rgb
    for v in (0, 7, 14):
        want = np.asarray(jproj.extract_view(
            jpack(jnp.asarray(src)), jl.fovs[v], 64, sampler=jsamp))
        got = tproj.extract_view(torch.tensor(src), tl.fovs[v], 64,
                                 table=table)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("src,dst", [((1024, 2048), (256, 512)),
                                     ((128, 256), (32, 64)),
                                     ((64, 128), (32, 64)),
                                     ((96, 200), (40, 64))])
def test_resize_bilinear_bf16_downsample_is_exact(src, dst):
    """The baseline feed of every table but f32 (bf16 input): the 2048 ->
    512 feed of the e2e graph (4x), the tests' 2x and 4x feeds, and an odd
    ratio, each bit-equal to JAX's vmapped resize under jit, as the JAX
    e2e graph runs it."""
    x = np.random.RandomState(2).rand(2, *src, 3).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax.jit(jax.vmap(lambda r: jax.image.resize(
        r, (*dst, 3), "bilinear")))(jx)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    got = tresize.resize_bilinear_nhwc(tx, dst)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
