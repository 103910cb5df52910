"""``panodepth_torch.ops.corrupt`` against ``panodepth.ops.corrupt``: the
quality tables, ``jpeg_artifacts`` (a quality per batch and per sample),
the luma path against the port's own JPEG codec, ``apply`` on the draws
JAX makes against JAX's ``corrupt`` with that key, ``eval_corruption`` on
JAX's noise, and the stream of ``corrupt_batches``.

The bar: equal on all but at most 0.5 % of the pixels, mean absolute
difference at most 1e-3.  Measured: ``jpeg_artifacts`` and
``eval_corruption`` are bit-equal to JAX on the CPU
(the port computes XLA's roundings: its fused multiply-adds in the colour
transforms, the row-major 2x2 mean, the four partial sums of its 8-term
dot products); ``apply`` is bit-equal on every sample that JPEG touches
and differs by one f32 ulp (``pow``, which the port rounds once from f64)
on 0.05 % of the values of a sample that only exposure and noise touch,
0.012 % of the batch, mean 9e-12.  Rounding to codes turns such an ulp
into a level only at an exact tie, which the bar allows for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.ops import corrupt as J

from panodepth_torch import jpeg
from panodepth_torch.ops import corrupt as T

torch.set_num_threads(1)

SHARE, MEAN = 5e-3, 1e-3


def _test_image(h=64, w=64, seed=0):
    """tests/test_corrupt.py's content: gradients, an edge, texture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    img[h // 4: h // 2, w // 4: w // 2] = 0.9
    img += 0.08 * rng.rand(h, w).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _color_batch(n=4, h=64, w=64):
    """n colour images: three channels of distinct content each."""
    out = []
    for s in range(n):
        g = _test_image(h, w, seed=s)
        rng = np.random.RandomState(50 + s)
        out.append(np.stack([g, np.clip(0.8 * g + 0.2 * rng.rand(h, w), 0, 1),
                             1.0 - 0.7 * g], -1))
    return np.stack(out).astype(np.float32)


def _within_bar(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (d > 0).mean() <= SHARE, (d > 0).mean()
    assert d.mean() <= MEAN, d.mean()
    return d


def test_quality_scale_tables_equal():
    q = torch.arange(1, 101, dtype=torch.float32)[:, None, None]
    for jt, tt in ((J._QTAB_LUMA, T._QTAB_LUMA),
                   (J._QTAB_CHROMA, T._QTAB_CHROMA)):
        np.testing.assert_array_equal(jt, tt)
        want = np.asarray(J._quality_scale(jt, jnp.arange(
            1, 101, dtype=jnp.float32)[:, None, None]))
        np.testing.assert_array_equal(T._quality_scale(tt, q).numpy(), want)
    np.testing.assert_array_equal(T._DCT8, J._DCT8)


@pytest.mark.parametrize("quality", [20.0, 60.0, 95.0])
def test_jpeg_artifacts_match_jax(quality):
    x = _color_batch(3, 64, 96)
    want = np.asarray(J.jpeg_artifacts(jnp.asarray(x), quality))
    got = T.jpeg_artifacts(torch.from_numpy(x), quality).numpy()
    _within_bar(got, want)
    assert got.dtype == np.float32 and 0 <= got.min() and got.max() <= 1


def test_jpeg_artifacts_per_sample_quality():
    x = _color_batch(3)
    q = np.array([20.0, 60.0, 95.0], np.float32)
    want = np.asarray(J.jpeg_artifacts(jnp.asarray(x), jnp.asarray(q)))
    got = T.jpeg_artifacts(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    _within_bar(got, want)
    for i in range(3):  # each sample as it is alone
        solo = T.jpeg_artifacts(torch.from_numpy(x[i:i + 1]), float(q[i]))
        np.testing.assert_array_equal(got[i], solo.numpy()[0])
    # lower quality, larger artifacts
    errs = [np.abs(got[i] - x[i]).mean() for i in range(3)]
    assert errs[0] > errs[1] > errs[2]


@pytest.mark.parametrize("quality", [30, 60, 90])
def test_luma_path_against_the_port_codec(quality):
    """A gray image through the simulation against a real encode and decode
    by the port's codec (libjpeg's integer DCT): JAX's bar against
    libjpeg, tests/test_corrupt.py."""
    img = _test_image()
    rgb = torch.from_numpy(np.stack([img] * 3, -1)[None])
    sim = T.jpeg_artifacts(rgb, float(quality)).numpy()[0]
    np.testing.assert_allclose(sim[..., 0], sim[..., 1], atol=1.5 / 255)
    u8 = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    real = jpeg.decode(jpeg.encode(u8, quality)).astype(np.float32) / 255.0
    err = np.abs(sim[..., 0] - real)
    base = np.abs(img - real)  # the size of the artifacts modelled
    assert err.mean() < 1.5 / 255, err.mean()
    assert err.mean() < 0.35 * max(base.mean(), 1e-9)


def test_jpeg_refuses_unaligned_shapes():
    with pytest.raises(ValueError, match="multiples of 16"):
        T.jpeg_artifacts(torch.zeros(1, 56, 64, 3), 50.0)


def _jax_draws(key, shape, cfg=J.CorruptConfig()):
    """The values JAX's corrupt draws from ``key`` (corrupt.py:170-211), as
    the port's CorruptDraws."""
    b = shape[0]
    k_sel, k_q, k_gain, k_gamma, k_wb, k_read, k_shot, k_sig = \
        jax.random.split(key, 8)
    u = jax.random.uniform
    vals = (u(k_sel, (3, b)),
            1.0 + u(k_wb, (b, 1, 1, 3), minval=-cfg.wb, maxval=cfg.wb),
            u(k_gamma, (b, 1, 1, 1), minval=cfg.gamma[0],
              maxval=cfg.gamma[1]),
            u(k_gain, (b, 1, 1, 1), minval=cfg.gain[0], maxval=cfg.gain[1]),
            u(k_sig, (b, 1, 1, 1), minval=cfg.noise_sigma[0],
              maxval=cfg.noise_sigma[1]),
            jax.random.normal(k_read, shape),
            jax.random.normal(k_shot, shape),
            u(k_q, (b,), minval=cfg.quality[0], maxval=cfg.quality[1]))
    return T.CorruptDraws(*(torch.from_numpy(np.array(v)) for v in vals))


@pytest.mark.parametrize("seed", [7, 8])
def test_apply_on_jax_draws_matches_jax_corrupt(seed):
    x = _color_batch(4)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key, x.shape)
    want = np.asarray(J.corrupt(jnp.asarray(x), key))
    got = T.apply(torch.from_numpy(x), draws).numpy()
    d = _within_bar(got, want)
    assert d.max() <= 2.0 ** -23
    sel = draws.sel.numpy()
    assert (sel[2] < 0.6).any()  # the draw put JPEG on some sample
    assert 0 <= got.min() and got.max() <= 1


def test_probabilities_off_is_identity():
    x = torch.from_numpy(_color_batch(2))
    cfg = T.CorruptConfig(p_jpeg=0.0, p_noise=0.0, p_photo=0.0)
    out = T.corrupt(x, torch.Generator().manual_seed(0), cfg)
    np.testing.assert_array_equal(out.numpy(), x.numpy())


def test_same_generator_same_batch():
    x = torch.from_numpy(_color_batch(4))
    a = T.corrupt(x, torch.Generator().manual_seed(7))
    b = T.corrupt(x, torch.Generator().manual_seed(7))
    c = T.corrupt(x, torch.Generator().manual_seed(8))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (a - c).abs().max() > 1e-4
    assert 0 <= float(a.min()) and float(a.max()) <= 1


def test_draw_shapes_and_ranges():
    cfg = T.CorruptConfig()
    d = T.draw((5, 32, 48, 3), torch.Generator().manual_seed(1), cfg)
    assert d.sel.shape == (3, 5) and d.wb.shape == (5, 1, 1, 3)
    for t in (d.gamma, d.gain, d.sig):
        assert t.shape == (5, 1, 1, 1)
    assert d.read.shape == d.shot.shape == (5, 32, 48, 3)
    assert d.quality.shape == (5,)
    assert ((d.wb >= 1 - cfg.wb) & (d.wb <= 1 + cfg.wb)).all()
    assert ((d.quality >= 25) & (d.quality <= 95)).all()
    assert ((d.sig >= 0) & (d.sig <= 0.04)).all()


def _stream(n, shape=(2, 32, 32, 3)):
    for i in range(n):
        yield (np.full(shape, 0.5, np.float32),
               np.full(shape[:3], 0.25 + i, np.float32),
               np.ones(shape[:3], bool))


def test_corrupt_batches_passthrough_and_resumable():
    got = list(T.corrupt_batches(_stream(3), seed=3, device="cpu"))
    assert len(got) == 3
    for i, (rgb, depth, valid) in enumerate(got):
        assert isinstance(rgb, torch.Tensor) and rgb.shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(depth, 0.25 + i)  # untouched, numpy
        assert isinstance(valid, np.ndarray) and valid.all()
    assert (got[0][0] - got[1][0]).abs().max() > 0
    # batch k depends on the seed and k alone: a stream whose first
    # batches differ (a resumed run's) corrupts batch 2 as this one did
    other = [(np.zeros((1, 16, 16, 3), np.float32), None, None)] * 2
    resumed = list(T.corrupt_batches(other + [next(_stream(1))], seed=3))
    np.testing.assert_array_equal(resumed[2][0].numpy(),
                                  T.corrupt(torch.full((2, 32, 32, 3), 0.5),
                                            T.batch_generator(3, 2, "cpu"))
                                  .numpy())
    again = list(T.corrupt_batches(_stream(3), seed=3))
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert (list(T.corrupt_batches(_stream(1), seed=4))[0][0]
            - got[0][0]).abs().max() > 0


def test_eval_corruption_on_jax_noise_matches_jax():
    x = _color_batch(2)
    for seed in (0, 5):
        noise = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                           x.shape))
        want = np.asarray(J.eval_corruption(jnp.asarray(x), seed=seed))
        got = T.eval_corruption(torch.from_numpy(x),
                                noise=torch.from_numpy(noise)).numpy()
        _within_bar(got, want)
    # its own noise: deterministic in the seed, visibly degraded
    a = T.eval_corruption(torch.from_numpy(x)).numpy()
    b = T.eval_corruption(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - x).mean() > 0.005 and 0 <= a.min() and a.max() <= 1
