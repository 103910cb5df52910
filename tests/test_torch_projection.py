"""Stage-A view extraction and the resize helpers of the port against the
JAX package: ``ops/sampling`` (the bilinear equirect sampler),
``ops/projection`` (``view_shape``, ``extract_view``, ``extract_views``)
and ``ops/resize`` (``jax.image.resize``'s counterparts), on the same
numpy inputs.

Tolerances: the tap arithmetic is the same f32 operations in both, held to
1e-6.  The ray angles come from f32 trigonometry, which the two frameworks
round differently by an ulp; bilinear sampling is continuous, so a view
moves by ~1e-6 of a texel: 1e-5 on a smooth panorama and 1e-4 on white
noise.  The bilinear resize is within 3e-7 in f32 at every ratio of the
e2e graph and equal in bf16 at the nets' 2x upsamples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.config import LAYOUTS as JAX_LAYOUTS
from panodepth.ops import projection as jproj
from panodepth.ops import sampling as jsampling

from panodepth_torch.config import LAYOUTS as PORT_LAYOUTS
from panodepth_torch.ops import projection as tproj
from panodepth_torch.ops import resize as tresize
from panodepth_torch.ops import sampling as tsampling

from conftest import make_equirect

torch.set_num_threads(1)


def test_bilinear_sampler_matches_jax_at_seam_and_poles():
    rng = np.random.RandomState(0)
    img = rng.rand(16, 32, 3).astype(np.float32)
    # azimuths around and beyond the seam, zeniths beyond both poles
    azi = np.concatenate([rng.uniform(-1, 7.5, 400),
                          [0.0, 2 * np.pi, 2 * np.pi - 1e-4, -1e-4]])
    zen = np.concatenate([rng.uniform(-0.3, np.pi + 0.3, 400),
                          [0.0, np.pi, np.pi, 0.0]])
    azi, zen = azi.astype(np.float32), zen.astype(np.float32)
    want = np.asarray(jsampling.sample_equirect_bilinear(
        jnp.asarray(img), jnp.asarray(azi), jnp.asarray(zen)))
    got = tsampling.sample_equirect_bilinear(
        torch.tensor(img), torch.tensor(azi), torch.tensor(zen)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # (H, W) maps too, and the tap tables themselves
    want2 = np.asarray(jsampling.sample_equirect_bilinear(
        jnp.asarray(img[..., 0]), jnp.asarray(azi), jnp.asarray(zen)))
    got2 = tsampling.sample_equirect_bilinear(
        torch.tensor(img[..., 0]), torch.tensor(azi), torch.tensor(zen))
    np.testing.assert_allclose(got2.numpy(), want2, rtol=0, atol=1e-6)
    jt = jsampling._bilinear_coords(16, 32, jnp.asarray(azi), jnp.asarray(zen))
    tt = tsampling._bilinear_coords(16, 32, torch.tensor(azi),
                                    torch.tensor(zen))
    for a, b in zip(jt[:4], tt[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["5fold_leres", "5fold_midas", "4fold",
                                  "3fold"])
@pytest.mark.parametrize("width", [64, 256, 1024])
def test_view_shape_matches_jax(name, width):
    jl, tl = JAX_LAYOUTS[name](), PORT_LAYOUTS[name]()
    for v in range(jl.num_views):
        assert tproj.view_shape(tl.fovs[v], width) == \
            jproj.view_shape(jl.fovs[v], width)
    with pytest.raises(ValueError, match="FOV must be < 180"):
        tproj.view_shape((0.0, 3.2, 0.5, 1.0), width)


@pytest.mark.parametrize("name,width", [("5fold_leres", 64),
                                        ("5fold_leres", 256), ("3fold", 96)])
def test_extract_views_match_jax(name, width):
    smooth = np.stack([make_equirect(256, 128) * s + o for s, o in
                       ((0.9, 0.05), (0.7, 0.2), (0.5, 0.3))], -1)
    noise = np.random.RandomState(1).rand(128, 256, 3)
    jl, tl = JAX_LAYOUTS[name](), PORT_LAYOUTS[name]()
    for img, tol in ((smooth, 1e-5), (noise, 1e-4)):
        img = img.astype(np.float32)
        want = jproj.extract_views(jnp.asarray(img), jl, width)
        got = tproj.extract_views(torch.tensor(img), tl, width)
        assert len(got) == jl.num_views
        for w, g in zip(want, got):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=tol)


def test_extract_view_single_and_gray():
    img = make_equirect(128, 64).astype(np.float32)
    jl, tl = JAX_LAYOUTS["5fold_leres"](), PORT_LAYOUTS["5fold_leres"]()
    for v in (0, 7, 14):
        want = jproj.extract_view(jnp.asarray(img), jl.fovs[v], 64)
        got = tproj.extract_view(torch.tensor(img), tl.fovs[v], 64)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("src,dst", [((1024, 2048), (256, 512)),
                                     ((247, 256), (256, 256)),
                                     ((256, 256), (247, 256)),
                                     ((8, 16), (16, 32)),
                                     ((32, 64), (16, 32))])
def test_resize_bilinear_matches_jax_f32(src, dst):
    """The e2e graph's ratios: the baseline feed (2048 -> 512), the views to
    and from the CNN's 256x256, the nets' 2x upsample."""
    x = np.random.RandomState(2).rand(2, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       "bilinear"))
    got = tresize.resize_bilinear_nhwc(torch.tensor(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    # (N, H, W) maps, as the depth views are resized back
    want2 = np.asarray(jax.image.resize(jnp.asarray(x[..., 0]), (2, *dst),
                                        "bilinear"))
    got2 = tresize.resize_bilinear(torch.tensor(x[..., 0]), dst).numpy()
    np.testing.assert_allclose(got2, want2, rtol=0, atol=3e-7)


def test_resize_bilinear_bf16_upsample_is_exact():
    """bf16 2x upsample (the nets' decoders): JAX contracts width then
    height and rounds to bf16 in between; the port does the same."""
    x = np.random.RandomState(3).rand(2, 8, 16, 4).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.image.resize(jx, (2, 16, 32, 4), "bilinear")
                      .astype(jnp.float32))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    got = tresize.resize_bilinear_nhwc(tx, (16, 32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_upsample2_nearest_matches_jax():
    x = np.random.RandomState(4).rand(2, 3, 5, 7).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 10, 14),
                                       "nearest"))
    got = tresize.upsample2_nearest(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
