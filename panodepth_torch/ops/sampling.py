"""Equirect and perspective samplers.

Counterpart of the nearest and bilinear samplers of
``panodepth/ops/sampling.py`` (with ``sample_equirect_nearest_mc``, the
one-tap form of the bilinear sampler that the cubemap projections'
``taps="nearest"`` use).  The reference samples its depth maps
nearest-neighbour through C float->int casts:

* ``PerspectiveMap::Value`` (Depth.cpp:111-118):
  ``X = (int)(x * (w-1)); Y = (int)(y * (h-1))``
* ``EquirectangularMap::ValueAtCoord`` (Depth.cpp:551-556):
  ``x = (int)(azi / 2pi * (w-1)); y = (int)(zen / pi * (h-1))``

kept here as truncate-toward-zero then clip; these take numpy arrays or
torch tensors.  The bilinear sampler is the stage-A RGB warp, where the
reference relied on GL_LINEAR texture filtering (SphereMesh.cpp:58-88);
it takes tensors.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


def as01_post(x):
    """u16 -> f32 0~1 after a gather (floats pass through).

    Gather and the pointwise ``k / 65535`` commute exactly (u16 fits f32's
    mantissa), so 16-bit maps can be gathered first and normalized after.
    """
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32) / 65535.0 if x.dtype == torch.uint16 else x
    return x.astype(np.float32) / np.float32(65535.0) \
        if x.dtype == np.uint16 else x


def _trunc_index(v, n):
    """C-style (int) cast of ``v`` expected in [0, n-1], then clip."""
    if isinstance(v, torch.Tensor):
        return torch.clamp(v.to(torch.int64), 0, n - 1)
    return np.clip(v.astype(np.int64), 0, n - 1)


def sample_unit_nearest(img, x, y):
    """pmap.Value: channel 0 of ``img`` (H, W[, C]) at unit coords in [0, 1]."""
    if img.ndim == 3:
        img = img[..., 0]
    h, w = img.shape
    return img[_trunc_index(y * (h - 1), h), _trunc_index(x * (w - 1), w)]


def sample_equirect_nearest(img, azimuth, zenith):
    """emap.ValueAtCoord: an equirect map (H, W[, C]) at spherical coords."""
    if img.ndim == 3:
        img = img[..., 0]
    h, w = img.shape
    xi = _trunc_index(azimuth / TWO_PI * (w - 1), w)
    yi = _trunc_index(zenith / np.pi * (h - 1), h)
    return img[yi, xi]


def _bilinear_coords(h, w, azimuth, zenith):
    """Tap coordinates of the bilinear equirect sampler.

    Azimuth wraps at the seam, zenith clamps at the poles; texel centres
    follow the same (w-1)/(h-1) convention as the nearest samplers, so the
    two agree at exact pixel positions.  Returns (x0, x1, y0, y1, wx, wy),
    the weights shaped (..., 1).  Tensors only.
    """
    fx = (azimuth % TWO_PI) / TWO_PI * (w - 1)
    fy = torch.clamp(zenith / np.pi * (h - 1), 0.0, h - 1)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0 = torch.clamp(x0, 0, w - 1)
    x1 = (x0 + 1) % w  # azimuth wraps at the seam
    y0 = torch.clamp(y0, 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    return x0, x1, y0, y1, wx, wy


def bilinear_taps(img, taps):
    """Blend the four taps ``(x0, x1, y0, y1, wx, wy)`` of ``img`` (..., H,
    W, C), in the op order of the JAX sampler."""
    x0, x1, y0, y1, wx, wy = taps
    top = img[..., y0, x0, :] * (1 - wx) + img[..., y0, x1, :] * wx
    bot = img[..., y1, x0, :] * (1 - wx) + img[..., y1, x1, :] * wx
    return top * (1 - wy) + bot * wy


def sample_equirect_bilinear(img, azimuth, zenith):
    """Bilinear equirect sampling with azimuth wraparound (the stage-A RGB
    warp).  ``img`` is (H, W) or (H, W, C); see :func:`_bilinear_coords`."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    out = bilinear_taps(img, _bilinear_coords(h, w, azimuth, zenith))
    return out[..., 0] if squeeze else out


def nearest_of(taps):
    """The max-weight tap ``(x, y)`` of bilinear taps ``(x0, x1, y0, y1,
    wx, wy)``: x1 where wx >= 0.5, else x0 (likewise y)."""
    x0, x1, y0, y1, wx, wy = taps
    return (torch.where(wx[..., 0] >= 0.5, x1, x0),
            torch.where(wy[..., 0] >= 0.5, y1, y0))


def sample_equirect_nearest_mc(img, azimuth, zenith):
    """Multi-channel nearest equirect sampling with the bilinear sampler's
    tap convention (azimuth wrap included): the max-weight tap of each 2x2
    neighbourhood, one gather a pixel.  ``img`` is (H, W) or (H, W, C)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    xn, yn = nearest_of(_bilinear_coords(h, w, azimuth, zenith))
    out = img[yn, xn]
    return out[..., 0] if squeeze else out
