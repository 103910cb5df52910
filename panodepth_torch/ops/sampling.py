"""Nearest sampling with the reference's C truncation semantics.

Counterpart of the nearest samplers of ``panodepth/ops/sampling.py``.  The
reference samples nearest-neighbour through C float->int casts:

* ``PerspectiveMap::Value`` (Depth.cpp:111-118):
  ``X = (int)(x * (w-1)); Y = (int)(y * (h-1))``
* ``EquirectangularMap::ValueAtCoord`` (Depth.cpp:551-556):
  ``x = (int)(azi / 2pi * (w-1)); y = (int)(zen / pi * (h-1))``

kept here as truncate-toward-zero then clip.  Each function takes numpy
arrays or torch tensors.
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
