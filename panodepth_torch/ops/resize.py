"""Image resizes with the numerics of ``jax.image.resize``.

Counterpart of the ``jax.image.resize`` calls of the JAX package's e2e
graph and nets (``e2e.py:95,110,115,330,373,377``,
``models/perspective.py:292,356``, ``models/fastpano.py:116,153``).

``"bilinear"`` in JAX is a triangle filter that antialiases when it
downsamples, and it contracts the width axis first, then the height axis,
rounding to the input's type in between.  :func:`resize_bilinear` does the
same with ``F.interpolate(..., antialias=True)`` one axis at a time: within
2e-7 of JAX in f32 at every ratio of the e2e graph and equal in bf16 at
the nets' 2x upsamples (``tests/test_torch_projection.py``).  Without
``antialias`` the baseline feed (2048 -> 512) would be off by up to 0.46.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize_axis(x, size, axis):
    """Triangle-filter resize of the (N, C, H, W) tensor ``x`` along one
    spatial axis (2 = H, 3 = W), computed in f32, rounded to ``x``'s type."""
    shape = list(x.shape[2:])
    if shape[axis - 2] == size:
        return x
    shape[axis - 2] = size
    y = F.interpolate(x.to(torch.float32), size=tuple(shape), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


def resize_bilinear(x, size):
    """Resize the last two (spatial) dims of an (N, H, W) or (N, C, H, W)
    tensor to ``size`` = (h, w), as ``jax.image.resize(..., "bilinear")``."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, None]
    h, w = size
    y = _resize_axis(_resize_axis(x, w, 3), h, 2)
    return y[:, 0] if squeeze else y


def resize_bilinear_nhwc(x, size):
    """:func:`resize_bilinear` of an (N, H, W, C) image stack."""
    return resize_bilinear(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def upsample2_nearest(x):
    """Nearest 2x upsample of the last two dims (``jax.image.resize(...,
    "nearest")`` at exactly twice the size: output i reads input i // 2)."""
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)
