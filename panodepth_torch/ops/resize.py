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

A bf16 downsample (the baseline feed of every extraction table but
``f32``) follows JAX further: its weight matrix, computed in f32 as
``jax.image.scale_and_translate`` computes it, is rounded to bf16 (the
antialiased weights at the borders are not bf16 numbers), each axis is
contracted in f32 and rounded to bf16, and the axes go in the order
``jnp.einsum``'s path takes them (the cheaper first).  Equal to JAX at the
e2e graph's ratios.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import graphs


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


@functools.lru_cache(maxsize=32)
def _jax_weights(m: int, n: int) -> np.ndarray:
    """(m, n) triangle-filter weights of a resize from m to n samples, in
    f32 op by op as ``jax._src.image.scale.compute_weight_mat`` (antialias
    on, no translation)."""
    f32 = np.float32
    inv_scale = 1.0 / (n / m)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@graphs.device_cache(maxsize=32)
def _bf16_weights(m: int, n: int, device: torch.device):
    """:func:`_jax_weights` rounded to bf16 (as JAX casts them to the
    image's type), held in f32 on ``device``."""
    return torch.from_numpy(_jax_weights(m, n)).to(torch.bfloat16).to(
        device).to(torch.float32)


def _resize_bf16_jax(x, size):
    """JAX's bf16 resize of the (N, C, H, W) bf16 tensor ``x``: bf16
    weights, each axis contracted in f32 and rounded to bf16, the axis
    whose contraction costs less first (``jnp.einsum``'s path)."""
    hin, win = x.shape[2:]
    h, w = size

    def along_h(y):
        wt = _bf16_weights(hin, h, y.device)
        return torch.matmul(wt.T, y.to(torch.float32)).to(torch.bfloat16)

    def along_w(y):
        wt = _bf16_weights(win, w, y.device)
        return torch.matmul(y.to(torch.float32), wt).to(torch.bfloat16)

    steps = []
    if hin != h:
        steps.append((hin * win * h + h * win * w, along_h))
    if win != w:
        steps.append((hin * win * w + hin * w * h, along_w))
    # the path's cost: the first contraction over the full image, the
    # second over its result; ties keep the width first
    steps.sort(key=lambda s: (s[0], s[1] is along_h))
    for _, step in steps:
        x = step(x)
    return x


def resize_bilinear(x, size):
    """Resize the last two (spatial) dims of an (N, H, W) or (N, C, H, W)
    tensor to ``size`` = (h, w), as ``jax.image.resize(..., "bilinear")``."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, None]
    h, w = size
    if x.dtype == torch.bfloat16 and (h < x.shape[2] or w < x.shape[3]):
        y = _resize_bf16_jax(x, size)
    else:
        y = _resize_axis(_resize_axis(x, w, 3), h, 2)
    return y[:, 0] if squeeze else y


def resize_bilinear_nhwc(x, size):
    """:func:`resize_bilinear` of an (N, H, W, C) image stack."""
    return resize_bilinear(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def upsample2_nearest(x):
    """Nearest 2x upsample of the last two dims (``jax.image.resize(...,
    "nearest")`` at exactly twice the size: output i reads input i // 2)."""
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)
