"""The panoramic baseline CNN, ``FastPanoNet``.

Counterpart of ``panodepth/models/fastpano.py`` (``CircConv``,
``CircResBlock``, ``CircFusionBlock``, ``GlobalContext``,
``_circ_upsample2_bilinear``, ``_latitude_features``, ``FastPanoNet``;
fastpano.py:43-226): a single-branch equirect U-Net with circular padding
on every conv's width axis (the seam sees its true neighbourhood), fixed
latitude channels and a squeeze-excitation gate at the bottleneck.  It
takes (B, W/2, W, 3) RGB in [0, 1] and returns (B, W/2, W) depth in 0~1;
inside, activations are NCHW.

Its 29 GroupNorms (``models/norm.py``) run the CUDA kernel on the card.
Types follow the JAX net: convs compute in ``dtype`` (bf16 by default),
the norms return ``norm_dtype`` (f32 off the TPU, so the residual stream
is f32), the head is f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import graphs
from ..ops.resize import resize_bilinear, upsample2_nearest
from .layers import Conv, Dense
from .norm import GroupNorm
from .perspective import _groups


class CircConv(nn.Module):
    """Conv with circular padding on the width (azimuth) axis and zero
    padding on the height axis; its flax conv is the child ``conv``."""

    def __init__(self, cin: int, features: int, kernel=(3, 3), strides=(1, 1),
                 use_bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        kh, kw = kernel
        self.pw = (kw - 1) // 2
        ph = (kh - 1) // 2
        self.conv = Conv(cin, features, kernel, strides,
                         padding=((ph, ph), (0, 0)), use_bias=use_bias,
                         dtype=dtype)

    def forward(self, x):
        pw = self.pw
        if pw:
            x = torch.cat([x[..., -pw:], x, x[..., :pw]], dim=3)
        return self.conv(x)


class CircResBlock(nn.Module):
    """ResBlock with circular azimuth padding: conv, norm + ReLU, conv,
    norm, a 1x1 conv + norm shortcut on a transition, ReLU of the sum."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.bfloat16, norm_dtype=torch.float32):
        super().__init__()
        g = _groups(features)
        s = (stride, stride)
        self.CircConv_0 = CircConv(cin, features, (3, 3), s, use_bias=False,
                                   dtype=dtype)
        self.GroupNorm_0 = GroupNorm(features, g, fuse_relu=True,
                                     dtype=norm_dtype)
        self.CircConv_1 = CircConv(features, features, use_bias=False,
                                   dtype=dtype)
        self.GroupNorm_1 = GroupNorm(features, g, dtype=norm_dtype)
        self.transition = cin != features or stride != 1
        if self.transition:
            self.Conv_0 = Conv(cin, features, (1, 1), s, use_bias=False,
                               dtype=dtype)
            self.GroupNorm_2 = GroupNorm(features, g, dtype=norm_dtype)

    def forward(self, x):
        y = self.GroupNorm_0(self.CircConv_0(x))
        y = self.GroupNorm_1(self.CircConv_1(y))
        if self.transition:
            x = self.GroupNorm_2(self.Conv_0(x))
        return torch.relu(y + x)


class CircFusionBlock(nn.Module):
    """Decoder block: nearest 2x upsample, conv, the skip's conv added, then
    a CircResBlock."""

    def __init__(self, cin: int, features: int, skip: Optional[int],
                 dtype=torch.bfloat16, norm_dtype=torch.float32):
        super().__init__()
        self.CircConv_0 = CircConv(cin, features, dtype=dtype)
        self.CircConv_1 = (CircConv(skip, features, use_bias=False,
                                    dtype=dtype)
                           if skip is not None else None)
        self.CircResBlock_0 = CircResBlock(features, features, dtype=dtype,
                                           norm_dtype=norm_dtype)

    def forward(self, x, skip=None):
        x = self.CircConv_0(upsample2_nearest(x))
        if skip is not None:
            x = x + self.CircConv_1(skip)
        return self.CircResBlock_0(x)


class GlobalContext(nn.Module):
    """Squeeze-excitation gate: the global mean of each channel through a
    two-layer MLP (in ``dtype``) scales the channel by its sigmoid."""

    def __init__(self, features: int, dtype=torch.bfloat16):
        super().__init__()
        hidden = max(features // 4, 8)
        self.Dense_0 = Dense(features, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, features, dtype=dtype)

    def forward(self, x):
        s = x.mean((2, 3))
        s = self.Dense_1(torch.relu(self.Dense_0(s)))
        return x * torch.sigmoid(s)[:, :, None, None]


def _circ_upsample2_bilinear(y):
    """Bilinear 2x upsample that wraps in azimuth: one wrap column padded
    each side before the resize, two cropped after."""
    h, w = y.shape[-2:]
    yp = torch.cat([y[..., -1:], y, y[..., :1]], dim=-1)
    return resize_bilinear(yp, (h * 2, (w + 2) * 2))[..., 2:-2]


def _latitude_features(h: int, w: int) -> np.ndarray:
    """(2, h, w) f32 per-row distortion cue: (cos zen, sin zen) at row
    centres, computed in numpy f32 as the JAX package does."""
    zen = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
    row = np.stack([np.cos(zen), np.sin(zen)], axis=0)  # (2, h)
    return np.ascontiguousarray(np.broadcast_to(row[:, :, None], (2, h, w)))


@graphs.device_cache(maxsize=16)
def _latitude_on_device(h: int, w: int, device: torch.device, dtype):
    """:func:`_latitude_features` as a ``dtype`` tensor on ``device``, made
    once: a per-call host-to-device copy would stop a CUDA graph's
    capture."""
    return torch.from_numpy(_latitude_features(h, w)).to(device=device,
                                                          dtype=dtype)


class FastPanoNet(nn.Module):
    """(B, W/2, W, 3) equirect RGB in [0, 1] -> (B, W/2, W) depth in 0~1."""

    def __init__(self, widths: Sequence[int] = (48, 96, 192, 384),
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 decoder_width: int = 96, dtype=torch.bfloat16,
                 norm_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        stem = widths[0] // 2
        self.CircConv_0 = CircConv(5, stem, (5, 5), (2, 2), use_bias=False,
                                   dtype=dtype)
        self.GroupNorm_0 = GroupNorm(stem, _groups(stem), fuse_relu=True,
                                     dtype=norm_dtype)
        cin, k = stem, 0
        for blocks, width in zip(stage_sizes, widths):
            for i in range(blocks):
                self.add_module(f"CircResBlock_{k}", CircResBlock(
                    cin, width, stride=2 if i == 0 else 1, dtype=dtype,
                    norm_dtype=norm_dtype))
                cin, k = width, k + 1
        self.GlobalContext_0 = GlobalContext(widths[-1], dtype=dtype)
        self.CircConv_1 = CircConv(widths[-1], decoder_width, use_bias=False,
                                   dtype=dtype)
        skips = list(reversed(widths[:-1])) + [None]
        for k, skip in enumerate(skips):
            self.add_module(f"CircFusionBlock_{k}", CircFusionBlock(
                decoder_width, decoder_width, skip, dtype=dtype,
                norm_dtype=norm_dtype))
        self.CircConv_2 = CircConv(decoder_width, decoder_width // 2,
                                   dtype=dtype)
        self.CircConv_3 = CircConv(decoder_width // 2, 32, dtype=dtype)
        self.Conv_0 = Conv(32, 1, (1, 1), dtype=torch.float32)

    def forward(self, rgb):
        b, h, w, _ = rgb.shape
        # the JAX net checks only w % 32 and fails inside its decoder when
        # w % 64 != 0 (its five halvings and four doublings disagree)
        if w % 64 != 0 or h != w // 2:
            raise ValueError(f"FastPanoNet needs an equirect (W/2, W) input "
                             f"with W % 64 == 0, got ({h}, {w})")
        x = rgb.permute(0, 3, 1, 2).to(self.dtype)
        lat = _latitude_on_device(h, w, x.device, self.dtype)
        x = torch.cat([x, lat[None].expand(b, -1, -1, -1)], dim=1)
        x = self.GroupNorm_0(self.CircConv_0(x))
        skips, k = [], 0
        for blocks in self.stage_sizes:
            for _ in range(blocks):
                x = getattr(self, f"CircResBlock_{k}")(x)
                k += 1
            skips.append(x)
        x = self.GlobalContext_0(x)
        y = self.CircConv_1(x)
        for k, skip in enumerate(list(reversed(skips[:-1])) + [None]):
            y = getattr(self, f"CircFusionBlock_{k}")(y, skip)
        y = torch.relu(self.CircConv_2(y))
        y = _circ_upsample2_bilinear(y)
        y = torch.relu(self.CircConv_3(y))
        return torch.sigmoid(self.Conv_0(y)[:, 0])
