"""The UniFuse-class panoramic baseline nets, ``PanoBaselineNet`` and
``NFPanoBaselineNet``.

Counterpart of ``panodepth/models/panoramic.py`` (``SEGate``,
``UniFuseBlock``, ``NFUniFuseBlock``, ``PanoBaselineNet``,
``NFPanoBaselineNet``): an equirect encoder and a cubemap encoder (the six
faces of each panorama as one batch) whose per-level features are
projected back to the equirect grid and fused one way, cube -> equirect,
through a squeeze-excitation gate; a skip-connected decoder regresses
depth.  Both take (B, W/2, W, 3) RGB in [0, 1], W a multiple of 32, and
return (B, W/2, W) depth in 0~1; inside, activations are NCHW.

``proj="fast"`` gathers the cube features with one tap a pixel instead of
four (the same checkpoint).  The GN net's 31 GroupNorms run the CUDA
kernel on the card; the NF net has none.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cubemap import cube_to_equirect_nchw, equirect_to_cube_nchw
from ..ops.resize import resize_bilinear, upsample2_nearest
from .fastpano import GlobalContext
from .layers import Conv
from .norm import GroupNorm
from .perspective import NFResBlock, ResBlock, WSConv, _groups

PROJ = ("bilinear", "fast")


class SEGate(GlobalContext):
    """UniFuse's squeeze-excitation gate: FastPanoNet's ``GlobalContext``
    under its flax name."""


def check_pano(name: str, h: int, w: int):
    """The two-branch nets' input contract: (W/2, W), W % 32 == 0."""
    if w % 32 != 0 or h * 2 != w:
        raise ValueError(f"{name} needs an equirect (W/2, W) input with "
                         f"W % 32 == 0, got ({h}, {w})")


def to_cube(x):
    """(B, C, H, W) equirect -> (B*6, C, W/4, W/4) faces, bilinear."""
    return equirect_to_cube_nchw(x, x.shape[3] // 4)


class UniFuseBlock(nn.Module):
    """Unidirectional cube -> equirect fusion at one pyramid level."""

    def __init__(self, features: int, dtype=torch.bfloat16,
                 norm_dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(2 * features, features, use_bias=False,
                           dtype=dtype)
        self.GroupNorm_0 = GroupNorm(features, _groups(features),
                                     fuse_relu=True, dtype=norm_dtype)
        self.SEGate_0 = SEGate(features, dtype=dtype)

    def forward(self, equi, cube_equi):
        z = self.GroupNorm_0(self.Conv_0(torch.cat([equi, cube_equi], 1)))
        return equi + self.SEGate_0(z)


class NFUniFuseBlock(nn.Module):
    """Normalizer-free fusion: a WS conv and ReLU in place of conv + norm."""

    def __init__(self, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.WSConv_0 = WSConv(2 * features, features, dtype=dtype,
                               gain_act=1.0)
        self.SEGate_0 = SEGate(features, dtype=dtype)

    def forward(self, equi, cube_equi):
        z = torch.relu(self.WSConv_0(torch.cat([equi, cube_equi], 1)))
        return equi + self.SEGate_0(z)


class PanoBaselineNet(nn.Module):
    """UniFuse-class: (B, W/2, W, 3) RGB in [0, 1] -> (B, W/2, W) depth in
    0~1."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 dtype=torch.bfloat16, norm_dtype=torch.float32,
                 proj: str = "bilinear"):
        super().__init__()
        if proj not in PROJ:
            raise ValueError(f"proj must be one of {PROJ}, got {proj!r}")
        self.dtype = dtype
        self.taps = "nearest" if proj == "fast" else "bilinear"
        self.widths = tuple(widths)
        kw = dict(dtype=dtype, norm_dtype=norm_dtype)
        cin = 3
        for i, width in enumerate(widths):
            self.add_module(f"ResBlock_{2 * i}",
                            ResBlock(cin, width, stride=2, **kw))
            self.add_module(f"ResBlock_{2 * i + 1}",
                            ResBlock(cin, width, stride=2, **kw))
            self.add_module(f"UniFuseBlock_{i}", UniFuseBlock(width, **kw))
            cin = width
        for k, (cin, out) in enumerate(zip(widths[:0:-1], widths[-2::-1])):
            self.add_module(f"Conv_{k}", Conv(cin, out, use_bias=False,
                                              dtype=dtype))
            self.add_module(f"GroupNorm_{k}", GroupNorm(
                out, _groups(out), fuse_relu=True, dtype=norm_dtype))
        n = len(widths) - 1
        self.add_module(f"Conv_{n}", Conv(widths[0], 32, dtype=dtype))
        self.add_module(f"Conv_{n + 1}", Conv(32, 1, (1, 1),
                                              dtype=torch.float32))

    def forward(self, rgb):
        b, h, w, _ = rgb.shape
        check_pano(type(self).__name__, h, w)
        e = rgb.permute(0, 3, 1, 2).to(self.dtype)
        c = to_cube(e)
        skips = []
        for i in range(len(self.widths)):
            e = getattr(self, f"ResBlock_{2 * i}")(e)
            c = getattr(self, f"ResBlock_{2 * i + 1}")(c)
            c2e = cube_to_equirect_nchw(c, e.shape[2], e.shape[3], self.taps)
            e = getattr(self, f"UniFuseBlock_{i}")(e, c2e)
            skips.append(e)
        y = skips[-1]
        for k, skip in enumerate(reversed(skips[:-1])):
            y = getattr(self, f"Conv_{k}")(upsample2_nearest(y))
            y = getattr(self, f"GroupNorm_{k}")(y) + skip
        n = len(self.widths) - 1
        y = resize_bilinear(y, (y.shape[2] * 2, y.shape[3] * 2))
        y = torch.relu(getattr(self, f"Conv_{n}")(y))
        return torch.sigmoid(getattr(self, f"Conv_{n + 1}")(y)[:, 0])


class NFPanoBaselineNet(nn.Module):
    """Normalizer-free PanoBaselineNet: NFResBlocks, WS convs and no norm;
    the cube features always come back bilinear."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 dtype=torch.bfloat16, norm_dtype=torch.float32):
        super().__init__()  # norm_dtype: accepted and unused, as in JAX
        self.dtype = dtype
        self.widths = tuple(widths)
        cin = 3
        for i, width in enumerate(widths):
            for j in (2 * i, 2 * i + 1):
                self.add_module(f"NFResBlock_{j}", NFResBlock(
                    cin, width, stride=2, dtype=dtype))
            self.add_module(f"NFUniFuseBlock_{i}",
                            NFUniFuseBlock(width, dtype=dtype))
            cin = width
        for k, (cin, out) in enumerate(zip(widths[:0:-1], widths[-2::-1])):
            self.add_module(f"WSConv_{k}", WSConv(cin, out, dtype=dtype,
                                                  gain_act=1.0))
        n = len(widths) - 1
        self.add_module(f"WSConv_{n}", WSConv(widths[0], 32, dtype=dtype))
        self.Conv_0 = Conv(32, 1, (1, 1), dtype=torch.float32)

    def forward(self, rgb):
        b, h, w, _ = rgb.shape
        check_pano(type(self).__name__, h, w)
        e = rgb.permute(0, 3, 1, 2).to(self.dtype)
        c = to_cube(e)
        skips = []
        for i in range(len(self.widths)):
            e = getattr(self, f"NFResBlock_{2 * i}")(e)
            c = getattr(self, f"NFResBlock_{2 * i + 1}")(c)
            c2e = cube_to_equirect_nchw(c, e.shape[2], e.shape[3])
            e = getattr(self, f"NFUniFuseBlock_{i}")(e, c2e)
            skips.append(e)
        y = skips[-1]
        for k, skip in enumerate(reversed(skips[:-1])):
            y = getattr(self, f"WSConv_{k}")(upsample2_nearest(y))
            y = torch.relu(y) + skip
        n = len(self.widths) - 1
        y = resize_bilinear(y, (y.shape[2] * 2, y.shape[3] * 2))
        y = torch.relu(getattr(self, f"WSConv_{n}")(y))
        return torch.sigmoid(self.Conv_0(y)[:, 0])
