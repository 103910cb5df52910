"""The BiFuse-class panoramic baseline net, ``BiFuseNet``.

Counterpart of ``panodepth/models/bifuse.py`` (``BiProjFusion``,
``_Decoder``, ``BiFuseNet``): an equirect branch and a cubemap branch (the
six faces of each panorama as one batch) exchange features both ways at
every pyramid level, each branch decodes to features at its own
resolution, and a learned per-pixel weight map blends the two depth
heads.  It takes (B, W/2, W, 3) RGB in [0, 1], W a multiple of 32, and
returns (B, W/2, W) depth in 0~1; inside, activations are NCHW.

``proj="fast"`` is the same checkpoint with one-tap feature projections at
every level and the cube decoder's output brought back at half
resolution, then resized.  The 38 GroupNorms run the CUDA kernel on the
card.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cubemap import cube_to_equirect_nchw, equirect_to_cube_nchw
from ..ops.resize import resize_bilinear, upsample2_nearest
from .layers import Conv
from .norm import GroupNorm
from .panoramic import PROJ, check_pano, to_cube
from .perspective import ResBlock, _groups


class BiProjFusion(nn.Module):
    """Bidirectional fusion at one level: each branch sees [own features,
    the other branch's projected into its domain] and adds ``tanh(z) *
    sigmoid(gate)``; the children keep flax's explicit names."""

    def __init__(self, features: int, dtype=torch.bfloat16,
                 norm_dtype=torch.float32, taps: str = "bilinear"):
        super().__init__()
        self.taps = taps
        f = features
        for side in ("equi", "cube"):
            self.add_module(f"{side}_mix", Conv(2 * f, f, use_bias=False,
                                                dtype=dtype))
            self.add_module(f"{side}_gn", GroupNorm(f, _groups(f),
                                                    dtype=norm_dtype))
            self.add_module(f"{side}_gate", Conv(f, f, (1, 1), dtype=dtype))

    def _gated(self, own, other, side):
        z = getattr(self, f"{side}_mix")(torch.cat([own, other], 1))
        z = getattr(self, f"{side}_gn")(z)
        gate = getattr(self, f"{side}_gate")(z)
        return own + torch.tanh(z) * torch.sigmoid(gate)

    def forward(self, e, c):
        c2e = cube_to_equirect_nchw(c, e.shape[2], e.shape[3], self.taps)
        e2c = equirect_to_cube_nchw(e, c.shape[2], self.taps)
        return self._gated(e, c2e, "equi"), self._gated(c, e2c, "cube")


class _Decoder(nn.Module):
    """Skip-connected nearest-up decoder of one branch, ending in a
    bilinear 2x resize and a 32-wide conv + ReLU."""

    def __init__(self, widths: Sequence[int], dtype=torch.bfloat16,
                 norm_dtype=torch.float32):
        super().__init__()
        self.levels = len(widths) - 1
        for k, (cin, out) in enumerate(zip(widths[:0:-1], widths[-2::-1])):
            self.add_module(f"Conv_{k}", Conv(cin, out, use_bias=False,
                                              dtype=dtype))
            self.add_module(f"GroupNorm_{k}", GroupNorm(
                out, _groups(out), fuse_relu=True, dtype=norm_dtype))
        self.add_module(f"Conv_{self.levels}", Conv(widths[0], 32,
                                                    dtype=dtype))

    def forward(self, skips):
        y = skips[-1]
        for k, skip in enumerate(reversed(skips[:-1])):
            y = getattr(self, f"Conv_{k}")(upsample2_nearest(y))
            y = getattr(self, f"GroupNorm_{k}")(y) + skip
        y = resize_bilinear(y, (y.shape[2] * 2, y.shape[3] * 2))
        return torch.relu(getattr(self, f"Conv_{self.levels}")(y))


class BiFuseNet(nn.Module):
    """BiFuse-class: (B, W/2, W, 3) RGB in [0, 1] -> (B, W/2, W) depth in
    0~1."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 dtype=torch.bfloat16, norm_dtype=torch.float32,
                 proj: str = "bilinear"):
        super().__init__()
        if proj not in PROJ:
            raise ValueError(f"proj must be one of {PROJ}, got {proj!r}")
        self.dtype = dtype
        self.fast = proj == "fast"
        self.widths = tuple(widths)
        kw = dict(dtype=dtype, norm_dtype=norm_dtype)
        cin = 3
        for i, width in enumerate(widths):
            self.add_module(f"ResBlock_{2 * i}",
                            ResBlock(cin, width, stride=2, **kw))
            self.add_module(f"ResBlock_{2 * i + 1}",
                            ResBlock(cin, width, stride=2, **kw))
            self.add_module(f"BiProjFusion_{i}", BiProjFusion(
                width, taps="nearest" if self.fast else "bilinear", **kw))
            cin = width
        self._Decoder_0 = _Decoder(widths, **kw)
        self._Decoder_1 = _Decoder(widths, **kw)
        self.head_equi = Conv(32, 1, (1, 1), dtype=torch.float32)
        self.head_cube = Conv(32, 1, (1, 1), dtype=torch.float32)
        self.fuse_weight = Conv(64, 1, (3, 3), dtype=torch.float32)

    def forward(self, rgb):
        b, h, w, _ = rgb.shape
        check_pano(type(self).__name__, h, w)
        # the RGB image goes to the cube bilinear in both forms
        e = rgb.permute(0, 3, 1, 2).to(self.dtype)
        c = to_cube(e)
        equi_skips, cube_skips = [], []
        for i in range(len(self.widths)):
            e = getattr(self, f"ResBlock_{2 * i}")(e)
            c = getattr(self, f"ResBlock_{2 * i + 1}")(c)
            e, c = getattr(self, f"BiProjFusion_{i}")(e, c)
            equi_skips.append(e)
            cube_skips.append(c)
        ye = self._Decoder_0(equi_skips)   # (B, 32, H, W)
        yc = self._Decoder_1(cube_skips)   # (B*6, 32, S, S)
        if self.fast:
            yc_e = resize_bilinear(
                cube_to_equirect_nchw(yc, h // 2, w // 2, "nearest"), (h, w))
        else:
            yc_e = cube_to_equirect_nchw(yc, h, w)
        de = self.head_equi(ye)[:, 0]
        dc = self.head_cube(yc_e)[:, 0]
        m = torch.sigmoid(self.fuse_weight(torch.cat([ye, yc_e], 1))[:, 0])
        return torch.sigmoid(m * de + (1.0 - m) * dc)
