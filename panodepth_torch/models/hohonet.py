"""The HoHoNet-class panoramic baseline net, ``HorizonDepthNet``.

Counterpart of ``panodepth/models/hohonet.py`` (``HorizonAttention``,
``HorizonDepthNet``): a conv encoder squeezes the equirect image's height
into a sequence of W/16 horizon features, two circular self-attention
blocks mix it along the horizon, and a per-column decoder expands it back
to dense depth.  It takes (B, H, W, 3) RGB in [0, 1] and returns (B, H, W)
depth in 0~1; W % 32 == 0 and H % 16 == 0, and the decoder's
``Dense(H/16 * 32)`` fixes H to the checkpoint's (256 for the zoo's).
Inside, conv activations are NCHW and the sequence (B, W/16, C).

The 18 GroupNorms run the CUDA kernel on the card, down to the one-row
(B, 256, 1, W/16) activations of the height squeeze.  Attention, layer
norms and the GELU follow flax's numerics (``models/layers.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .. import graphs
from ..ops.resize import upsample2_nearest
from .layers import (Conv, Dense, LayerNorm, MultiHeadDotProductAttention,
                     gelu)
from .norm import GroupNorm
from .perspective import ResBlock, _groups

DECODER_WIDTHS = (64, 32, 16, 16)


def _position_features(w: int) -> np.ndarray:
    """(w, 4) f32 circular position features (sin, cos of the azimuth and
    of twice it), computed in numpy f32 as the JAX package computes them
    in f32."""
    pos = np.arange(w, dtype=np.float32) / np.float32(w) * np.float32(2) \
        * np.float32(np.pi)
    return np.stack([np.sin(pos), np.cos(pos), np.sin(2 * pos),
                     np.cos(2 * pos)], axis=-1)


@graphs.device_cache(maxsize=16)
def _position_on_device(w: int, device: torch.device, dtype):
    """:func:`_position_features` as a ``dtype`` tensor on ``device``."""
    return torch.from_numpy(_position_features(w)).to(device=device,
                                                      dtype=dtype)


class HorizonAttention(nn.Module):
    """Circular multi-head self-attention block along the horizon: the
    sequence with position features, layer norm, attention, a dense back
    to the width, then a GELU MLP; both residual."""

    def __init__(self, features: int, heads: int = 4, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        c = features
        self.LayerNorm_0 = LayerNorm(c + 4, dtype=dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            c + 4, heads, features, dtype=dtype)
        self.Dense_0 = Dense(c + 4, c, dtype)
        self.LayerNorm_1 = LayerNorm(c, dtype=dtype)
        self.Dense_1 = Dense(c, 2 * c, dtype)
        self.Dense_2 = Dense(2 * c, c, dtype)

    def forward(self, x):  # (B, W, C)
        b, w, _ = x.shape
        pe = _position_on_device(w, x.device, self.dtype)
        h = torch.cat([x, pe[None].expand(b, -1, -1)], -1)
        y = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(h))
        x = x + self.Dense_0(y)
        z = self.Dense_2(gelu(self.Dense_1(self.LayerNorm_1(x))))
        return x + z


class HorizonDepthNet(nn.Module):
    """HoHoNet-class: (B, H, W, 3) RGB in [0, 1] -> (B, H, W) depth in
    0~1."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 horizon_dim: int = 256, attn_blocks: int = 2,
                 dtype=torch.bfloat16, norm_dtype=torch.float32,
                 height: int = 256):
        super().__init__()
        self.dtype = dtype
        self.widths = tuple(widths)
        self.attn_blocks = attn_blocks
        self.height = height
        cin = 3
        for i, width in enumerate(widths):
            self.add_module(f"ResBlock_{i}", ResBlock(
                cin, width, stride=2, dtype=dtype, norm_dtype=norm_dtype))
            cin = width
        # the height squeeze: strided (s, 1) convs from H/16 rows to one
        convs, rows = [], height // 16
        while rows > 1:
            s = min(4, rows)
            convs.append((cin, horizon_dim, (s, 1)))
            cin, rows = horizon_dim, rows // s
        k = 0
        for cin, out, kernel in convs:
            self.add_module(f"Conv_{k}", Conv(cin, out, kernel, kernel,
                                              use_bias=False, dtype=dtype))
            self.add_module(f"GroupNorm_{k}", GroupNorm(
                out, _groups(out), fuse_relu=True, dtype=norm_dtype))
            k += 1
        self.squeeze = len(convs)
        for i in range(attn_blocks):
            self.add_module(f"HorizonAttention_{i}", HorizonAttention(
                horizon_dim, dtype=dtype))
        self.Dense_0 = Dense(horizon_dim, height // 16 * 32, dtype)
        cin = 32
        for width in DECODER_WIDTHS:
            self.add_module(f"Conv_{k}", Conv(cin, width, use_bias=False,
                                              dtype=dtype))
            self.add_module(f"GroupNorm_{k}", GroupNorm(
                width, _groups(width), fuse_relu=True, dtype=norm_dtype))
            cin, k = width, k + 1
        self.add_module(f"Conv_{k}", Conv(cin, 1, (1, 1),
                                          dtype=torch.float32))

    def forward(self, rgb):
        b, h, w, _ = rgb.shape
        if w % 32 != 0 or h % 16 != 0:
            raise ValueError(
                f"HorizonDepthNet needs W % 32 == 0 and H % 16 == 0 "
                f"(decoder upsamples H/16 by 16x), got ({h}, {w})")
        if h != self.height:
            raise ValueError(f"HorizonDepthNet's column decoder was built "
                             f"for H = {self.height}, got ({h}, {w})")
        x = rgb.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(len(self.widths)):
            x = getattr(self, f"ResBlock_{i}")(x)
        for k in range(self.squeeze):
            x = getattr(self, f"GroupNorm_{k}")(getattr(self, f"Conv_{k}")(x))
        seq = x[:, :, 0].transpose(1, 2)  # (B, W/16, C)
        for i in range(self.attn_blocks):
            seq = getattr(self, f"HorizonAttention_{i}")(seq)
        hs, ws = h // 16, w // 16
        # (B, W/16, hs*32) -> (B, 32, hs, W/16)
        y = self.Dense_0(seq).reshape(b, ws, hs, 32).permute(0, 3, 2, 1)
        k = self.squeeze
        for _ in DECODER_WIDTHS:
            y = getattr(self, f"Conv_{k}")(upsample2_nearest(y))
            y = getattr(self, f"GroupNorm_{k}")(y)
            k += 1
        return torch.sigmoid(getattr(self, f"Conv_{k}")(y)[:, 0])
