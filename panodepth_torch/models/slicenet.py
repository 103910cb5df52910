"""The SliceNet-class panoramic baseline net, ``SliceNet``.

Counterpart of ``panodepth/models/slicenet.py`` (``CircularBiGRU``,
``SliceNet``): a conv encoder whose last three levels are pooled over the
height into per-column slice features and summed at W/16 columns, two
bidirectional GRU layers over the circular column sequence, and a decoder
that rebuilds dense depth from the sequence alone (no encoder skips).  It
takes (B, H, W, 3) RGB in [0, 1] and returns (B, H, W) depth in 0~1;
W % 32 == 0 and H % 16 == 0, and the decoder's ``Dense(H/16 * 32)`` fixes
H to the checkpoint's (256 for the zoo's).  Inside, conv activations are
NCHW and the sequence (B, W/16, C).

The 16 GroupNorms run the CUDA kernel on the card, with a group size of 1
at the 16-wide last level.  The GRU runs 32 + 2 * 8 steps per direction
and layer at 512 wide (``layers.GRUCell``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.resize import upsample2_nearest
from .layers import Conv, Dense, GRUCell, LayerNorm, mean_f32
from .norm import GroupNorm
from .perspective import ResBlock, _groups

DECODER_WIDTHS = (128, 64, 32, 16)


class CircularBiGRU(nn.Module):
    """Bidirectional GRU over a circular (B, W, C) sequence: ``wrap``
    columns of each end are put on the other before the recurrence and
    cropped after, so the seam sees real context; a dense layer maps the
    two directions back to ``features``."""

    def __init__(self, features: int, wrap: int = 8, dtype=torch.bfloat16):
        super().__init__()
        self.wrap = wrap
        self.GRUCell_0 = GRUCell(features, features, dtype)
        self.GRUCell_1 = GRUCell(features, features, dtype)
        self.Dense_0 = Dense(2 * features, features, dtype)

    def forward(self, x):
        w = x.shape[1]
        k = min(self.wrap, w)
        xw = torch.cat([x[:, w - k:], x, x[:, :k]], 1)
        y = torch.cat([self.GRUCell_0.scan(xw),
                       self.GRUCell_1.scan(xw, reverse=True)], -1)
        return self.Dense_0(y[:, k:k + w])


class SliceNet(nn.Module):
    """SliceNet-class: (B, H, W, 3) RGB in [0, 1] -> (B, H, W) depth in
    0~1."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 slice_dim: int = 256, rnn_layers: int = 2,
                 dtype=torch.bfloat16, norm_dtype=torch.float32,
                 height: int = 256):
        super().__init__()
        self.dtype = dtype
        self.widths = tuple(widths)
        self.slice_dim = slice_dim
        self.rnn_layers = rnn_layers
        self.height = height
        cin = 3
        for i, width in enumerate(widths):
            self.add_module(f"ResBlock_{i}", ResBlock(
                cin, width, stride=2, dtype=dtype, norm_dtype=norm_dtype))
            cin = width
        for i, width in enumerate(widths[-3:]):
            self.add_module(f"Dense_{i}", Dense(2 * width, slice_dim, dtype))
        self.LayerNorm_0 = LayerNorm(slice_dim, dtype=dtype)
        for i in range(rnn_layers):
            self.add_module(f"CircularBiGRU_{i}",
                            CircularBiGRU(slice_dim, dtype=dtype))
        self.add_module("Dense_3", Dense(slice_dim, height // 16 * 32, dtype))
        cin = 32
        for k, width in enumerate(DECODER_WIDTHS):
            self.add_module(f"Conv_{k}", Conv(cin, width, use_bias=False,
                                              dtype=dtype))
            self.add_module(f"GroupNorm_{k}", GroupNorm(
                width, _groups(width), fuse_relu=True, dtype=norm_dtype))
            cin = width
        self.add_module(f"Conv_{len(DECODER_WIDTHS)}",
                        Conv(cin, 1, (1, 1), dtype=torch.float32))

    def forward(self, rgb):
        b, h, w, _ = rgb.shape
        if w % 32 != 0 or h % 16 != 0:
            raise ValueError(
                f"SliceNet needs W % 32 == 0 and H % 16 == 0 "
                f"(decoder expands H/16 by 16x), got ({h}, {w})")
        if h != self.height:
            raise ValueError(f"SliceNet's column decoder was built for H = "
                             f"{self.height}, got ({h}, {w})")
        x = rgb.permute(0, 3, 1, 2).to(self.dtype)
        levels = []
        for i in range(len(self.widths)):
            x = getattr(self, f"ResBlock_{i}")(x)
            levels.append(x)
        ws = w // 16
        seq = torch.zeros(b, ws, self.slice_dim, dtype=self.dtype,
                          device=x.device)
        for i, lvl in enumerate(levels[-3:]):
            # per column: the mean and the max over the height, (B, W', 2C)
            cols = torch.cat([mean_f32(lvl, (2,)), lvl.amax(2)], 1)
            cols = getattr(self, f"Dense_{i}")(cols.transpose(1, 2))
            stride = cols.shape[1] // ws
            if stride > 1:  # width-pool the finer levels to W/16 columns
                cols = mean_f32(cols.reshape(b, ws, stride, self.slice_dim),
                                (2,))
            seq = seq + cols
        seq = self.LayerNorm_0(seq)
        for i in range(self.rnn_layers):
            seq = seq + getattr(self, f"CircularBiGRU_{i}")(seq)
        hs = h // 16
        # (B, W/16, hs*32) -> (B, 32, hs, W/16)
        y = self.Dense_3(seq).reshape(b, ws, hs, 32).permute(0, 3, 2, 1)
        for k in range(len(DECODER_WIDTHS)):
            y = getattr(self, f"Conv_{k}")(upsample2_nearest(y))
            y = getattr(self, f"GroupNorm_{k}")(y)
        return torch.sigmoid(
            getattr(self, f"Conv_{len(DECODER_WIDTHS)}")(y)[:, 0])
