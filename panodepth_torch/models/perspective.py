"""The perspective depth CNNs, ``PerspectiveDepthNet`` (GroupNorm) and
``NFPerspectiveNet`` (normalizer-free).

Counterpart of ``panodepth/models/perspective.py`` (``_groups``,
``ResBlock``, ``FusionBlock``, ``PerspectiveDepthNet``, ``WSConv``,
``NFResBlock``, ``NFFusionBlock``, ``NFPerspectiveNet``, ``_percentile99``,
``predict_depth01``; perspective.py:29, 80-415): the on-device replacement
of the reference's external LeReS/MiDaS CNN (``Main.cpp:465-474``), a
ResNet encoder with a RefineNet decoder.  Both take (B, H, W, 3) RGB in
[0, 1], H and W multiples of 32, and return (B, H, W) positive values;
inside, activations are NCHW.  ``ResBlock`` is also the encoder block of
every panoramic family but FastPanoNet.  ``quantized=True`` builds the
int8 graph of the GN net (JAX's ``quantized=True``): every conv but the
output head a ``layers.QConv``, named as flax names it (``QConv_i``, the
head ``Conv_0``); its weights come from a float net through
``models/quantize.py``.

The numerics are the JAX package's, including where they are odd:

* ``dtype`` (bf16 by default, as in JAX; f32 for tight tests) is the conv
  compute type; the output head is f32.
* The scalar factors of the residual stream (``1/beta``, ``alpha``,
  ``1/sqrt(2)``) are rounded to ``dtype`` first (0.2 becomes 0.2001953 in
  bf16), as ``jnp.asarray(v, dtype)`` rounds them.
* A conv adds its bias after its output is rounded to ``dtype``
  (``layers.Conv``), with lax's asymmetric SAME padding at stride 2.
* The weight standardisation depends on the weights only, so it is done
  once per set of weights (in f32 on the device, then cast), not per call.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear, upsample2_nearest
from .layers import (Conv, Derived, QConv, same_pads, softplus,
                     train_layout, variance_scaling_)
from .norm import GroupNorm


# the perspective nets' head bias at init (panodepth/models/perspective.py
# bias_init=constant(-1.8)): with softplus(0) the first prediction is ~5x
# the target's mean, and AdamW then shrinks every layer until softplus
# underflows and training freezes
HEAD_BIAS = -1.8


def _groups(channels: int, target: int = 32) -> int:
    """A divisor of ``channels`` close to ``target`` (for GroupNorm)."""
    return math.gcd(channels, target)


def _conv_prefix(quantized: bool) -> str:
    """flax's name of a block's convs: ``QConv_i`` in the int8 graph."""
    return "QConv_" if quantized else "Conv_"


def _conv(quantized: bool, *args, **kwargs):
    """A ``QConv`` in the int8 graph, else a ``Conv``."""
    return (QConv if quantized else Conv)(*args, **kwargs)


class ResBlock(nn.Module):
    """Conv, norm + ReLU, conv, norm, a 1x1 conv + norm shortcut on a
    transition (stride or width change), ReLU of the sum; lax SAME
    padding.  The norms return ``norm_dtype``; ``quantized`` makes the
    convs int8 ``QConv``s."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.bfloat16, norm_dtype=torch.float32,
                 quantized: bool = False):
        super().__init__()
        g = _groups(features)
        s = (stride, stride)
        c = self._prefix = _conv_prefix(quantized)
        self.add_module(c + "0", _conv(quantized, cin, features, (3, 3), s,
                                       use_bias=False, dtype=dtype))
        self.GroupNorm_0 = GroupNorm(features, g, fuse_relu=True,
                                     dtype=norm_dtype)
        self.add_module(c + "1", _conv(quantized, features, features,
                                       use_bias=False, dtype=dtype))
        self.GroupNorm_1 = GroupNorm(features, g, dtype=norm_dtype)
        self.transition = cin != features or stride != 1
        if self.transition:
            self.add_module(c + "2", _conv(quantized, cin, features, (1, 1),
                                           s, use_bias=False, dtype=dtype))
            self.GroupNorm_2 = GroupNorm(features, g, dtype=norm_dtype)

    def conv(self, i: int) -> nn.Module:
        return getattr(self, self._prefix + str(i))

    def forward(self, x):
        y = self.GroupNorm_0(self.conv(0)(x))
        y = self.GroupNorm_1(self.conv(1)(y))
        if self.transition:
            x = self.GroupNorm_2(self.conv(2)(x))
        return torch.relu(y + x)


class FusionBlock(nn.Module):
    """RefineNet decoder block: nearest 2x upsample, conv, the skip's conv
    added, then a ResBlock."""

    def __init__(self, cin: int, features: int, skip: Optional[int],
                 dtype=torch.bfloat16, norm_dtype=torch.float32,
                 quantized: bool = False):
        super().__init__()
        c = self._prefix = _conv_prefix(quantized)
        self.add_module(c + "0", _conv(quantized, cin, features, dtype=dtype))
        self.has_skip = skip is not None
        if self.has_skip:
            self.add_module(c + "1", _conv(quantized, skip, features,
                                           use_bias=False, dtype=dtype))
        self.ResBlock_0 = ResBlock(features, features, dtype=dtype,
                                   norm_dtype=norm_dtype, quantized=quantized)

    def conv(self, i: int) -> nn.Module:
        return getattr(self, self._prefix + str(i))

    def forward(self, x, skip=None):
        x = self.conv(0)(upsample2_nearest(x))
        if skip is not None:
            x = x + self.conv(1)(skip)
        return self.ResBlock_0(x)


class PerspectiveDepthNet(nn.Module):
    """(B, H, W, 3) RGB in [0, 1] -> (B, H, W) positive depth-like values;
    29 GroupNorms at the default widths, and with ``quantized`` 39 int8
    convs (every conv but the f32 output head)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 decoder_width: int = 128, dtype=torch.bfloat16,
                 norm_dtype=torch.float32, quantized: bool = False):
        super().__init__()
        # what models/quantize.py builds the int8 twin from
        self.config = dict(stage_sizes=tuple(stage_sizes),
                           widths=tuple(widths), decoder_width=decoder_width,
                           dtype=dtype, norm_dtype=norm_dtype)
        self.quantized = quantized
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        c = self._prefix = _conv_prefix(quantized)
        stem = widths[0] // 2
        self.add_module(c + "0", _conv(quantized, 3, stem, (7, 7), (2, 2),
                                       use_bias=False, dtype=dtype))
        self.GroupNorm_0 = GroupNorm(stem, _groups(stem), fuse_relu=True,
                                     dtype=norm_dtype)
        cin, k = stem, 0
        for blocks, width in zip(stage_sizes, widths):
            for b in range(blocks):
                self.add_module(f"ResBlock_{k}", ResBlock(
                    cin, width, stride=2 if b == 0 else 1, dtype=dtype,
                    norm_dtype=norm_dtype, quantized=quantized))
                cin, k = width, k + 1
        self.add_module(c + "1", _conv(quantized, widths[-1], decoder_width,
                                       use_bias=False, dtype=dtype))
        skips = list(reversed(widths[:-1])) + [None]
        for k, skip in enumerate(skips):
            self.add_module(f"FusionBlock_{k}", FusionBlock(
                decoder_width, decoder_width, skip, dtype=dtype,
                norm_dtype=norm_dtype, quantized=quantized))
        self.add_module(c + "2", _conv(quantized, decoder_width,
                                       decoder_width // 2, dtype=dtype))
        self.add_module(c + "3", _conv(quantized, decoder_width // 2, 32,
                                       dtype=dtype))
        # the output head stays an f32 Conv; flax numbers it after the
        # other Convs of the net, so it is Conv_0 in the int8 graph
        self.add_module("Conv_0" if quantized else "Conv_4", Conv(
            32, 1, (1, 1), dtype=torch.float32, bias_init=HEAD_BIAS))

    def conv(self, i: int) -> nn.Module:
        return getattr(self, self._prefix + str(i))

    @property
    def head(self) -> nn.Module:
        return self.Conv_0 if self.quantized else self.Conv_4

    def forward(self, rgb):
        x = rgb.permute(0, 3, 1, 2).to(self.dtype)
        x = self.GroupNorm_0(self.conv(0)(x))
        skips, k = [], 0
        for blocks in self.stage_sizes:
            for _ in range(blocks):
                x = getattr(self, f"ResBlock_{k}")(x)
                k += 1
            skips.append(x)
        y = self.conv(1)(skips[-1])
        for k, skip in enumerate(list(reversed(skips[:-1])) + [None]):
            y = getattr(self, f"FusionBlock_{k}")(y, skip)
        y = torch.relu(self.conv(2)(y))
        h, w = y.shape[2:]
        y = resize_bilinear(y, (h * 2, w * 2))
        y = torch.relu(self.conv(3)(y))
        return softplus(self.head(y)[:, 0])


# relu gain: 1/sqrt(E[relu(z)^2]) for z ~ N(0,1) (NF-ResNets, Brock et
# al. 2021), as in the JAX package
_RELU_GAIN = math.sqrt(2.0 / (1.0 - 1.0 / math.pi))


def _const(v: float, dtype, device):
    """``jnp.asarray(v, dtype)``: the scalar rounded to ``dtype``, filled
    on ``device`` (no host-to-device copy, so a CUDA graph can capture
    it)."""
    return torch.full((), v, dtype=dtype, device=device)


class WSConv(Derived):
    """Conv with scaled weight standardisation and a learnable gain and
    bias; lax SAME padding.  ``kernel`` is OIHW; standardised over
    (cin, kh, kw) per output channel."""

    def __init__(self, cin: int, features: int, kernel=(3, 3), strides=(1, 1),
                 dtype=torch.bfloat16, gain_act: float = _RELU_GAIN):
        super().__init__()
        kh, kw = kernel
        self.strides = tuple(strides)
        self.dtype = dtype
        self.gain_act = gain_act
        self.kernel = nn.Parameter(torch.empty(features, cin, kh, kw))
        self.gain = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.init_flax_()

    def init_flax_(self, generator=None):
        """flax's ``he_normal`` kernel (truncated, variance 2/fan_in), gain
        1, bias 0."""
        variance_scaling_(self.kernel, 2.0, self.kernel[0].numel(), generator)
        with torch.no_grad():
            self.gain.fill_(1.0)
            self.bias.zero_()

    def _standardize(self):
        w = self.kernel.to(torch.float32)
        mu = w.mean((1, 2, 3), keepdim=True)
        var = ((w - mu) * (w - mu)).mean((1, 2, 3), keepdim=True)
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        w = (w - mu) * torch.rsqrt(var * fan_in + 1e-8)
        w = w * (self.gain_act * self.gain)[:, None, None, None]
        return w.to(self.dtype)

    def weight(self):
        """The standardised kernel as the conv uses it."""
        return self.derived(self._standardize, self.kernel, self.gain)

    def forward(self, x):
        kh, kw = self.kernel.shape[2:]
        (t, b), (l, r) = (same_pads(x.shape[2], kh, self.strides[0]),
                          same_pads(x.shape[3], kw, self.strides[1]))
        x = train_layout(x.to(self.dtype), self.kernel)
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        y = F.conv2d(x, self.weight(), stride=self.strides)
        return y + self.bias.to(self.dtype)[:, None, None]


class NFResBlock(nn.Module):
    """Pre-activation residual block ``h + alpha * f(relu(h / beta))``;
    a transition block (stride or width change) also routes the shortcut
    through the scaled activation."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 alpha: float = 0.2, beta: float = 1.0, dtype=torch.bfloat16):
        super().__init__()
        self.alpha, self.beta, self.dtype = alpha, beta, dtype
        s = (stride, stride)
        self.WSConv_0 = WSConv(cin, features, (3, 3), s, dtype=dtype)
        self.WSConv_1 = WSConv(features, features, (3, 3), dtype=dtype)
        self.WSConv_2 = (WSConv(cin, features, (1, 1), s, dtype=dtype)
                         if cin != features or stride != 1 else None)

    def forward(self, x):
        out = torch.relu(x * _const(1.0 / self.beta, self.dtype, x.device))
        y = torch.relu(self.WSConv_0(out))
        y = self.WSConv_1(y)
        if self.WSConv_2 is not None:
            x = self.WSConv_2(out)
        return x + _const(self.alpha, self.dtype, x.device) * y


class NFFusionBlock(nn.Module):
    """Norm-free RefineNet decoder block: nearest 2x upsample, WS conv,
    the skip added and rescaled by 1/sqrt(2), then an NFResBlock."""

    def __init__(self, cin: int, features: int, skip: Optional[int],
                 alpha: float = 0.2, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.WSConv_0 = WSConv(cin, features, dtype=dtype, gain_act=1.0)
        self.WSConv_1 = (WSConv(skip, features, dtype=dtype, gain_act=1.0)
                         if skip is not None else None)
        self.NFResBlock_0 = NFResBlock(features, features, alpha=alpha,
                                       dtype=dtype)

    def forward(self, x, skip=None):
        x = self.WSConv_0(upsample2_nearest(x))
        if skip is not None:
            x = (x + self.WSConv_1(skip)) * _const(
                1.0 / math.sqrt(2.0), self.dtype, x.device)
        return self.NFResBlock_0(x)


class NFPerspectiveNet(nn.Module):
    """(B, H, W, 3) RGB in [0, 1] -> (B, H, W) positive depth-like values."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 decoder_width: int = 128, alpha: float = 0.2,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.WSConv_0 = WSConv(3, widths[0] // 2, (7, 7), (2, 2), dtype=dtype,
                               gain_act=1.0)
        cin, var, k = widths[0] // 2, 1.0, 0
        for blocks, width in zip(stage_sizes, widths):
            for b in range(blocks):
                self.add_module(f"NFResBlock_{k}", NFResBlock(
                    cin, width, stride=2 if b == 0 else 1, alpha=alpha,
                    beta=math.sqrt(var), dtype=dtype))
                # a transition resets the stream's variance, then each
                # block adds alpha^2 (tracked analytically, as in JAX)
                var = (1.0 if b == 0 else var) + alpha ** 2
                cin, k = width, k + 1
        self.WSConv_1 = WSConv(widths[-1], decoder_width, dtype=dtype,
                               gain_act=1.0)
        skips = list(reversed(widths[:-1])) + [None]
        for k, skip in enumerate(skips):
            self.add_module(f"NFFusionBlock_{k}", NFFusionBlock(
                decoder_width, decoder_width, skip, alpha=alpha, dtype=dtype))
        self.WSConv_2 = WSConv(decoder_width, decoder_width // 2, dtype=dtype)
        self.WSConv_3 = WSConv(decoder_width // 2, 32, dtype=dtype)
        self.Conv_0 = Conv(32, 1, (1, 1), dtype=torch.float32,
                           bias_init=HEAD_BIAS)

    def forward(self, rgb):
        x = rgb.permute(0, 3, 1, 2).to(self.dtype)
        x = self.WSConv_0(x)
        skips, k = [], 0
        for blocks in self.stage_sizes:
            for _ in range(blocks):
                x = getattr(self, f"NFResBlock_{k}")(x)
                k += 1
            skips.append(x)
        y = self.WSConv_1(skips[-1])
        for k, skip in enumerate(list(reversed(skips[:-1])) + [None]):
            y = getattr(self, f"NFFusionBlock_{k}")(y, skip)
        y = torch.relu(self.WSConv_2(torch.relu(y)))
        h, w = y.shape[2:]
        y = resize_bilinear(y, (h * 2, w * 2))
        y = torch.relu(self.WSConv_3(y))
        return softplus(self.Conv_0(y)[:, 0])


P99_MODES = ("sort", "topk", "approx")


def p99_mode() -> str:
    """``PANODEPTH_P99`` (``sort``, the default off the TPU, ``topk`` or
    ``approx``), read when a stage is built, traced or captured, as JAX
    reads it when it traces."""
    mode = os.environ.get("PANODEPTH_P99", "sort")
    if mode not in P99_MODES:
        raise ValueError(f"PANODEPTH_P99 must be one of {P99_MODES}, got "
                         f"{mode!r}")
    return mode


def _percentile99(flat):
    """Per-row 99th percentile of (B, N), as the JAX package's
    ``_percentile99`` computes it in the mode ``PANODEPTH_P99`` names.

    ``sort`` (the default): ``jnp.percentile(flat, 99.0, axis=1)``, a full
    sort, then linear interpolation between ranks floor and ceil of ``0.99
    * (N - 1)`` in f32.  The ranks and weights depend on N alone, so they
    are formed on the host in numpy f32 with the same roundings and applied
    as Python floats (exact for f32 values): no host-to-device copy, so a
    CUDA graph can capture the call.

    ``topk``: the interpolated rank statistic from the top k = N - rank
    values only (``lax.top_k``'s form: rank = (N-1)*99//100, the weight
    (N-1)*0.99 - rank rounded to f32, ``lo + frac * (hi - lo)``).
    ``approx``: JAX's ``lax.approx_max_k``, which off the TPU returns the
    exact top k, so here the same as ``topk``.
    """
    mode = p99_mode()
    n = flat.shape[1]
    if mode == "sort":
        q = np.float32(99.0) / np.float32(100)
        q = q * (np.float32(n) - np.float32(1))
        low, high = np.floor(q), np.ceil(q)
        high_w = q - low
        low_w = np.float32(1) - high_w
        lo = int(np.clip(low, 0, n - 1))
        hi = int(np.clip(high, 0, n - 1))
        s = torch.sort(flat.to(torch.float32), dim=1).values
        return s[:, lo] * float(low_w) + s[:, hi] * float(high_w)
    rank = (n - 1) * 99 // 100            # floor((n-1)*0.99), exact in int
    frac = float(np.float32((n - 1) * 0.99 - rank))
    k = n - rank                          # descending index n-1-rank, +1
    v = torch.topk(flat.to(torch.float32), k, dim=1).values  # descending
    lo = v[:, k - 1]                      # ascending a[rank]
    hi = v[:, k - 2] if k >= 2 else v[:, k - 1]
    return lo + frac * (hi - lo)


def predict_depth01(model: nn.Module, rgb):
    """Run the net and map its positive output into the 0~1 depth encoding,
    normalised per image by its 99th percentile (a monotone map the cubic
    registration absorbs, Depth.cpp:1261-1414)."""
    pred = model(rgb)
    hi = _percentile99(pred.reshape(pred.shape[0], -1))
    return torch.clamp(pred / torch.clamp_min(hi, 1e-6)[:, None, None],
                       0.0, 1.0)
