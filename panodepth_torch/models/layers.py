"""Flax's ``nn.Conv`` and ``nn.Dense`` as the JAX nets use them, in NCHW.

The port's nets keep flax's parameter names (``kernel``, ``bias``) and
submodule names (``Conv_0``, ``Dense_1``, ...), so a checkpoint maps onto
them by path (``models/weights.py``); only the kernels' layouts differ:
conv kernels are OIHW here (flax: HWIO) and dense kernels (out, in)
(flax: (in, out)).

Numerics follow flax: a layer with ``dtype`` casts its input, kernel and
bias to it, convolves (the output rounded to ``dtype``) and then adds the
bias as a separate ``dtype`` operation.  ``padding="SAME"`` is lax's: for
stride s and kernel k the total pad ``max((ceil(n/s) - 1) * s + k - n, 0)``
goes ``total // 2`` before and the rest after, so a 3x3 stride-2 conv pads
(0, 1) and a 7x7 stride-2 one (2, 3); ``padding=k // 2`` would shift the
phase.  The nets are inference-only: no parameter requires a gradient.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import graphs

Pads = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """lax's SAME padding (before, after) of one spatial axis."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Derived(nn.Module):
    """A module whose forward uses a tensor derived from its parameters
    (a cast, a standardisation), computed once and kept until a parameter
    is replaced, moved or written in place."""

    def derived(self, make, *params):
        key = tuple((p.data_ptr(), p.dtype, p._version) for p in params)
        if getattr(self, "_derived_key", None) != key:
            self._derived_value = make()
            self._derived_key = key
        # a graph captured with this value reads it until it is evicted
        return graphs.hold(self._derived_value)


class Conv(Derived):
    """``flax.linen.Conv``: ``padding`` is ``"SAME"`` or explicit
    ((top, bottom), (left, right)) pads."""

    def __init__(self, cin: int, features: int, kernel=(3, 3), strides=(1, 1),
                 padding: Pads = "SAME", use_bias: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        kh, kw = kernel
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, cin, kh, kw),
                                   requires_grad=False)
        nn.init.kaiming_normal_(self.kernel)
        self.bias = (nn.Parameter(torch.zeros(features), requires_grad=False)
                     if use_bias else None)

    def weight(self):
        """The kernel as the conv uses it (cast to ``dtype``)."""
        return self.derived(lambda: self.kernel.to(self.dtype), self.kernel)

    def forward(self, x):
        x = x.to(self.dtype)
        kh, kw = self.kernel.shape[2:]
        if self.padding == "SAME":
            (t, b), (l, r) = (same_pads(x.shape[2], kh, self.strides[0]),
                              same_pads(x.shape[3], kw, self.strides[1]))
        else:
            (t, b), (l, r) = self.padding
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        y = F.conv2d(x, self.weight(), stride=self.strides)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class Dense(nn.Module):
    """``flax.linen.Dense`` over the last axis; ``kernel`` is (out, in)."""

    def __init__(self, cin: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, cin),
                                   requires_grad=False)
        nn.init.normal_(self.kernel, std=1.0 / math.sqrt(cin))
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
