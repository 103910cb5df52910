"""GroupNorm, routed to the CUDA kernel on the card.

Counterpart of ``panodepth/models/norm.py::GroupNorm`` (flax
``nn.GroupNorm`` with ``epsilon=1e-6``, f32 statistics (taken from exact
f64 sums, ``kernels/groupnorm.py``) and an optional fused ReLU), over NCHW
activations.  The parameters keep flax's names, ``scale`` and ``bias``.

``route`` picks the function (``kernels/groupnorm.resolve``): ``auto`` runs
the CUDA kernel ``csrc/groupnorm.cu`` on a CUDA tensor and the plain
PyTorch twin on a CPU tensor, ``kernel`` always the kernel (it raises on a
CPU tensor), ``torch`` always the twin.  On the card the kernel is the
default; nothing falls back.  :func:`set_route` sets it on every GroupNorm
of a net.

Training: the kernel has no backward, as the TPU kernel has none.  Under
grad mode, where the input, ``scale`` or ``bias`` requires grad, ``auto``
takes flax's own differentiable computation
(``kernels.groupnorm.group_norm_train``: f32 sums, the fast variance), the
one the JAX package trains with (``panodepth/models/norm.py``, whose fused
path is inference-only); ``kernel`` raises there.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import groupnorm as kgroupnorm


class GroupNorm(nn.Module):
    def __init__(self, channels: int, num_groups: int, eps: float = 1e-6,
                 fuse_relu: bool = False, dtype=torch.float32,
                 route: str = "auto"):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{channels} channels")
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_relu = fuse_relu
        self.dtype = dtype  # the output type; the statistics are f32
        self.route = route
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_flax_(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return kgroupnorm.resolve(self.route)(
            x.contiguous(), self.scale, self.bias, self.num_groups,
            eps=self.eps, relu=self.fuse_relu, out_dtype=self.dtype)


def set_route(module: nn.Module, route: str) -> nn.Module:
    """Set ``route`` on every GroupNorm inside ``module``; returns it."""
    kgroupnorm.resolve(route)  # refuse an unknown route here
    for m in module.modules():
        if isinstance(m, GroupNorm):
            m.route = route
    return module

