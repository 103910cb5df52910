"""Post-training int8 quantization of a trained GN perspective net.

Counterpart of ``panodepth/models/quantize.py``: turns a float
``PerspectiveDepthNet`` into its ``quantized=True`` twin, every conv but
the 1x1 output head a ``layers.QConv`` with per-output-channel symmetric
int8 weights (absmax/127 scales).  The activations are quantized per call
inside QConv, so no calibration set is needed.

The codes and scales are made in numpy f32 on the host exactly as the JAX
package makes them (:func:`quantize_conv_kernel`, the same code), so they
are bit-equal to JAX's.  Names follow flax's numbering in the int8 graph:
each nested ``Conv_i`` becomes ``QConv_i``, the top level's ``Conv_0`` ..
``Conv_3`` become ``QConv_0`` .. ``QConv_3``, and the f32 head ``Conv_4``
is renumbered ``Conv_0`` (``models/perspective.py``); a tree quantized by
the JAX package loads onto the twin by path (``weights.load_params``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import Conv, QConv
from .norm import GroupNorm
from .perspective import PerspectiveDepthNet


def quantize_conv_kernel(kernel):
    """f32 (kh, kw, cin, cout) -> (int8 codes, f32 per-cout scale), in JAX's
    numpy ops and order."""
    k = np.asarray(kernel, np.float32)
    s = np.max(np.abs(k), axis=(0, 1, 2))  # per output channel
    s = np.maximum(s, 1e-12) / 127.0
    q = np.clip(np.round(k / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _quantized_name(path: str) -> str:
    """A float net's conv path in the int8 twin: the last ``Conv_i``
    becomes ``QConv_i``."""
    *parents, leaf = path.split(".")
    return ".".join(parents + ["Q" + leaf])


def quantize_perspective(model: PerspectiveDepthNet) -> PerspectiveDepthNet:
    """The int8 twin of a float GN ``PerspectiveDepthNet`` (same widths,
    conv and norm types, device), for inference: no parameter requires
    grad."""
    if not isinstance(model, PerspectiveDepthNet) or model.quantized:
        raise ValueError("int8 PTQ supports float GN PerspectiveDepthNets "
                         f"only, got {type(model).__name__}")
    twin = PerspectiveDepthNet(**model.config, quantized=True)
    targets = dict(twin.named_modules())
    filled = set()
    with torch.no_grad():
        for path, m in model.named_modules():
            if m is model.head:
                t, src = twin.head, (("kernel", m.kernel), ("bias", m.bias))
            elif isinstance(m, Conv):
                t = targets[_quantized_name(path)]
                hwio = m.kernel.detach().cpu().numpy().transpose(2, 3, 1, 0)
                q, s = quantize_conv_kernel(hwio)
                src = (("kernel_q", torch.from_numpy(
                    np.ascontiguousarray(q.transpose(3, 2, 0, 1)))),
                       ("scale", torch.from_numpy(s)))
                if m.bias is not None:
                    src += (("bias", m.bias),)
            elif isinstance(m, GroupNorm):
                t, src = targets[path], (("scale", m.scale), ("bias", m.bias))
            else:
                continue
            for name, value in src:
                getattr(t, name).copy_(value)
                filled.add(id(getattr(t, name)))
    missing = [n for n, p in twin.named_parameters() if id(p) not in filled]
    if missing:
        raise AssertionError(f"quantize_perspective left {missing[:4]} "
                             f"unfilled")
    twin.requires_grad_(False)
    device = next(model.parameters()).device
    return twin.to(device).eval()


def int8_param_bytes(model: nn.Module) -> int:
    """Bytes of the net's parameters (the quantized tree's serialized size
    in JAX's diagnostic)."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def qconvs(model: nn.Module):
    """The net's int8 convs, in module order."""
    return [m for m in model.modules() if isinstance(m, QConv)]
