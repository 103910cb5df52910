"""Carry the JAX package's checkpoints into the port's nets.

Counterpart of ``panodepth/models/train.py::load_params_npz``
(train.py:239-256) and of the architecture-sidecar logic of
``panodepth/e2e.py::load_model_checkpoint`` (e2e.py:126-234), for every
kind it builds: ``perspective`` (GN or NF), ``hohonet``, ``bifuse``,
``slicenet``, ``fastpano``, and any other kind as the UniFuse-class
``panoramic`` net (GN or NF), as JAX falls through to it.

A ``*.params.npz`` checkpoint stores each flax parameter under its path
(``"['params']['CircResBlock_0']['GroupNorm_1']['scale']"``) as bf16 bit
patterns in ``uint16``; they widen exactly to f32 as ``u16 << 16``.  The
port's nets keep flax's module and parameter names, so a path maps to the
port's parameter ``CircResBlock_0.GroupNorm_1.scale`` mechanically; only
kernels change layout: conv kernels (and the int8 graph's codes,
``kernel_q``) flax HWIO -> OIHW, dense kernels flax
(in, out) -> (out, in), and the attention's 3-D ``DenseGeneral`` kernels
output axes first (``query``/``key``/``value`` (in, heads, dim) -> (heads,
dim, in), ``out`` (heads, dim, out) -> (out, heads, dim)).  Loading fails
unless every key of the file is consumed and every parameter of the net is
filled.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_KEY = re.compile(r"\['([^']+)'\]")


def read_params_npz(path: str) -> Dict[str, np.ndarray]:
    """{flax path string: f32 array} of a ``save_params_npz`` export."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            a = z[key]
            if a.dtype == np.uint16:  # bf16 bit patterns, widened exactly
                a = (a.astype(np.uint32) << 16).view(np.float32)
            out[key] = np.asarray(a, np.float32)
    return out


def port_name(key: str) -> str:
    """The port's parameter name for a flax path string:
    ``['params']['A']['b']`` -> ``A.b``."""
    parts = _KEY.findall(key)
    if not parts or parts[0] != "params" or "".join(
            f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a flax parameter path: {key!r}")
    return ".".join(parts[1:])


def to_port_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A flax leaf in the port's layout: conv kernels HWIO -> OIHW, dense
    kernels (in, out) -> (out, in), attention kernels output axes first
    (the ``out`` projection contracts its first two axes, the others their
    first); everything else as it is."""
    if name.endswith(("kernel", "kernel_q")) and a.ndim == 4:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if name.endswith("kernel") and a.ndim == 3:
        return np.ascontiguousarray(a.transpose(
            (2, 0, 1) if name.endswith(".out.kernel") else (1, 2, 0)))
    if name.endswith("kernel") and a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return a


def flax_key(name: str) -> str:
    """The flax path string of a port parameter name, the inverse of
    :func:`port_name`: ``A.b`` -> ``['params']['A']['b']``."""
    return "['params']" + "".join(f"['{p}']" for p in name.split("."))


def to_flax_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A port leaf in flax's layout, the inverse of :func:`to_port_layout`:
    conv kernels OIHW -> HWIO, dense kernels (out, in) -> (in, out),
    attention kernels with their output axes last."""
    if name.endswith(("kernel", "kernel_q")) and a.ndim == 4:
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if name.endswith("kernel") and a.ndim == 3:
        return np.ascontiguousarray(a.transpose(
            (1, 2, 0) if name.endswith(".out.kernel") else (2, 0, 1)))
    if name.endswith("kernel") and a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return a


def load_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copy the flax leaves ``flat`` (as :func:`read_params_npz` returns
    them, or a tree the JAX package quantized, its int8 codes included)
    into ``model``'s parameters, each in the parameter's type; raises
    unless the two match one to one in names and shapes.  Returns
    ``model``."""
    params = dict(model.named_parameters())
    converted = {}
    for key, a in flat.items():
        name = port_name(key)
        converted[name] = to_port_layout(name, a)
    unused = sorted(set(converted) - set(params))
    missing = sorted(set(params) - set(converted))
    if unused or missing:
        raise ValueError(f"checkpoint and {type(model).__name__} disagree: "
                         f"unused checkpoint keys {unused[:8]}"
                         f"{'...' if len(unused) > 8 else ''}, unfilled "
                         f"parameters {missing[:8]}"
                         f"{'...' if len(missing) > 8 else ''}")
    with torch.no_grad():
        for name, a in converted.items():
            p = params[name]
            if tuple(p.shape) != a.shape:
                raise ValueError(f"param {name}: checkpoint shape {a.shape} "
                                 f"!= model shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(
                a, np.int8 if p.dtype == torch.int8 else np.float32)))
    return model


def read_arch(ckpt_path: str) -> dict:
    """The architecture sidecar ``<model>.config.json`` beside a checkpoint
    (``perspective_final.params.npz`` -> ``perspective.config.json``)."""
    ckpt_path = os.path.abspath(ckpt_path)
    name = os.path.basename(ckpt_path).split("_")[0].split(".")[0]
    with open(os.path.join(os.path.dirname(ckpt_path),
                           f"{name}.config.json")) as fp:
        return json.load(fp)


def build_model(arch: dict, dtype=torch.bfloat16,
                norm_dtype=torch.float32) -> nn.Module:
    """The net an architecture sidecar describes, with its widths scaled by
    ``width_scale`` as the JAX loader scales them.  The fixed-height
    families (hohonet, slicenet) are built for the sidecar's
    ``pano_width``; ``PANODEPTH_BIFUSE_PROJ`` and ``PANODEPTH_PANO_PROJ``
    pick the two-branch nets' projection form, as in JAX."""
    s = arch.get("width_scale", 1.0)
    kind, variant = arch["model"], arch.get("variant", "gn")
    kw = dict(dtype=dtype, norm_dtype=norm_dtype)
    pano = tuple(max(8, int(w * s)) for w in (32, 64, 128, 256))
    height = arch.get("pano_width", 512) // 2
    if kind == "perspective":
        from .perspective import NFPerspectiveNet, PerspectiveDepthNet

        widths = tuple(max(8, int(w * s)) for w in (64, 128, 256, 512))
        if variant == "nf":
            return NFPerspectiveNet(widths=widths,
                                    decoder_width=max(16, int(128 * s)),
                                    dtype=dtype)
        return PerspectiveDepthNet(widths=widths,
                                   decoder_width=max(16, int(128 * s)), **kw)
    if kind == "hohonet":
        from .hohonet import HorizonDepthNet

        return HorizonDepthNet(widths=pano, horizon_dim=max(32, int(256 * s)),
                               height=height, **kw)
    if kind == "bifuse":
        from .bifuse import BiFuseNet

        return BiFuseNet(widths=pano, proj=os.environ.get(
            "PANODEPTH_BIFUSE_PROJ", "bilinear"), **kw)
    if kind == "slicenet":
        from .slicenet import SliceNet

        return SliceNet(widths=pano, slice_dim=max(32, int(256 * s)),
                        height=height, **kw)
    if kind == "fastpano":
        from .fastpano import FastPanoNet

        return FastPanoNet(
            widths=tuple(max(8, int(w * s)) for w in (48, 96, 192, 384)),
            decoder_width=max(16, int(96 * s)), **kw)
    from .panoramic import NFPanoBaselineNet, PanoBaselineNet

    if variant == "nf":
        return NFPanoBaselineNet(widths=pano, **kw)
    return PanoBaselineNet(widths=pano, proj=os.environ.get(
        "PANODEPTH_PANO_PROJ", "bilinear"), **kw)
