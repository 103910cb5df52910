"""Equirectangular-map utilities (EquirectangularMap member functions).

Counterpart of ``panodepth/ops/maps.py``, in torch on the maps' device:

* :func:`disp_depth_conversion`  -- ``DispDepthConversion`` (reference
  Depth.cpp:587-610): the reciprocal, values with ``|v| < 1e-5`` kept;
* :func:`copy_invalid_pixels`    -- ``CopyInvalidPixels`` (Depth.cpp:
  703-725): a reference map's masked (black or white) pixels propagated;
* :func:`avg_valid`              -- ``Avg`` (Depth.cpp:563-585): the mean
  of the positive values;
* :func:`minmax_normalize_valid` -- the valid-pixel minmax remap of
  ErrorCompare's disparity path (Depth.cpp:2535-2566);
* :func:`disparity_to_depth`     -- Depth.cpp:727-736.

A map is (H, W) or (H, W, C); only channel 0 is read and written.
"""

from __future__ import annotations

import numpy as np
import torch


def _chan0(img):
    return img if img.dim() == 2 else img[..., 0]


def _put0(img, out):
    """``out`` as the map's channel 0 (the other channels kept)."""
    if img.dim() == 2:
        return out
    img = img.clone()
    img[..., 0] = out
    return img


def disp_depth_conversion(img):
    """Reciprocal disparity <-> depth; |v| < 1e-5 passes through."""
    v = _chan0(img)
    return _put0(img, torch.where(v.abs() < 1e-5, v, 1.0 / v))


def copy_invalid_pixels(img, ref):
    """Overwrite the pixels whose nearest ``ref`` sample is masked (v < 1e-4
    or v >= 1 - 1e-4) with that sample.  The nearest indices are the JAX
    package's, formed in float64 on the host."""
    v, r = _chan0(img), _chan0(ref)
    h, w = v.shape
    rh, rw = r.shape
    xs = np.clip((np.arange(w) * (rw / w)).astype(np.int64), 0, rw - 1)
    ys = np.clip((np.arange(h) * (rh / h)).astype(np.int64), 0, rh - 1)
    rv = r[torch.from_numpy(ys).to(r.device)[:, None],
           torch.from_numpy(xs).to(r.device)[None, :]]
    invalid = (rv < 1e-4) | (rv >= 1 - 1e-4)
    return _put0(img, torch.where(invalid, rv, v))


def avg_valid(img):
    """The mean of the values > 0 (Avg); 0 if there are none."""
    v = _chan0(img)
    m = v > 0
    n = m.sum()
    s = torch.where(m, v, 0.0).sum()
    return torch.where(n == 0, torch.zeros_like(s), s / n)


def minmax_normalize_valid(img, eps: float = 1e-4):
    """Minmax-remap the values with |v| >= eps to 0~1; the rest kept."""
    v = _chan0(img)
    m = v.abs() >= eps
    lo = torch.where(m, v, torch.inf).min()
    hi = torch.where(m, v, -torch.inf).max()
    return _put0(img, torch.where(m, (v - lo) / (hi - lo), v))


def disparity_to_depth(disparity, disparity_min: float = 0.005):
    """The min/d convention: d == disparity_min -> 1, d == 1 ->
    disparity_min."""
    return disparity_min / torch.clamp_min(disparity, disparity_min)
