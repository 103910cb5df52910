"""Depth metrics with the reference's evaluation semantics.

Counterpart of ``Metrics``, ``error_metrics`` and ``paired_metrics`` of
``panodepth/metrics.py`` (``ErrorData`` / ``ErrorEmap``, reference
``Depth.cpp:1980-2458``), in torch on the tensors' device.  Quirks kept:

* the zenith band rows are ``int(zr / pi * H)`` with both endpoint rows
  included, from the global ``g_zenith_range`` (Depth.cpp:1983, 2222);
* gt pixels are matched by ``X = int(x * gt_w / given_w)`` nearest lookup;
* pixels whose gt value is below 1e-4 are skipped;
* depth is capped at 10 m in Matterport units (``depth_max = 10 / (65535 /
  4000)`` in the 0~1 encoding, Depth.cpp:2001-2002) on both maps;
* ``align_way=1`` scales by gt_median/given_median, each median the element
  at index ``n // 2`` of the sorted valid values (Depth.cpp:2009-2081);
  ``align_way=2`` is the closed-form ``pred*s + o`` (Depth.cpp:2082-2139);
* MSElog counts only pixels where both values exceed 1e-4 after alignment;
* delta thresholds count failures only where both values are positive
  (Depth.cpp:2188-2201).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import ZENITH_RANGE

# 0~1 value -> Matterport meters is * 65535 / 4000 (Depth.cpp:2001).
TO_MATTERPORT = 65535.0 / 4000.0
DEPTH_MAX = 10.0 / TO_MATTERPORT  # 10 m cap, back in the 0~1 encoding


@dataclasses.dataclass
class Metrics:
    """Paired given-vs-result metrics (reference Depth.h:161-259)."""

    mse_given: float = 0.0
    mse_result: float = 0.0
    mae_given: float = 0.0
    mae_result: float = 0.0
    mre_given: float = 0.0
    mre_result: float = 0.0
    mselog_given: float = 0.0
    mselog_result: float = 0.0
    delta1_given: float = 0.0
    delta1_result: float = 0.0
    delta2_given: float = 0.0
    delta2_result: float = 0.0
    delta3_given: float = 0.0
    delta3_result: float = 0.0

    _PAIRS = ("mse", "mae", "mre", "mselog", "delta1", "delta2", "delta3")

    def save(self, filename: str) -> None:
        """Write the per-image metrics file (.aligned.txt format).

        Byte-compatible with reference Metrics::Save (Depth.h:197-243),
        including the quirk that the delta3 diff line is gated on
        delta1_given being nonzero.
        """
        lines = []
        for name in self._PAIRS:
            g = getattr(self, f"{name}_given")
            r = getattr(self, f"{name}_result")
            lines.append(f"{name}_given: {g:f}\n{name}_result: {r:f}\n")
            gate = self.delta1_given if name == "delta3" else g
            if gate != 0:
                diff = (r - g) / g if g != 0 else math.inf
                lines.append(f"{name} diff: {diff:f}\n")
        with open(filename, "w") as fp:
            fp.write("".join(lines))

    def print(self) -> str:
        """Console summary in the reference Metrics::Print shape."""
        s = (
            f"RMSE {math.sqrt(self.mse_given)}->{math.sqrt(self.mse_result)}"
            f" MAE {self.mae_given}->{self.mae_result}"
            f" MRE {self.mre_given}->{self.mre_result}"
            f" RMSElog {math.sqrt(self.mselog_given)}->{math.sqrt(self.mselog_result)}"
            f" deltas:{self.delta1_given}->{self.delta1_result}"
            f" , {self.delta2_given}->{self.delta2_result}"
            f" , {self.delta3_given}->{self.delta3_result}"
        )
        print(s)
        return s


def _band_rows(height: int, zenith_range) -> tuple[int, int]:
    return (
        int(zenith_range[0] / np.pi * height),
        int(zenith_range[1] / np.pi * height),
    )


def _gather_gt(gt, given_shape):
    """gt value for every given pixel: X = int(x * gt_w / given_w)."""
    gh, gw = gt.shape[:2]
    h, w = given_shape
    dev = gt.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) * (gw / w)).to(torch.int64)
    ys = (torch.arange(h, dtype=torch.float32, device=dev) * (gh / h)).to(torch.int64)
    g = gt if gt.dim() == 2 else gt[..., 0]
    return g[torch.clamp(ys, 0, gh - 1)[:, None],
             torch.clamp(xs, 0, gw - 1)[None, :]]


def _masked_median(vals, valid):
    """Element at index n_valid // 2 of the ascending-sorted valid values."""
    n = torch.sum(valid)
    flat = torch.where(valid, vals, torch.inf).reshape(-1)
    return torch.sort(flat).values[n // 2]


def error_metrics(gt, given, align_way: int = 1, cap_depth: bool = True,
                  zenith_range=ZENITH_RANGE):
    """MSE/MAE/MRE/MSElog/delta1-3 of ``given`` vs ``gt`` (tensors on one
    device, 0~1, channel 0 used).  Returns a dict of 0-d tensors plus the
    alignment parameters.  Mirrors reference ErrorEmap (Depth.cpp:2217-2458).
    """
    given = (given if given.dim() == 2 else given[..., 0]).to(torch.float32)
    h, w = given.shape
    h0, h1 = _band_rows(h, zenith_range)

    val0 = _gather_gt(gt.to(torch.float32), (h, w))
    val1 = given
    rows = torch.arange(h, device=given.device)[:, None]
    in_band = (rows >= h0) & (rows <= h1)
    valid = in_band & (val0 >= 1e-4)

    if cap_depth:
        val0 = torch.clamp_max(val0, DEPTH_MAX)
        val1 = torch.clamp_max(val1, DEPTH_MAX)

    median_factor = torch.tensor(1.0, device=given.device)
    least_square = torch.zeros(2, device=given.device)
    if align_way == 1:
        median_factor = _masked_median(val0, valid) / _masked_median(val1, valid)
        val1 = val1 * median_factor
    elif align_way == 2:
        v0 = torch.where(valid, val0, 0.0)
        v1 = torch.where(valid, val1, 0.0)
        a00 = torch.sum(v1 * v1)
        a01 = torch.sum(v1)
        a11 = torch.sum(valid.to(torch.float32))
        b0 = torch.sum(v0 * v1)
        b1 = torch.sum(v0)
        det = a00 * a11 - a01 * a01
        s = (a11 * b0 - a01 * b1) / det
        o = (-a01 * b0 + a00 * b1) / det
        least_square = torch.stack([s, o])
        val1 = val1 * s + o

    diff = val0 - val1
    n = torch.sum(valid).to(torch.float32)

    def msum(x):
        return torch.sum(torch.where(valid, x, 0.0))

    mse = msum(diff * diff) / n
    mae = msum(torch.abs(diff)) / n
    mre = msum(torch.abs(diff) / val0) / n

    log_ok = valid & (val0 > 1e-4) & (val1 > 1e-4)
    lv0 = torch.log10(torch.where(log_ok, val0, 1.0))
    lv1 = torch.log10(torch.where(log_ok, val1, 1.0))
    mselog = torch.sum(torch.where(log_ok, (lv0 - lv1) ** 2, 0.0)) \
        / torch.sum(log_ok)

    pos = valid & (val0 > 0) & (val1 > 0)
    r0 = torch.where(pos, val0 / torch.where(pos, val1, 1.0), 0.0)
    r1 = torch.where(pos, val1 / torch.where(pos, val0, 1.0), 0.0)
    ratio = torch.maximum(r0, r1)
    deltas = {}
    for k in (1, 2, 3):
        fails = torch.sum(pos & (ratio >= 1.25 ** k)).to(torch.float32)
        deltas[f"delta{k}"] = (n - fails) / n

    return dict(
        mse=mse, mae=mae, mre=mre, mselog=mselog, **deltas,
        median_shift_factor=median_factor, least_square=least_square,
    )


def paired_metrics(gt, baseline, result01, align_way=1, cap_depth=True,
                   zenith_range=ZENITH_RANGE) -> Metrics:
    """Fill a Metrics record: baseline ('given') and fused result vs gt.

    Mirrors the scoring block of MergeDepthMaps (Depth.cpp:933-947).
    ``result01`` must already be quantized (u16/65535), as the reference
    scores after quantizing (Depth.cpp:944).
    """
    g = error_metrics(gt, baseline, align_way, cap_depth, zenith_range)
    r = error_metrics(gt, result01, align_way, cap_depth, zenith_range)
    m = Metrics()
    for name in Metrics._PAIRS:
        setattr(m, f"{name}_given", float(g[name]))
        setattr(m, f"{name}_result", float(r[name]))
    return m
