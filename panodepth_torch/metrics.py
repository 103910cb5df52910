"""Depth metrics with the reference's evaluation semantics.

Counterpart of ``panodepth/metrics.py``: ``Metrics``, ``error_metrics`` and
``paired_metrics`` (``ErrorData`` / ``ErrorEmap``, reference
``Depth.cpp:1980-2458``), ``median_scaling`` (MedianScaling),
``error_compare`` (ErrorCompare) and ``error_laplacian`` (ErrorLaplacian),
in torch on the tensors' device.  Quirks kept:

* the zenith band rows are ``int(zr / pi * H)`` with both endpoint rows
  included, from the global ``g_zenith_range`` (Depth.cpp:1983, 2222);
* gt pixels are matched by ``X = int(x * gt_w / given_w)`` nearest lookup;
* pixels whose gt value is below 1e-4 are skipped;
* depth is capped at 10 m in Matterport units (``depth_max = 10 / (65535 /
  4000)`` in the 0~1 encoding, Depth.cpp:2001-2002) on both maps;
* ``align_way=1`` scales by gt_median/given_median, each median the element
  at index ``n // 2`` of the sorted valid values (Depth.cpp:2009-2081);
  ``align_way=2`` is the closed-form ``pred*s + o`` (Depth.cpp:2082-2139),
  its sums in float64 as the reference's;
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
        # the sums and the solve in float64, as the reference takes them:
        # det cancels, and f32 sums taken in another order (the CPU's, the
        # card's, XLA's) then move s and o by up to ~1e-3 of themselves
        v0 = torch.where(valid, val0, 0.0).to(torch.float64)
        v1 = torch.where(valid, val1, 0.0).to(torch.float64)
        a00 = torch.sum(v1 * v1)
        a01 = torch.sum(v1)
        a11 = torch.sum(valid.to(torch.float64))
        b0 = torch.sum(v0 * v1)
        b1 = torch.sum(v0)
        det = a00 * a11 - a01 * a01
        s = ((a11 * b0 - a01 * b1) / det).to(torch.float32)
        o = ((-a01 * b0 + a00 * b1) / det).to(torch.float32)
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


def median_scaling(emap0, emap1):
    """Scale emap0's in-range values by emap1_median / emap0_median.

    Valid pixels are those in [1e-4, 1-1e-4); the others pass through
    unscaled.  Mirrors reference MedianScaling (Depth.cpp:637-701).
    Returns (scaled_emap0, emap0_median, emap1_median).
    """
    e0 = emap0 if emap0.dim() == 2 else emap0[..., 0]
    e1 = emap1 if emap1.dim() == 2 else emap1[..., 0]
    valid0 = (e0 >= 1e-4) & (e0 < 1 - 1e-4)
    valid1 = (e1 >= 1e-4) & (e1 < 1 - 1e-4)
    m0 = _masked_median(e0, valid0)
    m1 = _masked_median(e1, valid1)
    scaled = torch.where(valid0, e0 * (m1 / m0), e0)
    if emap0.dim() == 3:
        scaled = torch.cat([scaled[..., None], emap0[..., 1:]], -1)
    return scaled, m0, m1


def error_compare(gt_filename: str, baseline_filename: str,
                  disp_depth_compare: bool = False, align_way: int = 1,
                  cap_depth: bool = True, shifted_filename: str = None,
                  device="cuda"):
    """File-level comparison (ErrorCompare, reference Depth.cpp:2460-2634).

    With ``disp_depth_compare`` (the mono360 path): the baseline is taken
    for disparity, least-squares aligned to the gt's disparity, inverted to
    depth, clipped to 10, scored against the gt depth, and (optionally)
    saved minmax-normalized as an 8-bit PNG.  Without it: plain ErrorEmap
    on the two files.  The baseline file loads with mono360 PFM semantics.
    The maps are scored on ``device``.
    """
    from . import io as pio
    from .ops.maps import disp_depth_conversion, minmax_normalize_valid
    from .pipeline import resolve_device

    dev = resolve_device(device)
    gt = torch.as_tensor(pio.load_image01(gt_filename), device=dev)
    baseline = torch.as_tensor(
        pio.load_image01(baseline_filename, mono360=True), device=dev)
    base = baseline if baseline.dim() == 2 else baseline[..., 0]
    if disp_depth_compare:
        pre = error_metrics(disp_depth_conversion(gt), baseline, align_way=2,
                            cap_depth=False)
        s, o = pre["least_square"][0], pre["least_square"][1]
        base = torch.clamp(disp_depth_conversion(base * s + o), 0.0, 10.0)
        res = error_metrics(gt, base, align_way=align_way,
                            cap_depth=cap_depth)
        if shifted_filename:
            out = minmax_normalize_valid(base)
            pio.save_png8(shifted_filename,
                          np.maximum(out.cpu().numpy(), 0.0))
        return res
    res = error_metrics(gt, baseline, align_way=align_way,
                        cap_depth=cap_depth)
    if shifted_filename:
        pio.save_png8(shifted_filename, np.maximum(base.cpu().numpy(), 0.0))
    return res


# 5x5 LoG kernel of ErrorLaplacian (reference Depth.cpp:2904-2906), [x][y]
_LOG5 = np.zeros((5, 5), np.float64)
for _x, _y, _w in [(2, 0, -1), (1, 1, -1), (2, 1, -2), (3, 1, -1),
                   (0, 2, -1), (1, 2, -2), (2, 2, 16), (3, 2, -2), (4, 2, -1),
                   (1, 3, -1), (2, 3, -2), (3, 3, -1), (2, 4, -1)]:
    _LOG5[_y, _x] = _w


def error_laplacian(gt, baseline):
    """Gradient-space metrics (ErrorLaplacian, reference Depth.cpp:
    2636-2953), in float64 on the maps' device.

    Returns a dict of laplacian_mse / laplacian_mae / sobel_x_mae /
    sobel_y_mae / laplacian5x5_mae (0-d tensors) between the gt and the
    baseline map (0~1, (H, W) or (H, W, C) tensors, possibly of different
    sizes; gt is matched by C-cast index scaling).  Reference quirks kept:
    the Sobel validity check omits the (1,0)/(2,0) gt cells, and the 5x5
    bound check tests the center column (X2), not the rightmost.  A gt
    column index depends on the baseline's column only (and a row on its
    row), so the indices are formed per axis and broadcast.
    """
    g = (gt if gt.dim() == 2 else gt[..., 0]).to(torch.float64)
    b = (baseline if baseline.dim() == 2 else baseline[..., 0]).to(
        torch.float64).to(g.device)
    gh, gw = g.shape
    h, w = b.shape
    rx, ry = gw / w, gh / h
    dev = g.device

    def cast(v, d, r):
        # the C casts of the reference, in float64 on the host
        return ((v + d) * r).astype(np.int64)

    def gt_at(dx, dy, x, y):
        X, Y = cast(x, dx, rx), cast(y, dy, ry)
        rows = torch.from_numpy(np.clip(Y, 0, gh - 1)).to(dev)
        cols = torch.from_numpy(np.clip(X, 0, gw - 1)).to(dev)
        return g[rows[:, None], cols[None, :]], X, Y

    def in_bounds(xlo, xhi, ylo, yhi):
        """The per-axis bound checks as one (rows, cols) mask."""
        cols = torch.from_numpy((xlo >= 0) & (xhi <= gw - 1)).to(dev)
        rows = torch.from_numpy((ylo >= 0) & (yhi <= gh - 1)).to(dev)
        return rows[:, None] & cols[None, :]

    def masked_mean(valid, v):
        return torch.where(valid, v, 0.0).sum() / valid.sum()

    x, y = np.arange(1, w - 1), np.arange(1, h - 1)
    at = lambda dx, dy: b[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
    gv = {(dx, dy): gt_at(dx, dy, x, y)[0]
          for dx in (-1, 0, 1) for dy in (-1, 0, 1)}
    inb = in_bounds(cast(x, -1, rx), cast(x, 1, rx), cast(y, -1, ry),
                    cast(y, 1, ry))

    lap_valid = inb
    for k in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        lap_valid = lap_valid & (gv[k] >= 1e-4)
    g_lap = gv[(0, 0)] - (gv[(-1, 0)] + gv[(1, 0)] + gv[(0, -1)]
                          + gv[(0, 1)]) / 4
    b_lap = at(0, 0) - (at(-1, 0) + at(1, 0) + at(0, -1) + at(0, 1)) / 4
    d = g_lap - b_lap
    lap_mse = masked_mean(lap_valid, d * d)
    lap_mae = masked_mean(lap_valid, d.abs())

    # Sobel validity: the reference checks (0,0),(0,1),(0,2),(1,1),(2,1),
    # (1,2),(2,2) in [x][y] indexing, i.e. (dx,dy) below, NOT (1,0),(2,0)
    sob_valid = inb
    for k in [(-1, -1), (-1, 0), (-1, 1), (0, 0), (1, 0), (0, 1), (1, 1)]:
        sob_valid = sob_valid & (gv[k] >= 1e-4)
    g_sx = gv[(-1, -1)] - gv[(1, -1)] + 2 * gv[(-1, 0)] - 2 * gv[(1, 0)] \
        + gv[(-1, 1)] - gv[(1, 1)]
    g_sy = gv[(-1, -1)] + 2 * gv[(0, -1)] + gv[(1, -1)] - gv[(-1, 1)] \
        - 2 * gv[(0, 1)] - gv[(1, 1)]
    b_sx = at(-1, -1) - at(1, -1) + 2 * at(-1, 0) - 2 * at(1, 0) \
        + at(-1, 1) - at(1, 1)
    b_sy = at(-1, -1) + 2 * at(0, -1) + at(1, -1) - at(-1, 1) \
        - 2 * at(0, 1) - at(1, 1)
    sx_mae = masked_mean(sob_valid, (g_sx - b_sx).abs())
    sy_mae = masked_mean(sob_valid, (g_sy - b_sy).abs())

    # 5x5 LoG
    x5, y5 = np.arange(2, w - 2), np.arange(2, h - 2)
    at5 = lambda dx, dy: b[2 + dy:h - 2 + dy, 2 + dx:w - 2 + dx]
    g5 = {(dx, dy): gt_at(dx, dy, x5, y5)[0]
          for dx in range(-2, 3) for dy in range(-2, 3)}
    valid5 = in_bounds(cast(x5, -2, rx), cast(x5, 0, rx), cast(y5, -2, ry),
                       cast(y5, 0, ry))
    for k in g5:
        valid5 = valid5 & (g5[k] >= 1e-4)
    g_log = sum(_LOG5[dy + 2, dx + 2] * g5[(dx, dy)]
                for dx in range(-2, 3) for dy in range(-2, 3))
    b_log = sum(_LOG5[dy + 2, dx + 2] * at5(dx, dy)
                for dx in range(-2, 3) for dy in range(-2, 3))
    log_mae = masked_mean(valid5, (g_log - b_log).abs())

    return dict(laplacian_mse=lap_mse, laplacian_mae=lap_mae,
                sobel_x_mae=sx_mae, sobel_y_mae=sy_mae,
                laplacian5x5_mae=log_mae)


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
