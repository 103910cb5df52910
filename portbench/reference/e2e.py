"""The e2e graph in plain float32 PyTorch: u8 RGB panoramas -> u16 depth
panoramas and the baseline net's maps.

The chain the program runs on the device (the baseline CNN on the
panorama resized to its width; 15 perspective views sampled bilinearly
from the panorama, each run through the perspective CNN at a multiple of
32 and normalised by its 99th percentile; a cubic per view fitted to the
baseline by least squares on the 1-degree grid; the three-level
gradient-domain fusion with its Jacobi relaxation; the C-cast to u16),
written from the reference's description (``Depth.cpp:1122-1138,
1261-1414, 1416-1771``; ``Main.cpp:242-326``) with the host geometry of
``layout.py``.  The least squares are solved in float64.  Nothing here
imports the program, and nothing it computes is taken from the program:
it reads the zoo's checkpoints and the configuration file itself.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from . import layout as L
from .nets import NETS, depth01, read_npz, resize

CLAMP = (1e-4, 1.0 - 1e-4)
STEP, REG = 0.5, 1e-4        # Depth.cpp:1650-1651
BITS = {"int8": 8, "int4": 4, "float8_e4m3": "fp8"}
# the control's precision: one step below what the configuration states
# (bfloat16 convolutions are what fp8's tensor cores would tempt a change
# to; an int8 graph's, int4)
LOWER = {"bfloat16": "float8_e4m3", "int8": "int4"}


@contextlib.contextmanager
def true_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def quant_of(precision: str):
    """The ``quant`` map of a net whose convs run at ``precision``: wider
    float types run in float32, float8 and the integer types quantized."""
    bits = BITS.get(precision)
    return {"conv": bits} if bits else {}


class Reference:
    """The configuration's e2e graph.  ``control`` computes every net one
    precision step below the one the configuration states (bfloat16 ->
    float8 e4m3, int8 -> int4)."""

    def __init__(self, cfg: dict, root: str, device, control: bool = False):
        self.device = torch.device(device)
        prec = dict(cfg["precision"])
        if control:
            for net in ("baseline", "perspective"):
                prec[net] = LOWER[prec[net]]
        base, persp = cfg["baseline"], cfg["perspective"]
        self.base = NETS[base["net"]](
            read_npz(os.path.join(root, base["checkpoint"]), self.device),
            quant_of(prec["baseline"]))
        self.persp = NETS[persp["net"]](
            read_npz(os.path.join(root, persp["checkpoint"]), self.device),
            quant_of(prec["perspective"]))
        self.base_w = base["width"]
        self.view_w = persp["view_width"]
        pipe = cfg["pipeline"]
        self.out_w = pipe["out_width"]
        self.fovs, ranges = L.layout_tables(pipe["layout_spec"])
        self.ranges = L.clamped_ranges(ranges)
        self.levels = L.pyramid(ranges, self.out_w)
        iters = [lvl.iterations for lvl in self.levels]
        if iters != list(pipe["jacobi"]):
            raise ValueError(f"the configuration states Jacobi "
                             f"{pipe['jacobi']}; the reference runs {iters}")
        groups = {}
        for v, fov in enumerate(self.fovs):
            groups.setdefault(L.view_shape(fov, self.view_w), []).append(v)
        self.groups = list(groups.items())
        self._taps = {}

    # -- the nets ----------------------------------------------------------
    def _views(self, rgb01, shape, idxs):
        """Bilinear views (n, h, w, 3) of one panorama (H, W, 3)."""
        key = (shape, tuple(idxs), tuple(rgb01.shape))
        if key not in self._taps:
            hh, ww = rgb01.shape[:2]
            taps = []
            for v in idxs:
                azi, zen = L.view_rays(self.fovs[v], shape)
                fx = (azi % L.TWO_PI) / L.TWO_PI * (ww - 1)
                fy = np.clip(zen / np.pi * (hh - 1), 0, hh - 1)
                x0, y0 = np.floor(fx).astype(np.int64), np.floor(fy).astype(
                    np.int64)
                wx, wy = fx - x0, fy - y0
                x0 = np.clip(x0, 0, ww - 1)
                x1 = (x0 + 1) % ww
                y0 = np.clip(y0, 0, hh - 1)
                y1 = np.clip(y0 + 1, 0, hh - 1)
                taps.append((x0, x1, y0, y1, wx, wy))
            self._taps[key] = [torch.from_numpy(np.stack(t)).to(
                self.device, torch.float32 if k >= 4 else torch.int64)
                for k, t in enumerate(zip(*taps))]
        x0, x1, y0, y1, wx, wy = self._taps[key]
        wx, wy = wx[..., None], wy[..., None]
        top = rgb01[y0, x0] * (1 - wx) + rgb01[y0, x1] * wx
        bot = rgb01[y1, x0] * (1 - wx) + rgb01[y1, x1] * wx
        return top * (1 - wy) + bot * wy

    def models(self, rgb01):
        """One panorama (H, W, 3) in 0~1 -> (baseline (h, w), [V view
        depths (h_v, w_v)])."""
        size = (self.base_w // 2, self.base_w)
        feed = resize(rgb01.permute(2, 0, 1)[None], size).permute(0, 2, 3, 1)
        baseline = self.base(feed)[0]
        pmaps = [None] * len(self.fovs)
        for (h, w), idxs in self.groups:
            views = self._views(rgb01, (h, w), idxs)
            nh, nw = (max(32, -(-d // 32) * 32) for d in (h, w))
            feed = resize(views.permute(0, 3, 1, 2), (nh, nw)).permute(
                0, 2, 3, 1)
            depth = depth01(self.persp, feed)
            depth = resize(depth[:, None], (h, w))[:, 0]
            for j, v in enumerate(idxs):
                pmaps[v] = depth[j]
        return baseline, pmaps

    # -- registration ------------------------------------------------------
    def register(self, emap, pmaps):
        """(V, 4) float64 cubic coefficients a, b, c, d of each view against
        the baseline: least squares over the 1-degree grid."""
        he, we = emap.shape
        out = []
        for v, pm in enumerate(pmaps):
            x, y, azi, zen = L.sample_grid(self.fovs[v], self.ranges[v])
            hp, wp = pm.shape
            exi = np.clip((azi / L.TWO_PI * (we - 1)).astype(np.int64), 0,
                          we - 1)
            eyi = np.clip((zen / np.pi * (he - 1)).astype(np.int64), 0,
                          he - 1)
            pxi = np.clip((x * (wp - 1)).astype(np.int64), 0, wp - 1)
            pyi = np.clip((y * (hp - 1)).astype(np.int64), 0, hp - 1)
            d0 = torch.clamp(pm[pyi, pxi], *CLAMP).reshape(-1).double()
            d1 = torch.clamp(emap[eyi, exi], *CLAMP).reshape(-1).double()
            out.append(fit_cubic(d0, d1))
        return torch.stack(out)

    # -- fusion ------------------------------------------------------------
    def fuse(self, emaps, pmaps, abcd):
        """(B, h, w) baselines, B lists of V view maps, (B, V, 4) cubics ->
        (B, H, W) u16 values as int32.  Each view's cubic is evaluated in
        the cubics' type (float64 from :meth:`register`), its result in
        float32."""
        dev = self.device
        b = emaps.shape[0]
        buf = None
        for i, lvl in enumerate(self.levels):
            if i == 0:
                idx = torch.from_numpy(L.level0_indices(
                    lvl.width, lvl.height, emaps.shape[-2:])).to(dev)
                buf = emaps.reshape(b, -1)[:, idx]
                rows = torch.arange(lvl.height, device=dev)[:, None]
                band = (rows >= lvl.band[0]) & (rows <= lvl.band[1])
                buf = torch.where(band, buf, 0.0)
            else:
                buf = buf.repeat_interleave(2, -2).repeat_interleave(2, -1)
            tgt = torch.zeros_like(buf)
            for v, box in enumerate(lvl.bboxes):
                x_lo, x_hi, y_lo, y_hi = box
                if y_lo > y_hi:
                    continue
                for k in range(b):
                    pm = pmaps[k][v]
                    idx = torch.from_numpy(L.slab_indices(
                        self.fovs[v], box, lvl.width, lvl.height,
                        tuple(pm.shape))).to(dev)
                    c = abcd[k, v]
                    s = torch.clamp(pm.reshape(-1)[idx], *CLAMP).to(c.dtype)
                    s = torch.clamp(((c[0] * s + c[1]) * s + c[2]) * s + c[3],
                                    0.0, 1.0).to(torch.float32)
                    tgt[k, y_lo:y_hi + 1, x_lo:x_hi + 1] += (
                        s[1:-1, 1:-1] - 0.25 * (s[1:-1, :-2] + s[1:-1, 2:]
                                                + s[:-2, 1:-1] + s[2:, 1:-1]))
            inv = torch.from_numpy(lvl.inv_cov).to(dev)
            buf = relax(buf, tgt * inv, inv > 0, lvl.iterations)
        return torch.floor(torch.clamp(buf, 0.0, 1.0) * 65535.0).to(
            torch.int32)

    @torch.no_grad()
    def __call__(self, rgbs_u8):
        """(B, H, W, 3) u8 -> ((B, H_out, W_out) u16 values as int32,
        (B, h, w) f32 baselines)."""
        with true_f32():
            rgbs = rgbs_u8.to(self.device, torch.float32) / 255.0
            bases, pmaps, abcd = [], [], []
            for k in range(rgbs.shape[0]):
                base, pm = self.models(rgbs[k])
                bases.append(base)
                pmaps.append(pm)
                abcd.append(self.register(base, pm))
            bases = torch.stack(bases)
            return self.fuse(bases, pmaps, torch.stack(abcd)), bases


def fit_cubic(x, y):
    """Least-squares ``y ~ a x^3 + b x^2 + c x + d`` in float64: a QR
    solve in the standardised variable ``t = (x - mean) / std``, expanded
    back to powers of ``x``."""
    m = x.mean()
    sig = torch.clamp_min(x.std(unbiased=False), 1e-12)
    t = (x - m) / sig
    a = torch.stack([t ** 3, t ** 2, t, torch.ones_like(t)], -1)
    p3, p2, p1, p0 = torch.linalg.lstsq(a, y[:, None]).solution[:, 0]
    a3, a2, a1 = p3 / sig ** 3, p2 / sig ** 2, p1 / sig
    return torch.stack([a3, a2 - 3 * a3 * m, a1 - 2 * a2 * m + 3 * a3 * m * m,
                        p0 - a1 * m + a2 * m * m - a3 * m ** 3])


def lap4_flat(buf):
    """The 5-point Laplacian with the reference's flat-index taps: column
    0's left neighbour is the previous row's last pixel (Depth.cpp:
    1696-1701); rows roll vertically."""
    b, h, w = buf.shape
    f = buf.reshape(b, h * w)
    nb = (torch.roll(f, 1, 1) + torch.roll(f, -1, 1) + torch.roll(f, w, 1)
          + torch.roll(f, -w, 1))
    return buf - 0.25 * nb.reshape(b, h, w)


def relax(buf, target, covered, iterations):
    """Jacobi relaxation toward ``target`` on the covered pixels
    (Depth.cpp:1680-1717): step 0.5, regularisation 1e-4, clamp to [0, 1]."""
    for _ in range(iterations):
        upd = buf + (target - lap4_flat(buf)) * STEP
        upd = torch.clamp(upd * (1.0 - REG) + buf * REG, 0.0, 1.0)
        buf = torch.where(covered, upd, buf)
    return buf
