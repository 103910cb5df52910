"""Per-view depth registration: a cubic per view by normal equations.

Counterpart of the main-path part of ``panodepth/registration.py``.  The
reference fits ``y = a x^3 + b x^2 + c x + d`` per perspective view against
the baseline panorama over a 1-degree sample grid with Ceres (Depth.cpp:
1261-1414, ``FunctorDepth2Depth3`` at Depth.cpp:1122-1138).  The model is
linear in (a, b, c, d), so each view is one weighted linear least-squares
solve; here all views are solved at once along a batch dimension.

The sample grid depends only on the layout and the zenith band, so it is
built on the host in float64 and quantized there to nearest-pixel gather
indices (f32 index arithmetic would flip pixel boundaries).  At run time
registration is two gathers and the batched (V, S, 4) solve.

Also, as in the JAX package: ``fit_cubic_global`` (the result-vs-baseline
re-registration ``SolveDepthToDepth2``, Depth.cpp:1158-1259), ``fit_poly``
/ ``apply_poly`` (the reference's functor family of degrees 1-4),
``fit_reciprocal`` / ``apply_reciprocal`` (the disparity model ``y = c/(a
x + b) + d``, ``FunctorDisparity2Depth`` at Depth.cpp:1044-1073,
``D2DTransform`` at Depth.cpp:214-243).  Every solver is plain tensor
arithmetic (no ``torch.linalg``), so it runs on the card with no host
sync and inside a CUDA graph.
"""

from __future__ import annotations

import functools
from math import comb
from typing import NamedTuple

import numpy as np
import torch

from . import geometry, graphs
from .config import MergeConfig
from .ops.sampling import as01_post

TWO_PI = 2.0 * np.pi
CLAMP_LO = 1e-4
CLAMP_HI = 1.0 - 1e-4


class SampleGrids(NamedTuple):
    """Per-view registration sample grids, padded to a common (V, R, C).

    ``weight`` is 1 on real samples and 0 on padding, so padding does not
    enter the fit (the reference builds (rows+1)x(cols+1) residuals per
    view, Depth.cpp:1290-1335).
    """

    xy_x: np.ndarray      # gnomonic x in the view, clamped to [0, 1]
    xy_y: np.ndarray
    azimuth: np.ndarray   # spherical coords of each sample
    zenith: np.ndarray
    weight: np.ndarray


@functools.lru_cache(maxsize=8)
def build_sample_grids(cfg: MergeConfig) -> SampleGrids:
    ranges = cfg.clamped_ranges()
    windows = geometry.layout_windows(cfg.layout.fovs)
    step = cfg.reg_step_rad
    zr0, zr1 = cfg.zenith_range

    per_view = []
    for v in range(ranges.shape[0]):
        r0, r1, rz0, rz1 = ranges[v]
        cols = int(round(abs(r1 - r0) / step))
        zt = max(zr0, rz0)
        zd = min(zr1, rz1)
        rows = int(round(abs(zd - zt) / step))
        c = np.arange(cols + 1, dtype=np.float64)
        r = np.arange(rows + 1, dtype=np.float64)
        azi = r0 + (r1 - r0) * c / cols
        zen = zt + (zd - zt) * r / rows
        azi_g, zen_g = np.meshgrid(azi, zen)  # (rows+1, cols+1)
        x, y = geometry.spherical_to_xy(geometry.window_at(windows, v),
                                        azi_g, zen_g)
        per_view.append((np.clip(x, 0, 1), np.clip(y, 0, 1), azi_g, zen_g))

    R = max(p[0].shape[0] for p in per_view)
    C = max(p[0].shape[1] for p in per_view)
    V = len(per_view)
    out = [np.zeros((V, R, C), np.float64) for _ in range(5)]
    for v, (x, y, a, z) in enumerate(per_view):
        r, c = x.shape
        for buf, val in zip(out, (x, y, a, z)):
            buf[v, :r, :c] = val
        out[4][v, :r, :c] = 1.0
    return SampleGrids(*out)


def grid_sample_indices(g: SampleGrids, emap_shape, pmap_shape, view=None):
    """Quantize the f64 sample grids to nearest indices (i32).

    Truncating cast after f64 scaling, clipped to bounds: the reference's
    Value()/ValueAtCoord nearest semantics.  ``view`` selects one view's
    pmap grid (heterogeneous shapes); ``None`` quantizes all views.
    """
    he, we = emap_shape
    hp, wp = pmap_shape
    xy_x = g.xy_x if view is None else g.xy_x[view]
    xy_y = g.xy_y if view is None else g.xy_y[view]
    exi = np.clip((g.azimuth / TWO_PI * (we - 1)).astype(np.int32), 0, we - 1)
    eyi = np.clip((g.zenith / np.pi * (he - 1)).astype(np.int32), 0, he - 1)
    pxi = np.clip((xy_x * (wp - 1)).astype(np.int32), 0, wp - 1)
    pyi = np.clip((xy_y * (hp - 1)).astype(np.int32), 0, hp - 1)
    return exi, eyi, pxi, pyi


@graphs.device_cache(maxsize=64)
def _device_tables(cfg: MergeConfig, emap_shape, pmap_shape, view,
                   device: torch.device):
    """:func:`grid_sample_indices` and the weights, as tensors on ``device``."""
    g = build_sample_grids(cfg)
    idx = tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                for a in grid_sample_indices(g, emap_shape, pmap_shape, view))
    return idx, torch.from_numpy(g.weight.astype(np.float32)).to(device)


def _clamp(v):
    return torch.clamp(v, CLAMP_LO, CLAMP_HI)


def _normal_solve4(A):
    """Batched least squares for (..., S, 4) systems: equilibrated normal
    equations and a hand-unrolled 4x4 Cholesky.

    The Gram matrix ``A^T A`` is one batched product.  Normal equations
    square the conditioning, so the system is scaled to unit diagonal and
    callers run iterative refinement.  The product must run in true f32:
    the merge path turns TF32 off (``pipeline.merge_arrays``).

    Returns ``solve(rhs)``: rhs is ``A^T b`` (..., 4), the result the
    least-squares solution (..., 4), reusing the factorization.
    """
    G = A.transpose(-1, -2) @ A                          # (..., 4, 4)
    d = torch.rsqrt(torch.clamp_min(torch.diagonal(G, dim1=-2, dim2=-1),
                                    1e-38))
    Gs = G * d[..., :, None] * d[..., None, :]           # unit diagonal

    # guards keep padding-degenerate views finite; downstream clamps absorb
    # the garbage coefficients the reference would also produce for
    # rank-deficient sample sets
    def ssqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-38))

    g = lambda i, j: Gs[..., i, j]
    l11 = ssqrt(g(0, 0))
    l21, l31, l41 = g(1, 0) / l11, g(2, 0) / l11, g(3, 0) / l11
    l22 = ssqrt(g(1, 1) - l21 * l21)
    l32 = (g(2, 1) - l31 * l21) / l22
    l42 = (g(3, 1) - l41 * l21) / l22
    l33 = ssqrt(g(2, 2) - l31 * l31 - l32 * l32)
    l43 = (g(3, 2) - l41 * l31 - l42 * l32) / l33
    l44 = ssqrt(g(3, 3) - l41 * l41 - l42 * l42 - l43 * l43)

    def solve(rhs):
        b = rhs * d
        # forward substitution L y = b
        y0 = b[..., 0] / l11
        y1 = (b[..., 1] - l21 * y0) / l22
        y2 = (b[..., 2] - l31 * y0 - l32 * y1) / l33
        y3 = (b[..., 3] - l41 * y0 - l42 * y1 - l43 * y2) / l44
        # back substitution L^T x = y
        x3 = y3 / l44
        x2 = (y2 - l43 * x3) / l33
        x1 = (y1 - l32 * x2 - l42 * x3) / l22
        x0 = (y0 - l21 * x1 - l31 * x2 - l41 * x3) / l11
        return torch.stack([x0, x1, x2, x3], -1) * d

    return solve


def _chol_solve_factory(G):
    """Equilibrated Cholesky solve of a small SPD system ``G`` (..., n, n)
    of static size n, unrolled into plain tensor arithmetic: the generic
    sibling of :func:`_normal_solve4`, in the JAX package's op order.
    Returns ``solve(rhs)`` for rhs (..., n), reusing the factorization."""
    n = G.shape[-1]
    d = torch.rsqrt(torch.clamp_min(torch.diagonal(G, dim1=-2, dim2=-1),
                                    1e-38))
    Gs = G * d[..., :, None] * d[..., None, :]           # unit diagonal

    def ssqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-38))

    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = Gs[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = ssqrt(acc) if i == j else acc / L[j][j]

    def solve(rhs):
        b = rhs * d
        y = [None] * n
        for i in range(n):
            acc = b[..., i]
            for k in range(i):
                acc = acc - L[i][k] * y[k]
            y[i] = acc / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            acc = y[i]
            for k in range(i + 1, n):
                acc = acc - L[k][i] * x[k]
            x[i] = acc / L[i][i]
        return torch.stack(x, -1) * d

    return solve


def _matvec(A, v):
    return (A @ v[..., None])[..., 0]


def fit_cubic(x, y, weight):
    """Weighted LSQ fit of y ~ a x^3 + b x^2 + c x + d over the last axis.

    ``x``, ``y``, ``weight`` are (..., S); returns (..., 4) abcd.  The
    converged Ceres solve of FunctorDepth2Depth3 (Depth.cpp:1122-1138) is
    the normal-equations solution.  The fit runs in a standardized basis
    t = (x - mean) / std over the weighted samples, so the moment matrix
    stays near-orthogonal in f32 however narrow the data, then two rounds
    of iterative refinement; the coefficients are expanded back to powers
    of x.
    """
    w = weight
    wsum = torch.clamp_min(torch.sum(w, -1), 1e-38)
    s = torch.sum(w * x, -1) / wsum
    var = torch.sum(w * (x - s[..., None]) ** 2, -1) / wsum
    sig = torch.clamp_min(torch.sqrt(var), 1e-6)
    t = (x - s[..., None]) / sig[..., None]
    V = torch.stack([t * t * t, t * t, t, torch.ones_like(t)], -1)
    Vw = V * w[..., None]
    yw = y * w
    VwT = Vw.transpose(-1, -2)
    solve = _normal_solve4(Vw)
    beta = solve(_matvec(VwT, yw))
    for _ in range(2):
        beta = beta + solve(_matvec(VwT, yw - _matvec(Vw, beta)))
    # expand a*t^3 + b*t^2 + c*t + d, t = (x - s)/sig, to powers of x
    a = beta[..., 0] / (sig * sig * sig)
    b = beta[..., 1] / (sig * sig)
    c = beta[..., 2] / sig
    d = beta[..., 3]
    return torch.stack([
        a,
        b - 3 * a * s,
        c - 2 * b * s + 3 * a * s * s,
        d - c * s + b * s * s - a * s * s * s,
    ], -1)


def register_views(emap, pmaps, cfg: MergeConfig):
    """Fit abcd for every view against the baseline emap.

    ``emap`` — (He, We[, C]) baseline equirect depth tensor, values 0~1.
    ``pmaps`` — (V, Hp, Wp) tensor of perspective depth maps, values 0~1,
    or a list of V per-view maps with heterogeneous shapes.  Returns a
    (V, 4) tensor on the inputs' device.

    Each view is fit independently, as the reference's one-view-at-a-time
    loop (Depth.cpp:789-810) does; here they are one batched solve.
    """
    emap2d = emap if emap.dim() == 2 else emap[..., 0]
    he, we = emap2d.shape
    device = emap2d.device
    if isinstance(pmaps, (list, tuple)):
        cols = []
        for v, pm in enumerate(pmaps):
            (exi, eyi, pxi, pyi), weight = _device_tables(
                cfg, (he, we), tuple(pm.shape[-2:]), v, device)
            cols.append(as01_post(pm[pyi, pxi]))
        d0 = _clamp(torch.stack(cols))
    else:
        nv, hp, wp = pmaps.shape
        (exi, eyi, pxi, pyi), weight = _device_tables(
            cfg, (he, we), (hp, wp), None, device)
        vidx = torch.arange(nv, device=device)[:, None, None]
        d0 = _clamp(as01_post(pmaps[vidx, pyi, pxi]))
    d1 = _clamp(as01_post(emap2d[eyi, exi]))
    nv = d0.shape[0]
    return fit_cubic(d0.to(torch.float32).reshape(nv, -1),
                     d1.to(torch.float32).reshape(nv, -1),
                     weight.reshape(nv, -1))


def register_views_batched(emaps, pmaps, cfg: MergeConfig):
    """:func:`register_views` for each panorama of a batch: ``emaps`` (B,
    He, We), ``pmaps`` a (B, V, Hp, Wp) tensor or a list of V (B, h, w)
    stacks; returns (B, V, 4).

    The panoramas are fit one at a time, each as its batch-1 call, so each
    gets the bits it gets alone: a batched Gram product may take another
    algorithm for another batch count, and a sum over more outputs another
    split.  Inside a CUDA graph the extra launches cost no host time.
    """
    per = (list(pmaps) if isinstance(pmaps, torch.Tensor)
           else [list(p) for p in zip(*pmaps)])
    return torch.stack([register_views(emaps[k], per[k], cfg)
                        for k in range(emaps.shape[0])])


def apply_cubic(img, abcd):
    """Depth2DepthTransform: clamp x to [1e-4, 1-1e-4], cubic, clamp [0, 1].

    Mirrors reference Depth.cpp:245-274.
    """
    x = _clamp(img)
    a, b, c, d = abcd[..., 0], abcd[..., 1], abcd[..., 2], abcd[..., 3]
    y = ((a * x + b) * x + c) * x + d
    return torch.clamp(y, 0.0, 1.0)


def _integer_pow(x, k: int):
    """``x ** k`` for a Python int k >= 0 by JAX's ``integer_pow``
    (square-and-multiply in its order), not ``torch.pow``'s libm call."""
    if k == 0:
        return torch.ones_like(x)
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


@graphs.device_cache(maxsize=16)
def _global_indices(emap_shape, result_shape, zenith_range,
                    device: torch.device):
    """Rows [y0, y1] of the result and the baseline's nearest (eyi, exi)
    at each of their pixels' spherical coords, built in float64 on the
    host as ``register_views``' indices are."""
    he, we = emap_shape
    h, w = result_shape
    y0 = int(np.floor(h * zenith_range[0] / np.pi))
    y1 = int(np.ceil(h * zenith_range[1] / np.pi))
    ys, xs = np.meshgrid(np.arange(y0, y1 + 1, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    azi = xs / (w - 1) * TWO_PI
    zen = ys / (h - 1) * np.pi
    exi = np.clip((azi / TWO_PI * (we - 1)).astype(np.int32), 0, we - 1)
    eyi = np.clip((zen / np.pi * (he - 1)).astype(np.int32), 0, he - 1)
    return y0, y1, (torch.from_numpy(eyi.astype(np.int64)).to(device),
                    torch.from_numpy(exi.astype(np.int64)).to(device))


def fit_cubic_global(result01, emap, zenith_range):
    """Global cubic re-registration of the fused panorama to the baseline
    (SolveDepthToDepth2, Depth.cpp:1158-1259): every pixel of the rows
    [floor(H*zr0/pi), ceil(H*zr1/pi)] of ``result01`` (H, W) 0~1 paired
    with the baseline's nearest sample at its spherical coord.  Returns
    (4,) abcd."""
    emap2d = emap if emap.dim() == 2 else emap[..., 0]
    y0, y1, (eyi, exi) = _global_indices(
        tuple(emap2d.shape), tuple(result01.shape),
        tuple(float(z) for z in zenith_range), result01.device)
    d0 = _clamp(result01[y0:y1 + 1, :])
    d1 = _clamp(emap2d[eyi, exi])
    return fit_cubic(d0.reshape(-1), d1.reshape(-1),
                     torch.ones_like(d0).reshape(-1))


def apply_reciprocal(img, abcd):
    """D2DTransform: y = c / (a x + b) + d with apply_cubic's clamps
    (Depth.cpp:214-243)."""
    x = _clamp(img)
    a, b, c, d = abcd[..., 0], abcd[..., 1], abcd[..., 2], abcd[..., 3]
    y = c / (a * x + b) + d
    return torch.clamp(y, 0.0, 1.0)


def fit_poly(x, y, weight, degree: int = 3):
    """Weighted LSQ fit of y ~ sum_k c_k x^k, highest power first: (degree
    + 1,) coefficients for :func:`apply_poly`.

    The reference's functor family: degree 1 FunctorDepth2Depth
    (Depth.cpp:1076-1121), 2 FunctorDepth2Depth2 (Depth.cpp:1091-1106), 3
    FunctorDepth2Depth3 (:func:`fit_cubic`, the active model), 4
    FunctorDepth2Depth4 (Depth.cpp:1139-1156).  The same standardized
    basis, equilibrated normal equations and two refinement rounds as
    :func:`fit_cubic`, then the binomial expansion back to powers of x,
    summed in the JAX package's order.
    """
    x = x.reshape(-1)
    y = y.reshape(-1)
    w = weight.reshape(-1)
    if degree == 3:
        return fit_cubic(x, y, w)
    wsum = torch.clamp_min(torch.sum(w), 1e-38)
    s = torch.sum(w * x) / wsum
    var = torch.sum(w * (x - s) ** 2) / wsum
    sig = torch.clamp_min(torch.sqrt(var), 1e-6)
    t = (x - s) / sig
    V = torch.stack([_integer_pow(t, k) for k in range(degree, -1, -1)], -1)
    Vw = V * w[:, None]
    yw = y * w
    VwT = Vw.T
    solve = _chol_solve_factory(VwT @ Vw)
    beta = solve(VwT @ yw)
    for _ in range(2):
        beta = beta + solve(VwT @ (yw - Vw @ beta))
    # b_k sig^-(d-k) (x - s)^(d-k), expanded binomially into x^j
    out = [torch.zeros((), dtype=beta.dtype, device=beta.device)
           for _ in range(degree + 1)]
    for k in range(degree + 1):
        p = degree - k
        bk = beta[k] / _integer_pow(sig, p)
        for j in range(p + 1):
            coeff = comb(p, j) * _integer_pow(-s, p - j)
            out[degree - j] = out[degree - j] + bk * coeff
    return torch.stack(out)


def apply_poly(img, coeffs):
    """Pointwise polynomial remap (Horner, as ``jnp.polyval``) with the
    reference's clamps."""
    x = _clamp(img)
    y = torch.zeros_like(x)
    for k in range(coeffs.shape[-1]):
        y = y * x + coeffs[..., k]
    return torch.clamp(y, 0.0, 1.0)


def fit_reciprocal(x, y, weight, init=(1.0, 1.0, 1.0, 1.0), iters: int = 50):
    """Levenberg-Marquardt fit of y ~ c / (a x + b) + d (disparity to
    depth; the reference's declared but undefined SolveDisparityToDepth,
    Depth.h:293-294).  Returns (4,) abcd.

    The model has a gauge freedom (a, b, c scale together), so plain
    Gauss-Newton diverges; LM damping keeps the steps finite.  ``iters``
    accept/reject steps, each chosen by ``torch.where`` on the device
    (no host sync).  The Jacobian's four columns are written out as
    ``jax.jacfwd`` forms them (the quotient's JVP: ``-u' c / u^2`` as
    ``(-u' c) * (1 / (u u))``).
    """
    x = x.reshape(-1)
    y = y.reshape(-1)
    w = weight.reshape(-1)

    def residual(p):
        return w * (p[2] / (p[0] * x + p[1]) + p[3] - y)

    def cost(p):
        r = residual(p)
        return torch.sum(r * r)

    def jacobian(p):
        u = p[0] * x + p[1]
        inv_u2 = 1.0 / (u * u)
        return torch.stack([w * ((-x * p[2]) * inv_u2),
                            w * ((-p[2]) * inv_u2),
                            w * (1.0 / u),
                            w], -1)

    # made by fills on the device: no host-to-device copy, so a CUDA
    # graph can capture the fit
    full = functools.partial(torch.full, (), dtype=torch.float32,
                             device=x.device)
    eye = torch.eye(4, dtype=torch.float32, device=x.device)
    p = torch.stack([full(float(v)) for v in init])
    lam = full(1e-3)
    for _ in range(iters):
        r = residual(p)
        J = jacobian(p)
        JTJ = J.T @ J
        damped = JTJ + lam * torch.diag(torch.diagonal(JTJ)) + 1e-12 * eye
        delta = _chol_solve_factory(damped)(J.T @ r)
        p_new = p - delta
        better = cost(p_new) < cost(p)
        p = torch.where(better, p_new, p)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0),
                          1e-9, 1e6)
    return p
