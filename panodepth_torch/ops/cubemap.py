"""Cubemap <-> equirectangular projections (the two-branch panoramic nets).

Counterpart of ``panodepth/ops/cubemap.py``: face order and orientation
+x, -x, +y, -y, +z, -z in the reference's z-up world frame (azimuth from
+x toward +y, zenith from +z; ``Depth.cpp:2955-2971``), pure gathers with
static tables.  ``_FACES``, ``_face_dirs`` and ``_cube_lookup`` are the JAX
package's host numpy code, copied as it is.

* Equirect -> cube samples the equirect map along each face pixel's ray
  with the bilinear sampler's taps (``ops/sampling.py``), or its one-tap
  form with ``taps="nearest"``.  The ray angles are computed on the host:
  ``arctan2`` and ``arccos`` in float64 of the f32 directions, rounded to
  f32 (JAX computes them in f32 on its device, a few ulps away), and the
  taps then in f32 on the CPU, so every device gathers the same taps.
* Cube -> equirect gathers each equirect pixel's face, clamped at the face
  edges (no cross-face blending), with float64 host tables.

The nets' activations are NCHW: :func:`equirect_to_cube_nchw` maps (N, C,
H, W) to (N*6, C, S, S) and :func:`cube_to_equirect_nchw` back;
:func:`equirect_to_cubemap` and :func:`cubemap_to_equirect` are the JAX
package's channels-last forms.  Bilinear taps blend in f32 (the weights
are f32), so a bf16 input comes out f32, as in JAX; nearest taps keep the
input's type.  The device tables live in ``graphs.device_cache``, so a
captured graph holds the tables it reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import graphs
from .sampling import _bilinear_coords, nearest_of

TWO_PI = 2.0 * np.pi
TAPS = ("bilinear", "nearest")

# face -> (forward, right, down) axes in the z-up world frame
_FACES = np.array(
    [
        # forward        right           down
        [[1, 0, 0], [0, 1, 0], [0, 0, -1]],   # +x
        [[-1, 0, 0], [0, -1, 0], [0, 0, -1]],  # -x
        [[0, 1, 0], [-1, 0, 0], [0, 0, -1]],   # +y
        [[0, -1, 0], [1, 0, 0], [0, 0, -1]],   # -y
        [[0, 0, 1], [0, 1, 0], [1, 0, 0]],     # +z (up)
        [[0, 0, -1], [0, 1, 0], [-1, 0, 0]],   # -z (down)
    ],
    np.float32,
)


def _face_dirs(face_size: int) -> np.ndarray:
    """(6, S, S, 3) unit ray directions through each face pixel center."""
    t = (np.arange(face_size, dtype=np.float32) + 0.5) / face_size * 2 - 1
    u, v = np.meshgrid(t, t)  # u: right, v: down
    dirs = []
    for fwd, right, down in _FACES:
        d = (fwd[None, None] + u[..., None] * right[None, None]
             + v[..., None] * down[None, None])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirs.append(d)
    return np.stack(dirs)


def _cube_lookup(out_h: int, out_w: int, face_size: int):
    """Static gather tables: equirect pixel -> (face, iy, ix) + bilinear w.

    Returns int/float numpy arrays so the lookup bakes into the graph.
    """
    x = (np.arange(out_w, dtype=np.float64) + 0.5) / out_w * TWO_PI
    y = (np.arange(out_h, dtype=np.float64) + 0.5) / out_h * np.pi
    azi, zen = np.meshgrid(x, y)
    d = np.stack(
        [np.sin(zen) * np.cos(azi), np.sin(zen) * np.sin(azi), np.cos(zen)],
        axis=-1,
    )
    # pick the face with the largest |projection on forward|
    fwd = _FACES[:, 0]  # (6, 3)
    proj = np.einsum("hwc,fc->hwf", d, fwd)
    face = np.argmax(proj, axis=-1)
    pf = np.take_along_axis(proj, face[..., None], axis=-1)[..., 0]
    dn = d / pf[..., None]  # scale so forward component == 1
    right = _FACES[:, 1][face]
    down = _FACES[:, 2][face]
    u = np.einsum("hwc,hwc->hw", dn, right)   # in [-1, 1]
    v = np.einsum("hwc,hwc->hw", dn, down)
    fx = (u + 1) / 2 * face_size - 0.5
    fy = (v + 1) / 2 * face_size - 0.5
    x0 = np.clip(np.floor(fx).astype(np.int32), 0, face_size - 1)
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, face_size - 1)
    x1 = np.minimum(x0 + 1, face_size - 1)
    y1 = np.minimum(y0 + 1, face_size - 1)
    wx = (fx - x0).astype(np.float32).clip(0, 1)
    wy = (fy - y0).astype(np.float32).clip(0, 1)
    return face.astype(np.int32), y0, x0, y1, x1, wx, wy


def _check_taps(taps: str):
    if taps not in TAPS:
        raise ValueError(f"taps must be one of {TAPS}, got {taps!r}")


def _table(idx, weights, device):
    """Flat int64 indices (one array, or four for bilinear) and the f32
    weights ``(wx, 1 - wx, wy, 1 - wy)`` as tensors on ``device``."""
    out = [torch.as_tensor(np.asarray(i, np.int64)) for i in idx]
    for w in weights:
        w = torch.as_tensor(np.asarray(w, np.float32))
        out += [w, 1 - w]
    return tuple(t.to(device) for t in out)


def _face_angles(face_size: int):
    """(azimuth, zenith) of each face pixel's ray, (6, S, S) f32 each:
    ``arctan2`` and ``arccos`` in float64 of the f32 directions, rounded
    once to f32 (then the azimuth taken mod 2 pi in f32, as in JAX)."""
    d = _face_dirs(face_size).astype(np.float64)
    azi = np.arctan2(d[..., 1], d[..., 0]).astype(np.float32) \
        % np.float32(TWO_PI)
    zen = np.arccos(np.clip(d[..., 2], -1.0, 1.0)).astype(np.float32)
    return azi, zen


@graphs.device_cache(maxsize=64)
def _cube_taps(face_size: int, h: int, w: int, taps: str, device):
    """Taps of the (6, S, S) face pixels into an (h, w) equirect grid."""
    azi, zen = _face_angles(face_size)
    bt = _bilinear_coords(h, w, torch.from_numpy(azi), torch.from_numpy(zen))
    if taps == "nearest":
        xn, yn = nearest_of(bt)
        return _table([yn * w + xn], [], device)
    x0, x1, y0, y1, wx, wy = bt
    return _table([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                  [wx[..., 0], wy[..., 0]], device)


@graphs.device_cache(maxsize=64)
def _equi_taps(out_h: int, out_w: int, face_size: int, taps: str, device):
    """Taps of the (out_h, out_w) equirect pixels into the 6 * S * S face
    pixels (:func:`_cube_lookup`)."""
    face, y0, x0, y1, x1, wx, wy = _cube_lookup(out_h, out_w, face_size)
    flat = lambda yy, xx: (face.astype(np.int64) * face_size + yy) \
        * face_size + xx
    if taps == "nearest":
        yn = np.where(wy >= 0.5, y1, y0)
        xn = np.where(wx >= 0.5, x1, x0)
        return _table([flat(yn, xn)], [], device)
    return _table([flat(y0, x0), flat(y0, x1), flat(y1, x0), flat(y1, x1)],
                  [wx, wy], device)


def _gather(flat, table):
    """``flat`` (N, C, L) at the table's taps -> (N, C, *tap shape): one
    gather, or four blended in the samplers' op order."""
    if len(table) == 1:
        return flat[:, :, table[0]]
    i00, i01, i10, i11, wx, wx1, wy, wy1 = table
    top = flat[:, :, i00] * wx1 + flat[:, :, i01] * wx
    bot = flat[:, :, i10] * wx1 + flat[:, :, i11] * wx
    return top * wy1 + bot * wy


def equirect_to_cube_nchw(x, face_size: int, taps: str = "bilinear"):
    """(N, C, H, W) equirect -> (N*6, C, S, S) cube faces, image-major."""
    _check_taps(taps)
    n, c, h, w = x.shape
    table = _cube_taps(face_size, h, w, taps, x.device)
    out = _gather(x.reshape(n, c, h * w), table)  # (N, C, 6, S, S)
    return out.transpose(1, 2).reshape(n * 6, c, face_size, face_size)


def cube_to_equirect_nchw(faces, out_h: int, out_w: int,
                          taps: str = "bilinear"):
    """(N*6, C, S, S) cube faces, image-major -> (N, C, out_h, out_w)."""
    _check_taps(taps)
    m, c, s, _ = faces.shape
    n = m // 6
    flat = faces.reshape(n, 6, c, s * s).transpose(1, 2).reshape(
        n, c, 6 * s * s)
    return _gather(flat, _equi_taps(out_h, out_w, s, taps, faces.device))


def equirect_to_cubemap(img, face_size: int, taps: str = "bilinear"):
    """Equirect (..., H, W, C) -> (..., 6, S, S, C) cube faces."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = equirect_to_cube_nchw(x, face_size, taps)
    return out.reshape(-1, 6, c, face_size, face_size).permute(
        0, 1, 3, 4, 2).reshape(*lead, 6, face_size, face_size, c)


def cubemap_to_equirect(faces, out_h: int, out_w: int,
                        taps: str = "bilinear"):
    """(..., 6, S, S, C) cube faces -> equirect (..., out_h, out_w, C)."""
    lead, (s, c) = faces.shape[:-4], faces.shape[-2:]
    x = faces.reshape(-1, s, s, c).permute(0, 3, 1, 2)
    out = cube_to_equirect_nchw(x, out_h, out_w, taps)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)
