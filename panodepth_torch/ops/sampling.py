"""Equirect and perspective samplers.

Counterpart of the nearest and bilinear samplers of
``panodepth/ops/sampling.py`` (with ``sample_equirect_nearest_mc``, the
one-tap form of the bilinear sampler that the cubemap projections'
``taps="nearest"`` use).  The reference samples its depth maps
nearest-neighbour through C float->int casts:

* ``PerspectiveMap::Value`` (Depth.cpp:111-118):
  ``X = (int)(x * (w-1)); Y = (int)(y * (h-1))``
* ``EquirectangularMap::ValueAtCoord`` (Depth.cpp:551-556):
  ``x = (int)(azi / 2pi * (w-1)); y = (int)(zen / pi * (h-1))``

kept here as truncate-toward-zero then clip; these take numpy arrays or
torch tensors.  The bilinear sampler is the stage-A RGB warp, where the
reference relied on GL_LINEAR texture filtering (SphereMesh.cpp:58-88);
it takes tensors.  ``rotate_equirect`` resamples a panorama under a
rotation with it.

The gather tables of the extraction (``--extract-dtype``), each with its
sampler over the same taps: ``pack_rgb_u32`` (8-bit RGB in one word a
pixel, exact for 8-bit sources), ``pack_rgb565_u16`` (RGB565, plain or
Bayer-dithered) and ``pack_rgb565_pair_u32`` (the 565 codes of pixels x
and x+1 in one word, so one gather serves both horizontal taps).  The
JAX package keeps them as uint32 / uint16; here the word tables are
int32 and the 565 table int16, the same bits (PyTorch's unsigned types
lack the shifts): every right shift is masked, so a sign carried in by
the shift never reaches a channel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import graphs

TWO_PI = 2.0 * np.pi


def as01_post(x):
    """u16 -> f32 0~1 after a gather (floats pass through).

    Gather and the pointwise ``k / 65535`` commute exactly (u16 fits f32's
    mantissa), so 16-bit maps can be gathered first and normalized after.
    """
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32) / 65535.0 if x.dtype == torch.uint16 else x
    return x.astype(np.float32) / np.float32(65535.0) \
        if x.dtype == np.uint16 else x


def _trunc_index(v, n):
    """C-style (int) cast of ``v`` expected in [0, n-1], then clip."""
    if isinstance(v, torch.Tensor):
        return torch.clamp(v.to(torch.int64), 0, n - 1)
    return np.clip(v.astype(np.int64), 0, n - 1)


def sample_unit_nearest(img, x, y):
    """pmap.Value: channel 0 of ``img`` (H, W[, C]) at unit coords in [0, 1]."""
    if img.ndim == 3:
        img = img[..., 0]
    h, w = img.shape
    return img[_trunc_index(y * (h - 1), h), _trunc_index(x * (w - 1), w)]


def sample_equirect_nearest(img, azimuth, zenith):
    """emap.ValueAtCoord: an equirect map (H, W[, C]) at spherical coords."""
    if img.ndim == 3:
        img = img[..., 0]
    h, w = img.shape
    xi = _trunc_index(azimuth / TWO_PI * (w - 1), w)
    yi = _trunc_index(zenith / np.pi * (h - 1), h)
    return img[yi, xi]


def _bilinear_coords(h, w, azimuth, zenith):
    """Tap coordinates of the bilinear equirect sampler.

    Azimuth wraps at the seam, zenith clamps at the poles; texel centres
    follow the same (w-1)/(h-1) convention as the nearest samplers, so the
    two agree at exact pixel positions.  Returns (x0, x1, y0, y1, wx, wy),
    the weights shaped (..., 1).  Tensors only.
    """
    fx = (azimuth % TWO_PI) / TWO_PI * (w - 1)
    fy = torch.clamp(zenith / np.pi * (h - 1), 0.0, h - 1)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0 = torch.clamp(x0, 0, w - 1)
    x1 = (x0 + 1) % w  # azimuth wraps at the seam
    y0 = torch.clamp(y0, 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    return x0, x1, y0, y1, wx, wy


def bilinear_taps(img, taps):
    """Blend the four taps ``(x0, x1, y0, y1, wx, wy)`` of ``img`` (..., H,
    W, C), in the op order of the JAX sampler."""
    x0, x1, y0, y1, wx, wy = taps
    top = img[..., y0, x0, :] * (1 - wx) + img[..., y0, x1, :] * wx
    bot = img[..., y1, x0, :] * (1 - wx) + img[..., y1, x1, :] * wx
    return top * (1 - wy) + bot * wy


def sample_equirect_bilinear(img, azimuth, zenith):
    """Bilinear equirect sampling with azimuth wraparound (the stage-A RGB
    warp).  ``img`` is (H, W) or (H, W, C); see :func:`_bilinear_coords`."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    out = bilinear_taps(img, _bilinear_coords(h, w, azimuth, zenith))
    return out[..., 0] if squeeze else out


def nearest_of(taps):
    """The max-weight tap ``(x, y)`` of bilinear taps ``(x0, x1, y0, y1,
    wx, wy)``: x1 where wx >= 0.5, else x0 (likewise y)."""
    x0, x1, y0, y1, wx, wy = taps
    return (torch.where(wx[..., 0] >= 0.5, x1, x0),
            torch.where(wy[..., 0] >= 0.5, y1, y0))


def sample_equirect_nearest_mc(img, azimuth, zenith):
    """Multi-channel nearest equirect sampling with the bilinear sampler's
    tap convention (azimuth wrap included): the max-weight tap of each 2x2
    neighbourhood, one gather a pixel.  ``img`` is (H, W) or (H, W, C)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    xn, yn = nearest_of(_bilinear_coords(h, w, azimuth, zenith))
    out = img[yn, xn]
    return out[..., 0] if squeeze else out


def rotate_equirect(img, yaw=0.0, pitch=0.0, roll=0.0, out_shape=None):
    """An equirect image (H, W[, C]) resampled bilinearly under a 3D
    rotation: ``yaw`` about +z, ``pitch`` about +y, ``roll`` about +x
    (radians), applied in that order to each output pixel's ray before the
    source is sampled (the tilted caps of the unused
    ``shaders/fs_equirectangular2.txt``; also a rotation augmentation).
    The (w-1)/(h-1) texel convention of the other samplers, so the
    identity reproduces the source."""
    h, w = out_shape if out_shape is not None else img.shape[:2]
    dev = img.device
    x = torch.arange(w, dtype=torch.float32, device=dev) / (w - 1) * TWO_PI
    y = torch.arange(h, dtype=torch.float32, device=dev) / (h - 1) * np.pi
    zen, azi = torch.meshgrid(y, x, indexing="ij")
    sz = torch.sin(zen)
    d = torch.stack([sz * torch.cos(azi), sz * torch.sin(azi),
                     torch.cos(zen)], -1)

    def rot(axis, angle):
        c, s = np.cos(angle), np.sin(angle)
        i, j = {2: (0, 1), 1: (2, 0), 0: (1, 2)}[axis]
        m = np.eye(3, dtype=np.float32)
        m[i, i] = c
        m[j, j] = c
        m[i, j] = -s
        m[j, i] = s
        return m

    m = rot(0, roll) @ rot(1, pitch) @ rot(2, yaw)
    d = d @ torch.as_tensor(m.T, device=dev)
    src_azi = torch.atan2(d[..., 1], d[..., 0]) % TWO_PI
    src_zen = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    return sample_equirect_bilinear(img, src_azi, src_zen)


def _shr(v, bits: int, mask: int):
    """``(v >> bits) & mask`` of an int32 tensor: the mask drops the sign
    bits an arithmetic shift carries in."""
    return (v >> bits) & mask


def pack_rgb_u32(rgb):
    """(..., H, W, 3) 8-bit RGB (uint8, or f32 0~1 decoded from 8-bit) ->
    (..., H, W) int32 with R|G|B in the low 24 bits: one 4-byte gather a
    tap instead of a 3-channel one.  Exact for 8-bit sources."""
    if rgb.dtype != torch.uint8:
        rgb = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    r = rgb.to(torch.int32)
    return (r[..., 0] << 16) | (r[..., 1] << 8) | r[..., 2]


def packed_taps(packed, taps):
    """Blend the four taps of a :func:`pack_rgb_u32` table (..., H, W): the
    channels decoded to f32 integers, interpolated in the op order of
    :func:`bilinear_taps`, then scaled by 1/255.  (..., 3) f32."""
    x0, x1, y0, y1, wx, wy = taps

    def tap(yy, xx):
        v = packed[..., yy, xx]
        return torch.stack([_shr(v, 16, 0xFF), _shr(v, 8, 0xFF), v & 0xFF],
                           -1).to(torch.float32)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    return (top * (1 - wy) + bot * wy) * (1.0 / 255.0)


def sample_equirect_bilinear_packed(packed, azimuth, zenith):
    """Bilinear equirect RGB sampling from a :func:`pack_rgb_u32` table
    (H, W), with :func:`sample_equirect_bilinear`'s taps; (..., 3) f32 in
    0~1, the f32 path's values up to f32 rounding for 8-bit sources."""
    h, w = packed.shape
    return packed_taps(packed, _bilinear_coords(h, w, azimuth, zenith))


@graphs.device_cache(maxsize=8)
def _bayer_on(h: int, w: int, device: torch.device):
    base = torch.tensor([[0, 8, 2, 10], [12, 4, 14, 6],
                         [3, 11, 1, 9], [15, 7, 13, 5]], dtype=torch.float32)
    t = base.repeat((h + 3) // 4, (w + 3) // 4)[:h, :w].to(device)
    return (t + 0.5) / 16.0 - 0.5


def _bayer_offsets(h, w, device=None):
    """Per-pixel ordered-dither offsets in [-0.5, 0.5): the 4x4 Bayer
    matrix tiled over (h, w), zero-mean over every 4x4 block.  Cached per
    device (a CUDA graph may read it; no copy from the host a call)."""
    return _bayer_on(h, w, torch.device(device or "cpu"))


def pack_rgb565_u16(rgb, dither: bool = False):
    """(..., H, W, 3) RGB (uint8, or f32 0~1) -> (..., H, W) RGB565 codes,
    stored as int16 (the bits of JAX's uint16; ``& 0xFFFF`` of an int32
    copy gives the code).  Half the bytes of :func:`pack_rgb_u32`, at 5/6/5
    bits a channel (round to nearest, half to even).

    ``dither`` adds the Bayer 4x4 offset before rounding, phase-shifted per
    channel ((0, 0), (2, 2), (1, 3) rolls) so the three patterns
    decorrelate: banding becomes zero-mean noise, the worst channel error
    about one 565 step.
    """
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) * (1.0 / 255.0)
    rgb = torch.clamp(rgb.to(torch.float32), 0.0, 1.0)
    if dither:
        h, w = rgb.shape[-3], rgb.shape[-2]
        t = _bayer_offsets(h, w, rgb.device)
        tr, tg, tb = (t, torch.roll(t, (2, 2), (0, 1)),
                      torch.roll(t, (1, 3), (0, 1)))
        r = torch.clamp(torch.round(rgb[..., 0] * 31.0 + tr), 0, 31)
        g = torch.clamp(torch.round(rgb[..., 1] * 63.0 + tg), 0, 63)
        b = torch.clamp(torch.round(rgb[..., 2] * 31.0 + tb), 0, 31)
    else:
        r = torch.round(rgb[..., 0] * 31.0)
        g = torch.round(rgb[..., 1] * 63.0)
        b = torch.round(rgb[..., 2] * 31.0)
    code = ((r.to(torch.int32) << 11) | (g.to(torch.int32) << 5)
            | b.to(torch.int32))
    # 0..65535 into int16's bits: codes >= 2^15 wrap to negatives
    return torch.where(code >= 1 << 15, code - (1 << 16), code).to(
        torch.int16)


def _decode565(v):
    """int32 RGB565 code(s) -> (..., 3) f32 in 0~1 (the quantized levels),
    each channel's integer times the f32-rounded 1/31 or 1/63."""
    return torch.stack([_shr(v, 11, 0x1F) * (1.0 / 31.0),
                        _shr(v, 5, 0x3F) * (1.0 / 63.0),
                        (v & 0x1F) * (1.0 / 31.0)], -1).to(torch.float32)


def packed565_taps(packed, taps):
    """Blend the four taps of a :func:`pack_rgb565_u16` table (..., H, W),
    each decoded to its 0~1 levels, in :func:`bilinear_taps`' op order."""
    x0, x1, y0, y1, wx, wy = taps

    def tap(yy, xx):
        return _decode565(packed[..., yy, xx].to(torch.int32) & 0xFFFF)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def sample_equirect_bilinear_packed565(packed, azimuth, zenith):
    """Bilinear equirect RGB sampling from a :func:`pack_rgb565_u16` table
    (H, W); (..., 3) f32 in 0~1."""
    h, w = packed.shape
    return packed565_taps(packed, _bilinear_coords(h, w, azimuth, zenith))


def pack_rgb565_pair_u32(rgb, dither: bool = False):
    """(..., H, W, 3) RGB -> (..., H, W) int32: the RGB565 code of pixel x
    in the high 16 bits and of pixel (x+1) % W (the azimuth wrap baked in)
    in the low 16, so one gather serves a tap row's two pixels (two
    gathers a pixel instead of four).  Built in int64, then wrapped into
    int32 explicitly."""
    p = pack_rgb565_u16(rgb, dither=dither).to(torch.int64) & 0xFFFF
    v = (p << 16) | torch.roll(p, -1, -1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def packed565pair_taps(packed, taps):
    """Blend a :func:`pack_rgb565_pair_u32` table's two tap rows (..., H,
    W): bit for bit :func:`packed565_taps` on the 565 table (the same
    values in the same op order; only the gathers differ)."""
    x0, _x1, y0, y1, wx, wy = taps

    def row(yy):
        v = packed[..., yy, x0]
        left = _decode565(_shr(v, 16, 0xFFFF))     # pixel x0
        right = _decode565(v & 0xFFFF)             # pixel (x0 + 1) % w
        return left * (1 - wx) + right * wx

    return row(y0) * (1 - wy) + row(y1) * wy


def sample_equirect_bilinear_packed565pair(packed, azimuth, zenith):
    """Bilinear equirect RGB sampling from a :func:`pack_rgb565_pair_u32`
    table (H, W), one gather a tap row; (..., 3) f32 in 0~1."""
    h, w = packed.shape
    return packed565pair_taps(packed, _bilinear_coords(h, w, azimuth,
                                                       zenith))
