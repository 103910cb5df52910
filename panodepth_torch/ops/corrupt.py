"""Train-time input corruption: JPEG artifacts, sensor noise, exposure.

Counterpart of ``panodepth/ops/corrupt.py``, in PyTorch on the batch's
device.  The reference's stage-A inputs are JPEGs of real photographs
(``Main.cpp:320``), where the training RGB is clean renders; corruption
adds what a camera pipeline adds: exposure variation, sensor noise and
JPEG compression.  Depth targets are never touched.

JPEG: the information loss of JPEG is the quantisation of the 8x8 block
DCT coefficients, which :func:`jpeg_artifacts` computes as JAX does: JFIF
RGB -> YCbCr, 4:2:0 chroma by box average, the orthonormal 8x8 DCT as
products with the 8x8 matrix (the JPEG FDCT's normalisation), Annex-K
tables under libjpeg's quality scaling, dequantisation, the inverse, the
chroma replicated back up.

Rounding to codes flips at exact ties (a luma value at .5, a DC
coefficient at a half step), where two f32 computations that differ in
the last place round apart.  So the arithmetic is JAX's on the CPU,
rounding for rounding: each multiply-add fused as XLA's CPU compilation
fuses it (:func:`_fma`), the 2x2 mean summed in row-major order, the
DCT's eight-term dot products summed as XLA sums them (:func:`_dot8`);
and divisions are true divisions and ``pow`` is rounded once from f64
(:func:`_div`, :func:`_pow`), where the card would multiply by a
reciprocal and its ``powf`` differs from the host's in the last place.
:func:`jpeg_artifacts` and :func:`eval_corruption` are then bit-equal to
JAX on the CPU, and the card computes the CPU's values.

The randomness is apart from the arithmetic: :func:`draw` makes a
:class:`CorruptDraws` from a ``torch.Generator`` (the values JAX draws
from its keys, ``corrupt.py:170-211``, with the same shapes and ranges),
and :func:`apply` is a deterministic function of the batch and the draws,
the arithmetic of JAX's ``corrupt``.  ``jax.random``'s streams cannot be
reproduced in PyTorch, so parity with JAX is held on JAX's draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# ITU-T T.81 Annex K quantisation tables (luminance, chrominance), in
# natural (not zigzag) order
_QTAB_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)
_QTAB_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float32)


def _dct8() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix D: ``D @ x @ D.T`` over an 8x8
    block is the JPEG FDCT (T.81 A.3.3) with its 1/4 C(u) C(v)
    normalisation, ``D.T @ X @ D`` its exact inverse."""
    n = np.arange(8)
    D = np.cos((2 * n[None, :] + 1) * n[:, None] * math.pi / 16.0)
    D = D * math.sqrt(2.0 / 8.0)
    D[0] *= 1.0 / math.sqrt(2.0)
    return D.astype(np.float32)


_DCT8 = _dct8()

# the colour transforms' coefficients as the f32 constants of JAX's graph
_K = {k: float(np.float32(v)) for k, v in dict(
    y_r=0.299, y_g=0.587, y_b=0.114, cb_r=-0.168736, cb_g=-0.331264,
    cr_g=-0.418688, cr_b=-0.081312, r_cr=1.402, g_cb=-0.344136,
    g_cr=-0.714136, b_cb=1.772).items()}


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def _div(a, b) -> torch.Tensor:
    """``a / b`` as a true division on every device (the card multiplies by
    the reciprocal of a Python-number divisor, and ``number / tensor`` is
    a reciprocal times the number)."""
    like = a if isinstance(a, torch.Tensor) else b
    as_t = lambda v: v if isinstance(v, torch.Tensor) else torch.full(
        (), v, dtype=like.dtype, device=like.device)
    return torch.div(as_t(a), as_t(b))


def _pow(x: torch.Tensor, e) -> torch.Tensor:
    """``x ** e`` rounded once from f64: the same f32 on the card as on the
    host, whose f32 ``pow`` implementations differ in the last place."""
    e = e.to(torch.float64) if isinstance(e, torch.Tensor) else e
    return (x.to(torch.float64) ** e).to(torch.float32)


def _quality_scale(table: np.ndarray, quality: torch.Tensor) -> torch.Tensor:
    """libjpeg's quality scaling (jcparam.c ``jpeg_quality_scaling``):
    quality 1..100 (a tensor, any shape that broadcasts against (8, 8))
    -> step sizes, clamped to [1, 255]."""
    q = torch.clamp(quality.to(torch.float32), 1.0, 100.0)
    scale = torch.where(q < 50.0, _div(5000.0, q), 200.0 - 2.0 * q)
    return torch.clamp(torch.floor(_div(_const(table, q) * scale + 50.0,
                                        100.0)), 1.0, 255.0)


def _box2(x: torch.Tensor) -> torch.Tensor:
    """The mean over axes 2 and 4 (of 2 each) of (B, h, 2, w, 2), summed
    in row-major order as XLA's CPU reduction sums them."""
    return (((x[:, :, 0, :, 0] + x[:, :, 0, :, 1]) + x[:, :, 1, :, 0])
            + x[:, :, 1, :, 1]) * 0.25


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H // 8, W // 8, 8, 8)."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // 8, 8, w // 8, 8)
    return torch.movedim(x, -3, -2)


def _unblockify(x: torch.Tensor) -> torch.Tensor:
    *lead, hb, wb, _, _ = x.shape
    return torch.movedim(x, -2, -3).reshape(*lead, hb * 8, wb * 8)


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, a fused multiply-add: the f64
    product of two f32 values is exact, and so (but for a double rounding
    on a far smaller addend) is its sum with an f32 value."""
    return (torch.as_tensor(a).to(torch.float64) * b
            + torch.as_tensor(c).to(torch.float64)).to(torch.float32)


def _dot8(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x`` (..., 8) times ``m`` (8, n) in the order XLA's CPU dot sums
    eight terms: four partial sums, each term k's rounded product fused
    with term k + 4's, then (s0 + s1) + (s2 + s3)."""
    s = _fma(x[..., 4:, None], m[4:], x[..., :4, None] * m[:4])
    return (s[..., 0, :] + s[..., 1, :]) + (s[..., 2, :] + s[..., 3, :])


def _quantize_plane(plane: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """DCT, quantise, dequantise, inverse DCT of one plane of centred codes
    (sample - 128).  ``qtab`` broadcasts: (8, 8) or per sample (B, 1, 1, 8,
    8).  ``D @ X @ D.T`` and ``D.T @ C @ D`` as JAX's einsums, each as two
    products with the 8x8 matrix (:func:`_dot8`)."""
    d = _const(_DCT8, plane)
    t = lambda a: a.transpose(-1, -2)
    blocks = _blockify(plane)
    coef = _dot8(t(_dot8(t(blocks), d.T)), d.T)
    coef = torch.round(coef / qtab) * qtab
    return _unblockify(_dot8(t(_dot8(t(coef), d)), d))


def jpeg_artifacts(rgb: torch.Tensor, quality) -> torch.Tensor:
    """JPEG 4:2:0 quantisation artifacts on a batch (B, H, W, 3) in [0, 1];
    H and W must be multiples of 16 (the 4:2:0 MCU).  ``quality`` is a
    number or a (B,) tensor in 1..100.  Returns the degraded batch in [0,
    1], of ``rgb``'s dtype."""
    b, h, w, _ = rgb.shape
    if h % 16 or w % 16:
        raise ValueError(f"jpeg_artifacts needs H, W multiples of 16 "
                         f"(4:2:0 MCU), got {h}x{w}")
    quality = torch.as_tensor(quality, dtype=torch.float32,
                              device=rgb.device).broadcast_to((b,))
    q = quality[:, None, None]
    # (B, 1, 1, 8, 8) against the block axes
    q_luma = _quality_scale(_QTAB_LUMA, q)[:, None, None]
    q_chroma = _quality_scale(_QTAB_CHROMA, q)[:, None, None]

    x = torch.round(torch.clamp(rgb.to(torch.float32), 0.0, 1.0) * 255.0)
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    # JFIF RGB -> YCbCr (T.871), centred at 0 for the DCT
    y = _fma(_K["y_b"], bl, _fma(_K["y_r"], r, _K["y_g"] * g)) - 128.0
    cb = _fma(0.5, bl, _fma(_K["cb_r"], r, _K["cb_g"] * g))
    cr = _fma(_K["cr_b"], bl, _fma(0.5, r, _K["cr_g"] * g))
    # 4:2:0: the mean of each 2x2 (libjpeg's h2v2 downsampler), rounded to
    # codes
    cb = torch.round(_box2(cb.reshape(b, h // 2, 2, w // 2, 2)))
    cr = torch.round(_box2(cr.reshape(b, h // 2, 2, w // 2, 2)))

    y = _quantize_plane(torch.round(y), q_luma)
    cb = _quantize_plane(cb, q_chroma)
    cr = _quantize_plane(cr, q_chroma)
    # the chroma replicated back up (libjpeg's -nosmooth)
    cb = cb.repeat_interleave(2, -2).repeat_interleave(2, -1)
    cr = cr.repeat_interleave(2, -2).repeat_interleave(2, -1)

    y = y + 128.0
    r = _fma(_K["r_cr"], cr, y)
    g = _fma(_K["g_cr"], cr, _fma(_K["g_cb"], cb, y))
    bl = _fma(_K["b_cb"], cb, y)
    out = torch.stack([r, g, bl], -1)
    return torch.clamp(_div(torch.round(out), 255.0), 0.0, 1.0).to(rgb.dtype)


class CorruptConfig(NamedTuple):
    """The corruption's distribution; each probability is per sample."""

    p_jpeg: float = 0.6
    quality: Tuple[float, float] = (25.0, 95.0)
    p_noise: float = 0.5
    noise_sigma: Tuple[float, float] = (0.0, 0.04)   # read noise, [0,1] units
    shot_sigma: float = 0.5   # shot-noise scale: sigma_px = s * sqrt(px)/255
    p_photo: float = 0.8
    gain: Tuple[float, float] = (0.6, 1.4)
    gamma: Tuple[float, float] = (0.7, 1.4)
    wb: float = 0.08          # per-channel white-balance jitter (+-)


class CorruptDraws(NamedTuple):
    """The random values of one corrupted batch of B images of (H, W, 3),
    with the shapes JAX draws them in: ``sel`` (3, B) uniform [0, 1) (the
    exposure, noise and JPEG stages are on where below their
    probabilities), ``wb`` (B, 1, 1, 3) white-balance factors, ``gamma``
    and ``gain`` (B, 1, 1, 1), ``sig`` (B, 1, 1, 1) the read-noise sigma,
    ``read`` and ``shot`` (B, H, W, 3) standard normals, ``quality`` (B,)
    the JPEG quality."""

    sel: torch.Tensor
    wb: torch.Tensor
    gamma: torch.Tensor
    gain: torch.Tensor
    sig: torch.Tensor
    read: torch.Tensor
    shot: torch.Tensor
    quality: torch.Tensor


def draw(shape, generator: torch.Generator,
         cfg: CorruptConfig = CorruptConfig()) -> CorruptDraws:
    """The draws for a batch of ``shape`` (B, H, W, 3) from ``generator``,
    on the generator's device."""
    b = shape[0]
    dev = generator.device
    kw = dict(generator=generator, device=dev, dtype=torch.float32)

    def uniform(size, lo, hi):
        return torch.rand(size, **kw) * (hi - lo) + lo

    return CorruptDraws(
        sel=torch.rand((3, b), **kw),
        wb=1.0 + uniform((b, 1, 1, 3), -cfg.wb, cfg.wb),
        gamma=uniform((b, 1, 1, 1), *cfg.gamma),
        gain=uniform((b, 1, 1, 1), *cfg.gain),
        sig=uniform((b, 1, 1, 1), *cfg.noise_sigma),
        read=torch.randn(tuple(shape), **kw),
        shot=torch.randn(tuple(shape), **kw),
        quality=uniform((b,), *cfg.quality))


def apply(rgb: torch.Tensor, draws: CorruptDraws,
          cfg: CorruptConfig = CorruptConfig()) -> torch.Tensor:
    """The corruption of ``rgb`` (B, H, W, 3) with ``draws``, in a camera's
    order: exposure (white balance, gamma, gain), sensor noise (shot and
    read), 8-bit quantisation and JPEG; each stage per sample where its
    ``sel`` is below its probability.  Deterministic in its inputs."""
    d = CorruptDraws(*(t.to(rgb.device) for t in draws))
    on_photo = (d.sel[0] < cfg.p_photo)[:, None, None, None]
    on_noise = (d.sel[1] < cfg.p_noise)[:, None, None, None]
    on_jpeg = (d.sel[2] < cfg.p_jpeg)[:, None, None, None]

    x = torch.clamp(rgb.to(torch.float32), 0.0, 1.0)
    photo = torch.clamp(_pow(x * d.wb, d.gamma) * d.gain, 0.0, 1.0)
    x = torch.where(on_photo, photo, x)

    read = d.read * d.sig
    shot = (d.shot * (cfg.shot_sigma / 255.0) * torch.sqrt(x * 255.0)
            * _div(d.sig, max(cfg.noise_sigma[1], 1e-6)))
    x = torch.where(on_noise, torch.clamp(x + read + shot, 0.0, 1.0), x)

    x = torch.where(on_jpeg, jpeg_artifacts(x, d.quality), x)
    return x.to(rgb.dtype)


def on_device(t: torch.Tensor, device) -> bool:
    """Whether ``t`` lies on ``device`` (``cuda`` meaning the current card)."""
    device = torch.device(device)
    return t.device.type == device.type and device.index in (
        None, t.device.index)


def corrupt(rgb: torch.Tensor, generator: torch.Generator,
            cfg: CorruptConfig = CorruptConfig()) -> torch.Tensor:
    """Randomised camera-pipeline corruption of an RGB batch (B, H, W, 3):
    :func:`draw` from ``generator`` (on ``rgb``'s device), then
    :func:`apply`."""
    if not on_device(rgb, generator.device):
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"batch on {rgb.device}")
    return apply(rgb, draw(rgb.shape, generator, cfg), cfg)


def batch_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of batch ``index`` of a stream: seeded from ``(seed ^
    0xC0DEC, index)``, so batch k's draws depend on the seed and k alone
    (a resumed stream draws what the whole one drew), as JAX's
    ``fold_in(PRNGKey(seed ^ 0xC0DEC), k)``."""
    key = (int(seed) ^ 0xC0DEC) & 0xFFFFFFFF
    # both numbers mixed into every bit (the CPU generator keeps the low 32)
    mixed = np.random.SeedSequence((key, int(index))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def corrupt_batches(batches, seed: int, cfg: CorruptConfig = CorruptConfig(),
                    device=None):
    """Corrupt the RGB of a (rgb, depth, valid) batch stream.

    A host batch's RGB (numpy, or a tensor on the CPU) goes to ``device``
    (pinned, without blocking) and is corrupted there; a device batch is
    corrupted where it lies.  Depth and valid pass through untouched.
    Batch k's draws come from :func:`batch_generator`\\ ``(seed, k)``.
    """
    for i, (rgb, depth, valid) in enumerate(batches):
        rgb = torch.as_tensor(rgb)
        dev = rgb.device if device is None else torch.device(device)
        if not on_device(rgb, dev):
            if dev.type == "cuda":
                rgb = rgb.pin_memory()
            rgb = rgb.to(dev, non_blocking=True)
        yield corrupt(rgb, batch_generator(seed, i, dev), cfg), depth, valid


def eval_noise(shape, seed: int = 0, device="cpu") -> torch.Tensor:
    """The standard normal draw of :func:`eval_corruption`: a generator on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


def eval_corruption(rgb: torch.Tensor, seed: int = 0, quality: float = 40.0,
                    sigma: float = 0.02,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed mid-severity corruption for held-out evaluation: gain 0.85,
    gamma 1.15, Gaussian noise of ``sigma``, JPEG at ``quality``, for every
    sample.  The noise is ``noise`` (standard normal, ``rgb``'s shape) or
    :func:`eval_noise` of ``seed``; the rest is deterministic, so clean
    against corrupted deltas compare across checkpoints."""
    if noise is None:
        noise = eval_noise(rgb.shape, seed, rgb.device)
    x = torch.clamp(rgb.to(torch.float32), 0.0, 1.0)
    x = torch.clamp(_pow(x, 1.15) * 0.85, 0.0, 1.0)
    x = torch.clamp(x + noise.to(x.device) * sigma, 0.0, 1.0)
    return jpeg_artifacts(x, quality).to(rgb.dtype)
