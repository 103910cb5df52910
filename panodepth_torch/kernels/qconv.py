"""int8 convolution and its activation quantization: the hand-written CUDA
kernels and their plain twins.

The int8 perspective graph (``models/layers.QConv``, the counterpart of
``panodepth/models/perspective.py::QConv``) quantizes each activation per
image, convolves the int8 codes with int8 weight codes into exact int32
sums and scales them back to the compute type.  The JAX package leaves all
of that to XLA (``jnp`` ops and ``lax.conv_general_dilated(...,
preferred_element_type=jnp.int32)``, perspective.py:62-72); on the card no
PyTorch conv computes it (``F.conv2d`` takes no int8), so the port has two
kernels of its own.  Neither is the port of a TPU kernel: no Pallas kernel
of the JAX package computes these.

``cuda_quantize_nhwc`` launches ``csrc/quantize.cu`` (one launch of a
persistent grid that reads each input byte once: an image's slices stay
in shared memory from their absmax to their codes, the blocks of an image
meeting on its absmax word; a plan per shape from :func:`quantize_plan`);
``quantize_nhwc_plain`` is the same function in plain PyTorch,
:func:`to_nhwc` of :func:`quantize_activation`.  Both take an NCHW bf16 or
f32 activation and return its int8 codes NHWC with the channels
zero-padded to a multiple of 16, and the f32 (N,) scales.

``cuda_qconv`` launches ``csrc/qconv.cu``: an implicit GEMM on the int8
tensor cores (wgmma, the weights by TMA, a plan per shape from
:func:`qconv_plan`) with the scaling epilogue fused (the source note says
what bounds it).  ``qconv_plain`` is the same function in plain PyTorch:
the conv in float64 on the integer codes (exact: every partial sum is an
integer far below 2^53), cast to int32, then the epilogue in PyTorch ops.
Both take

* ``xq``: int8 (N, H, W, Cinp), the activation's codes NHWC with the
  channels zero-padded to a multiple of 16 (:func:`quantize_nhwc`);
* ``wq``: int8 (Cout, Kp), the weight codes with K ordered (kh, kw, Cinp)
  and zero-padded to a multiple of 64 (:func:`prepare_weight`);
* ``sx`` f32 (N,) and ``scale`` f32 (Cout,), the codes' scales; ``bias``
  f32 (Cout,) or None;
* ``kernel`` (kh, kw), ``strides`` (sh, sw), ``pads`` ((top, bottom),
  (left, right)), ``out_dtype`` bf16 or f32,

and return the NCHW ``out_dtype`` output ``(f32(acc) * (sx[n] *
scale[c])).to(out_dtype)`` plus ``bias.to(out_dtype)``, in JAX's order of
operations.  :func:`resolve` maps a route to one of them: ``auto`` takes the
kernel for a CUDA tensor and the twin for a CPU tensor, ``kernel`` always
the kernel (which raises on a CPU tensor), ``torch`` always the twin; with
``op="quantize"`` it does the same for the quantization.  Nothing falls
back.  The CPU tests hold the twins against the JAX package, and the card
holds the kernels against the twins on the same inputs.

The kernels are reached through the PyTorch operators
``panodepth_torch::qconv`` and ``panodepth_torch::quantize_nhwc``
(``torch.library.custom_op``, CUDA only, with fake implementations for
tracers), so a program that ``torch.export`` traces holds each kernel as
one node (``serve.py``).  The int8 graph is for inference: nothing here
has a backward.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# the operators' namespace: the package's name (see kernels/jacobi.py)
OPS = __name__.split(".")[0]

# kernel launches made by the wrappers in this process: qconv one a call,
# the quantization QUANTIZE_KERNELS a call
LAUNCHES = 0
QUANTIZE_LAUNCHES = 0
QUANTIZE_KERNELS = 1

CIN_ALIGN = 16  # the input's channels padded to this (a 16-byte copy)
K_ALIGN = 64    # the weights' K padded to this
_DTYPES = (torch.bfloat16, torch.float32)

# the qconv kernel's geometry (csrc/qconv.cu) and the card's
BM = 128             # output pixels a block (two warpgroups of 64 rows)
BK = 128             # K bytes a pipeline stage (one 128-byte swizzle row)
TILE_N = (32, 64, 128)  # output channels a block: wgmma's N
# the ring's depth at each tile width: two blocks an SM in shared memory
# (loads run stages - 2 tiles ahead)
STAGES = {32: 4, 64: 4, 128: 3}
MIN_STAGES, MAX_STAGES = 3, 8
SMS = 132            # streaming multiprocessors of an H100 SXM
SMEM_BLOCK = 232448      # shared memory a block may take
SMEM_MAX = SMEM_BLOCK - 256  # dynamic shared memory a qconv block takes
MIN_SPLIT_KTILES = 3     # K tiles a split keeps at the least

# the quantization kernel's geometry (csrc/quantize.cu) and the card's
# the blocks an SM a plan may take (at most __launch_bounds__'), in the
# order a plan prefers them at equal waves (scripts/torch_kernel_ab.py
# --kernels quantize --sweep: fewer, larger blocks were faster)
Q_BLOCKS_PER_SM = (2, 1, 4)
SMEM_SM = 233472         # shared memory of an SM
SMEM_RESERVED = 1024     # the runtime's own shared memory a block
Q_SMEM_STATIC = 512      # the kernel's static shared memory, at the most
Q_ALIGN = 128            # a stage's and a box's alignment in shared memory
Q_STAGES = 3             # shared-memory stages a block
MAX_BOX = 256            # TMA's largest box side


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def prepare_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """The int8 OIHW weight codes as the kernel reads them: (Cout, Kp),
    K ordered (kh, kw, Cinp), Cin padded to Cinp and K to Kp with zeros."""
    cout, cin, kh, kw = kernel_q.shape
    cinp = _round_up(cin, CIN_ALIGN)
    w = F.pad(kernel_q.permute(0, 2, 3, 1), (0, cinp - cin))
    w = w.reshape(cout, kh * kw * cinp)
    return F.pad(w, (0, _round_up(w.shape[1], K_ALIGN) - w.shape[1])) \
        .contiguous()


def quantize_activation(x: torch.Tensor):
    """JAX's dynamic per-image quantization (perspective.py:62-67) of the
    NCHW activation ``x``: ``sx = max(amax|x|, 1e-8) / 127`` per image and
    the codes ``clip(round(x / sx), -127, 127)`` as int8 (round half to
    even, as ``jnp.round``).  Both divisions are true divisions (a tensor
    divisor; PyTorch multiplies by a Python scalar's reciprocal on the
    card), as JAX computes them op by op.  (Under ``jax.jit`` XLA turns the
    division by the constant 127 into a product by f32(1/127), whose last
    bit differs for ~5 % of amaxes; the port keeps the true division.)
    Returns (int8 NCHW codes, f32 (N,) scales)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())))
    sx = torch.clamp_min(amax, 1e-8) / torch.full((), 127.0,
                                                  device=x.device)
    xq = torch.clamp(torch.round(xf / sx.view((-1,) + (1,) * (x.dim() - 1))),
                     -127, 127).to(torch.int8)
    return xq, sx


def to_nhwc(xq: torch.Tensor) -> torch.Tensor:
    """int8 NCHW codes -> contiguous NHWC, channels zero-padded to a
    multiple of 16."""
    cin = xq.shape[1]
    x = xq.permute(0, 2, 3, 1)
    pad = _round_up(cin, CIN_ALIGN) - cin
    return (F.pad(x, (0, pad)) if pad else x).contiguous()


def out_size(size: int, k: int, stride: int, pads) -> int:
    return (size + pads[0] + pads[1] - k) // stride + 1


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """lax's SAME padding (before, after) of one spatial axis (the nets'
    ``models.layers.same_pads`` too)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of a launch, passed to ``panodepth_qconv``:
    the ring of A and B tiles, or the epilogue's staging where larger (it
    takes the ring's place once the sums are in registers), plus the
    1024-byte alignment.  The kernel carves its shared memory so; this is
    the one place its size is computed."""
    return 1024 + max(stages * (BM + bn) * BK, bn * (BM + 4) * 4)


@dataclass(frozen=True)
class QConvPlan:
    """One launch of ``csrc/qconv.cu``: the GEMM's sizes, the output tile
    (``BM`` x ``bn``), the depth of the ring and the split of K: a block
    a tile and split."""

    m: int        # output pixels, N * Ho * Wo
    cout: int
    ktaps: int    # kh * kw * Cinp: the real part of K
    bn: int
    stages: int
    splits: int

    @property
    def m_tiles(self) -> int:
        return -(-self.m // BM)

    @property
    def n_tiles(self) -> int:
        return -(-self.cout // self.bn)

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def ktiles(self) -> int:
        return -(-self.ktaps // BK)

    @property
    def ktiles_per_split(self) -> int:
        return -(-self.ktiles // self.splits)

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.bn, self.stages)

    @property
    def workspace_bytes(self) -> int:
        """The split-K workspace: a counter per tile (rounded up to 4), then
        each split's int32 sums of each tile; none without a split."""
        if self.splits == 1:
            return 0
        return 4 * (_round_up(self.tiles, 4)
                    + self.tiles * self.splits * BM * self.bn)


def qconv_plan(n: int, h: int, w: int, cinp: int, cout: int, kh: int,
               kw: int, sh: int, sw: int, pads=None) -> QConvPlan:
    """The launch plan of one conv shape (``pads`` ((top, bottom), (left,
    right)), lax's SAME by default).

    The tile is 32, 64 or 128 channels wide, the narrowest that holds
    Cout (the stem and the 32- and 64-wide layers fill theirs).  Where
    the output tiles number fewer than the SMs (the 16x16 and 8x8 layers
    of the GN perspective net at 15 views), K is split so that the blocks
    come to at most one wave, each split keeping at least
    ``MIN_SPLIT_KTILES`` K tiles (int32 sums commute: the split changes
    no bit).  The ring is as deep as two blocks an SM allow
    (``STAGES``)."""
    if pads is None:
        pads = (same_pads(h, kh, sh), same_pads(w, kw, sw))
    ho = out_size(h, kh, sh, pads[0])
    wo = out_size(w, kw, sw, pads[1])
    bn = next(t for t in TILE_N if cout <= t or t == TILE_N[-1])
    plan = QConvPlan(n * ho * wo, cout, kh * kw * cinp, bn, STAGES[bn], 1)
    if plan.tiles < SMS:
        splits = max(1, min(SMS // plan.tiles,
                            plan.ktiles // MIN_SPLIT_KTILES))
        per = -(-plan.ktiles // splits)
        splits = -(-plan.ktiles // per)  # no split left empty
        plan = QConvPlan(plan.m, cout, plan.ktaps, bn, STAGES[bn], splits)
    return plan


def smem_max(blocks_per_sm: int) -> int:
    """The most dynamic shared memory a quantization block may take at
    ``blocks_per_sm`` blocks an SM: the SM's, less the static and the
    runtime's shared memory of each block, within a block's limit."""
    return min(SMEM_SM // blocks_per_sm - SMEM_RESERVED,
               SMEM_BLOCK) - Q_SMEM_STATIC


@dataclass(frozen=True)
class QuantizePlan:
    """One launch of ``csrc/quantize.cu``.  An image (``c`` channels by
    ``pixels``) is cut into tiles of ``tc`` channels (``c`` itself, or a
    multiple of 16 below it) by ``nb`` boxes of ``bw`` pixels; block ``b``
    of the grid (``ipw`` images a wave, ``spi`` blocks an image) takes
    slice ``b % spi`` (``k`` tiles) of image ``wave * ipw + b // spi`` in
    each wave.  ``k > 1`` is the L2 path: the slice's tiles stream through
    the stages twice, for the absmax and for the codes.  ``tma``: the
    tiles arrive by TMA (16-byte aligned rows), else by plain loads
    (``nb`` 1)."""

    n: int
    c: int
    pixels: int
    esize: int          # bytes an element: 2 (bf16) or 4 (f32)
    tma: bool
    tc: int
    bw: int
    nb: int
    k: int
    ipw: int
    blocks_per_sm: int

    @property
    def cinp(self) -> int:
        return _round_up(self.c, CIN_ALIGN)

    @property
    def width(self) -> int:
        """A tile's pixels."""
        return self.nb * self.bw

    @property
    def tiles_c(self) -> int:
        return -(-self.c // self.tc)

    @property
    def tiles_p(self) -> int:
        return -(-self.pixels // self.width)

    @property
    def tiles(self) -> int:
        """Tiles an image."""
        return self.tiles_c * self.tiles_p

    @property
    def spi(self) -> int:
        """Slices (blocks) an image."""
        return -(-self.tiles // self.k)

    @property
    def waves(self) -> int:
        return -(-self.n // self.ipw)

    @property
    def grid(self) -> int:
        return self.ipw * self.spi

    @property
    def l2(self) -> bool:
        return self.k > 1

    @property
    def box_bytes(self) -> int:
        return _round_up(self.tc * self.bw * self.esize, Q_ALIGN)

    @property
    def stage_bytes(self) -> int:
        return self.nb * self.box_bytes

    @property
    def tcp(self) -> int:
        """The channels a tile's codes cover: ``tc``, or all of ``cinp``."""
        return self.cinp if self.tc == self.c else self.tc

    @property
    def code_stride(self) -> int:
        """Bytes a pixel in the codes' tile: an odd number of 16-byte
        pieces, so that 16-byte stores of neighbouring pixels meet no bank
        conflict."""
        return self.tcp if self.tcp // 16 % 2 else self.tcp + 16

    @property
    def code_px(self) -> int:
        """Pixels a round of the codes' tile holds: the tile's, or the most
        (a power of two, 32 at the least) that the shared memory left
        beside the stages holds; 0 where not even 32 fit."""
        room = (smem_max(self.blocks_per_sm) - Q_ALIGN
                - Q_STAGES * self.stage_bytes) // self.code_stride
        if room >= self.width:
            return self.width
        return 1 << (room.bit_length() - 1) if room >= 32 else 0

    @property
    def code_bytes(self) -> int:
        return _round_up(self.code_px * self.code_stride, Q_ALIGN)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of the launch: the stages, the codes' tile
        and the alignment."""
        return Q_STAGES * self.stage_bytes + self.code_bytes + Q_ALIGN

    def tile_origin(self, tile: int) -> Tuple[int, int]:
        """(first channel, first pixel) of tile ``tile`` of an image."""
        tc_i, tp_i = divmod(tile, self.tiles_p)
        return tc_i * self.tc, tp_i * self.width

    def slice_tiles(self, block: int) -> range:
        """The tiles (of its image) that block ``block`` takes a wave."""
        j = block % self.spi
        return range(j * self.k, min(self.tiles, (j + 1) * self.k))

    def image(self, wave: int, block: int) -> Optional[int]:
        """The image of block ``block`` in wave ``wave`` (None: idle)."""
        img = wave * self.ipw + block // self.spi
        return img if img < self.n else None


def _geometries(c: int, pixels: int, esize: int, tma: bool):
    """The tile shapes (tc, bw, nb) a plan may take: ``tc`` the channels or
    a power-of-two multiple of 32 below them (at most ``MAX_BOX`` under
    TMA: a pixel's codes in runs of whole 32-byte sectors); the pixels a
    power of two (times the vector) up to the row, the row itself, or
    (TMA) whole boxes of ``MAX_BOX``."""
    vec = 16 // esize
    row = _round_up(pixels, vec)
    tcs = [32 << i for i in range(4) if 32 << i < c]
    if c <= MAX_BOX or not tma:
        tcs.append(c)
    widths = {(vec << i, 1) for i in range(32) if vec << i < row}
    if not tma or row <= MAX_BOX:
        widths.add((row, 1))
    if tma:
        widths = {(w, nb) for w, nb in widths if w <= MAX_BOX}
        if row > MAX_BOX:
            widths |= {(MAX_BOX, nb) for nb in range(1, -(-row // MAX_BOX) + 1)}
    return [(tc, bw, nb) for tc in tcs for bw, nb in sorted(widths)]


@functools.lru_cache(maxsize=None)
def quantize_plan(n: int, c: int, pixels: int, dtype=torch.float32,
                  aligned: bool = True, sms: int = SMS,
                  blocks_per_sm: Optional[int] = None,
                  images_per_wave: Optional[int] = None) -> QuantizePlan:
    """The launch plan of one quantization shape (``aligned``: the input is
    16-byte aligned; ``sms`` the card's SMs).

    At each candidate number of blocks an SM (``Q_BLOCKS_PER_SM``, or
    ``blocks_per_sm``) the grid has ``sms`` times as many blocks, each with
    ``Q_STAGES`` stages and the codes' tile in at most :func:`smem_max`
    bytes.  An image fits (is resident) when some tile shape within that
    needs no more tiles than
    the grid has blocks; then a wave takes as many images as fit, the waves
    balanced (or ``images_per_wave``), and the tile is the smallest whose
    count fits the blocks an image (of equal ones, the widest rows: TMA
    reads long rows best).  An image that does not fit takes the
    L2 path, one a wave, with the largest tile and ``k`` tiles a block.
    Of the candidates, the fewest waves win, then the blocks an SM first
    in ``Q_BLOCKS_PER_SM``."""
    esize = torch.empty((), dtype=dtype).element_size()
    if esize not in (2, 4):
        raise ValueError(f"quantize_plan: bf16 or f32, got {dtype}")
    tma = aligned and pixels * esize % 16 == 0
    geoms = _geometries(c, pixels, esize, tma)
    best = None
    for bps in ((blocks_per_sm,) if blocks_per_sm else Q_BLOCKS_PER_SM):
        blocks = sms * bps
        plans = [QuantizePlan(n, c, pixels, esize, tma, tc, bw, nb, 1, 1,
                              bps) for tc, bw, nb in geoms]
        plans = [p for p in plans
                 if p.code_px and p.smem_bytes <= smem_max(bps)]
        if not plans:
            continue
        least = min(p.tiles for p in plans)
        if least <= blocks:  # resident
            ipw = images_per_wave or -(-n // -(-n // (blocks // least)))
            ipw = min(ipw, n)
            per_image = blocks // ipw
            fits = [p for p in plans if p.tiles <= per_image]
            if not fits:
                continue
            p = min(fits, key=lambda p: (p.stage_bytes, p.tiles, p.nb,
                                         -p.bw))
            plan = dataclasses.replace(p, ipw=ipw)
        else:  # the L2 path: the fewest tiles, k a block
            ipw = min(images_per_wave or 1, n)
            p = min(plans, key=lambda p: (p.tiles, -p.stage_bytes, p.nb,
                                          -p.bw))
            k = -(-p.tiles // (blocks // ipw))
            plan = dataclasses.replace(p, k=k, ipw=ipw)
        if plan.grid > blocks:
            continue
        key = (plan.waves, Q_BLOCKS_PER_SM.index(bps))
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"quantize_plan: no plan for {n}x{c}x{pixels} at "
                         f"{blocks_per_sm} blocks an SM and "
                         f"{images_per_wave} images a wave")
    return best[1]


def quantize_nhwc_plain(x: torch.Tensor):
    """The quantization in plain PyTorch: :func:`to_nhwc` of
    :func:`quantize_activation`.  Returns (int8 NHWC codes with the
    channels padded to a multiple of 16, f32 (N,) scales)."""
    xq, sx = quantize_activation(x)
    return to_nhwc(xq), sx


def epilogue(acc, sx, scale, bias, out_dtype):
    """``(f32(acc) * (sx[n] * scale[c])).to(out_dtype)``, then plus
    ``bias.to(out_dtype)``: JAX's QConv (perspective.py:72-76)."""
    mul = (sx[:, None] * scale[None, :])[:, :, None, None]
    y = (acc.to(torch.float32) * mul).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[:, None, None]
    return y


def qconv_sums_plain(xq, wq, kernel, strides, pads):
    """The int32 sums (N, Cout, Ho, Wo) of the conv: ``F.conv2d`` in float64
    on the codes, then cast."""
    kh, kw = kernel
    n, h, w, cinp = xq.shape
    cout = wq.shape[0]
    w4 = wq[:, :kh * kw * cinp].reshape(cout, kh, kw, cinp) \
        .permute(0, 3, 1, 2).to(torch.float64)
    (t, b), (l, r) = pads
    x = F.pad(xq.permute(0, 3, 1, 2).to(torch.float64), (l, r, t, b))
    return F.conv2d(x, w4, stride=tuple(strides)).to(torch.int32)


def qconv_plain(xq, wq, sx, scale, bias, kernel, strides, pads,
                out_dtype=torch.bfloat16):
    """The int8 conv in plain PyTorch (see the module docstring)."""
    return epilogue(qconv_sums_plain(xq, wq, kernel, strides, pads), sx,
                    scale, bias, out_dtype)


_LIBS = {}


def set_qconv_argtypes(lib):
    """Declare ``panodepth_qconv``'s C signature on a loaded library (also
    ``scripts/qconv_probe.py``'s rebuilt forms of the source)."""
    lib.panodepth_qconv.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 18 + [ctypes.c_void_p]
    lib.panodepth_qconv.restype = ctypes.c_int


def set_quantize_argtypes(lib):
    """Declare ``panodepth_quantize_nhwc``'s C signature on a loaded library
    (also ``scripts/quantize_probe.py``'s rebuilt forms of the source)."""
    lib.panodepth_quantize_nhwc.argtypes = [
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.panodepth_quantize_nhwc.restype = ctypes.c_int


def _library(name: str = "qconv"):
    """The built library ``csrc/<name>.cu`` (``qconv`` or ``quantize``),
    its argument types set (built at first use)."""
    if name not in _LIBS:
        from . import _build

        lib = _build.load(name)
        if name == "qconv":
            set_qconv_argtypes(lib)
        else:
            set_quantize_argtypes(lib)
        err_string = getattr(lib, f"panodepth_{name}_error_string")
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _raise_on(name: str, err: int):
    if err != 0:
        lib = _library(name)
        msg = getattr(lib, f"panodepth_{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _check(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype):
    """Type and device errors raise TypeError, layout errors ValueError."""
    named = (("xq", xq, torch.int8), ("wq", wq, torch.int8),
             ("sx", sx, torch.float32), ("scale", scale, torch.float32),
             ("bias", bias, torch.float32))
    for name, t, dtype in named:
        if t is None and name == "bias":
            continue
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise TypeError(f"cuda_qconv: {name} must be a CUDA tensor (the "
                            f"plain version runs on the CPU)")
        if t.device != xq.device:
            raise TypeError("cuda_qconv: all tensors must be on one device")
        if t.dtype != dtype:
            raise TypeError(f"cuda_qconv: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cuda_qconv: {name} must be contiguous")
    if out_dtype not in _DTYPES:
        raise TypeError(f"cuda_qconv: the output must be bf16 or f32, got "
                        f"{out_dtype}")
    if xq.dim() != 4 or xq.shape[3] % CIN_ALIGN:
        raise ValueError(f"cuda_qconv: xq must be (N, H, W, Cinp) with Cinp "
                         f"a multiple of {CIN_ALIGN}, got {tuple(xq.shape)}")
    kh, kw = kernel
    n, h, w, cinp = xq.shape
    if (wq.dim() != 2 or wq.shape[1] % K_ALIGN
            or wq.shape[1] < kh * kw * cinp):
        raise ValueError(f"cuda_qconv: wq must be (Cout, Kp) with Kp a "
                         f"multiple of {K_ALIGN} and at least {kh}*{kw}*"
                         f"{cinp}, got {tuple(wq.shape)}")
    cout = wq.shape[0]
    if tuple(sx.shape) != (n,) or tuple(scale.shape) != (cout,) or (
            bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError(f"cuda_qconv: sx must be ({n},), scale and bias "
                         f"({cout},)")
    if min(strides) < 1 or min(min(p) for p in pads) < 0:
        raise ValueError(f"cuda_qconv: strides {strides} and pads {pads} "
                         f"must be positive")
    ho = out_size(h, kh, strides[0], pads[0])
    wo = out_size(w, kw, strides[1], pads[1])
    if ho < 1 or wo < 1 or n * ho * wo >= 2 ** 31:
        raise ValueError(f"cuda_qconv: an output of {n}x{ho}x{wo} pixels is "
                         f"empty or too large for the kernel")


def _launch(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype,
            sums: bool, plan: Optional[QConvPlan] = None):
    """One launch on checked arguments, with ``plan`` (``qconv_plan``'s by
    default): the output, or (output, int32 sums) with ``sums``."""
    global LAUNCHES
    kh, kw = kernel
    n, h, w, cinp = xq.shape
    cout = wq.shape[0]
    ho = out_size(h, kh, strides[0], pads[0])
    wo = out_size(w, kw, strides[1], pads[1])
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("cuda_qconv: the kernel copies 16 bytes at a time; "
                         "xq and wq must be 16-byte aligned")
    if plan is None:
        plan = qconv_plan(n, h, w, cinp, cout, kh, kw, *strides, pads)
    elif (plan.m, plan.cout, plan.ktaps) != (n * ho * wo, cout,
                                              kh * kw * cinp):
        raise ValueError(f"cuda_qconv: {plan} is not this conv's plan")
    lib = _library()
    y = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=xq.device)
    acc = (torch.empty((n, cout, ho, wo), dtype=torch.int32,
                       device=xq.device) if sums else None)
    ws = (torch.empty(plan.workspace_bytes, dtype=torch.uint8,
                      device=xq.device) if plan.splits > 1 else None)
    err = lib.panodepth_qconv(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        int(out_dtype == torch.bfloat16),
        None if acc is None else acc.data_ptr(),
        None if ws is None else ws.data_ptr(), n, h, w, cinp, cout, kh, kw,
        wq.shape[1], strides[0], strides[1], pads[0][0], pads[1][0], ho, wo,
        plan.bn, plan.stages, plan.splits, plan.smem_bytes,
        torch.cuda.current_stream(xq.device).cuda_stream)
    _raise_on("qconv", err)
    LAUNCHES += 1
    return (y, acc) if sums else y


def _canonical(kernel, strides, pads):
    return (tuple(map(int, kernel)), tuple(map(int, strides)),
            tuple(tuple(map(int, p)) for p in pads))


def cuda_qconv(xq, wq, sx, scale, bias, kernel, strides, pads,
               out_dtype=torch.bfloat16):
    """The CUDA kernel ``csrc/qconv.cu``, one launch a call (see the module
    docstring for the arguments).  Returns a new NCHW ``out_dtype`` tensor;
    runs on the current stream and does not synchronise."""
    kernel, strides, pads = _canonical(kernel, strides, pads)
    _check(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype)
    return _qconv_op(xq, wq, sx, scale, bias, *kernel, *strides, *pads[0],
                     *pads[1], out_dtype)


def cuda_qconv_sums(xq, wq, sx, scale, bias, kernel, strides, pads,
                    out_dtype=torch.bfloat16):
    """The kernel's output and its int32 sums (N, Cout, Ho, Wo) from one
    launch, outside the operator: for holding the kernel against
    :func:`qconv_sums_plain`."""
    return run_plan(xq, wq, sx, scale, bias, kernel, strides, pads,
                    out_dtype)


def run_plan(xq, wq, sx, scale, bias, kernel, strides, pads,
             out_dtype=torch.bfloat16, plan: Optional[QConvPlan] = None):
    """:func:`cuda_qconv_sums` with a given launch plan (another tile,
    depth or split than :func:`qconv_plan`'s): the card tests' and the
    A/B's way to reach every form of the kernel."""
    kernel, strides, pads = _canonical(kernel, strides, pads)
    _check(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype)
    if plan is not None and (plan.bn not in TILE_N or not MIN_STAGES
                             <= plan.stages <= MAX_STAGES
                             or not 1 <= plan.splits <= plan.ktiles
                             or plan.smem_bytes > SMEM_MAX):
        raise ValueError(f"cuda_qconv: the kernel does not take {plan}")
    return _launch(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype,
                   sums=True, plan=plan)


@torch.library.custom_op(f"{OPS}::qconv", mutates_args=(),
                         device_types="cuda")
def _qconv_op(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
              scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int,
              kw: int, sh: int, sw: int, pt: int, pb: int, pl: int, pr: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    """The operator's CUDA implementation: one launch (checked arguments).
    The inputs are made contiguous here, as the other operators' are: a
    traced program's strides may differ from the eager call's."""
    xq, wq, sx, scale = (t.contiguous() for t in (xq, wq, sx, scale))
    bias = None if bias is None else bias.contiguous()
    return _launch(xq, wq, sx, scale, bias, (kh, kw), (sh, sw),
                   ((pt, pb), (pl, pr)), out_dtype, sums=False)


@_qconv_op.register_fake
def _(xq, wq, sx, scale, bias, kh, kw, sh, sw, pt, pb, pl, pr, out_dtype):
    n, h, w, _ = xq.shape
    return torch.empty((n, wq.shape[0], out_size(h, kh, sh, (pt, pb)),
                        out_size(w, kw, sw, (pl, pr))), dtype=out_dtype,
                       device=xq.device)


# --- the activation's quantization (csrc/quantize.cu) ---


def _check_activation(x):
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise TypeError("cuda_quantize_nhwc: x must be a CUDA tensor (the "
                        "plain version runs on the CPU)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"cuda_quantize_nhwc: x must be bf16 or f32, got "
                        f"{x.dtype}")
    if x.dim() != 4 or x.numel() == 0 or x.shape[0] > 65535:
        raise ValueError(f"cuda_quantize_nhwc: x must be a nonempty (N, C, "
                         f"H, W) activation with N <= 65535, got "
                         f"{tuple(x.shape)}")


_SMS = {}


def _sms(device) -> int:
    """The SMs of ``device`` (the grid a plan may fill)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index) \
            .multi_processor_count
    return _SMS[index]


Q_WORDS = 4        # an image's words: amax bits, arrivals, departures, pad
_WORDS = {}        # device index: (the image words, the stream last using them)
_OLD_WORDS = []    # outgrown buffers, kept: a captured graph may point at one


def _image_words(device, n: int) -> torch.Tensor:
    """The image words a call of ``n`` images takes on ``device``: one
    buffer a device, zeroed once (outside any CUDA graph's capture) and
    left zero by every call (the kernel's last block of an image clears
    its words), grown for a call with more images.  An eager call on
    another stream than the last call's waits for that stream first, so
    two calls never hold the words at once; a captured call keeps the
    buffer, and its replays run on the stream of the calls around them."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index)
    capturing = torch.cuda.is_current_stream_capturing()
    words, last = _WORDS.get(index, (None, None))
    if words is None or words.numel() < Q_WORDS * n:
        if capturing:
            raise RuntimeError("cuda_quantize_nhwc: call it once outside "
                               "the CUDA graph's capture first (its "
                               "scratch is made and zeroed there)")
        if words is not None:
            torch.cuda.synchronize(index)
            _OLD_WORDS.append(words)
        words = torch.zeros(Q_WORDS * max(n, 1024), dtype=torch.int32,
                            device=index)
        torch.cuda.synchronize(index)
    elif last is not None and last != stream and not capturing:
        stream.wait_stream(last)
    _WORDS[index] = (words, stream)
    return words


def _quantize_launch(x, plan: Optional[QuantizePlan] = None, lib=None):
    """One launch on a checked, contiguous ``x`` with ``plan``
    (``quantize_plan``'s by default) of ``lib`` (the built
    ``csrc/quantize.cu`` by default): (codes, scales)."""
    global QUANTIZE_LAUNCHES
    n, c, h, w = x.shape
    aligned = x.data_ptr() % 16 == 0
    if plan is None:
        plan = quantize_plan(n, c, h * w, x.dtype, aligned, _sms(x.device))
    elif (plan.n, plan.c, plan.pixels, plan.esize) != (
            n, c, h * w, x.element_size()) or (plan.tma and not aligned):
        raise ValueError(f"cuda_quantize_nhwc: {plan} is not this input's "
                         f"plan")
    lib = lib or _library("quantize")
    q = torch.empty((n, h, w, plan.cinp), dtype=torch.int8, device=x.device)
    sx = torch.empty((n,), dtype=torch.float32, device=x.device)
    words = _image_words(x.device, n)
    err = lib.panodepth_quantize_nhwc(
        x.data_ptr(), int(x.dtype == torch.bfloat16), words.data_ptr(),
        sx.data_ptr(), q.data_ptr(), n, c, h * w, int(plan.tma), plan.tc,
        plan.bw, plan.nb, plan.k, plan.ipw, plan.code_px, plan.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on("quantize", err)
    QUANTIZE_LAUNCHES += QUANTIZE_KERNELS
    return q, sx


def cuda_quantize_nhwc(x: torch.Tensor):
    """The CUDA kernel ``csrc/quantize.cu`` (one launch a call) on the
    NCHW bf16 or f32 activation ``x``: (int8 NHWC codes with the channels
    padded to a multiple of 16, f32 (N,) scales), as
    :func:`quantize_nhwc_plain`.  Runs on the current stream and does not
    synchronise."""
    _check_activation(x)
    return _quantize_op(x)


def run_quantize_plan(x: torch.Tensor, plan: QuantizePlan):
    """:func:`cuda_quantize_nhwc` with a given launch plan (other tiles,
    blocks an SM or images a wave than :func:`quantize_plan`'s), outside
    the operator: the card tests' and the A/B's way to reach every form of
    the kernel."""
    _check_activation(x)
    x = x.contiguous()
    if (plan.blocks_per_sm not in Q_BLOCKS_PER_SM
            or plan.grid > _sms(x.device) * plan.blocks_per_sm
            or not plan.code_px
            or plan.smem_bytes > smem_max(plan.blocks_per_sm)
            or not 1 <= plan.ipw <= plan.n):
        raise ValueError(f"cuda_quantize_nhwc: the kernel does not take "
                         f"{plan}")
    return _quantize_launch(x, plan)


@torch.library.custom_op(f"{OPS}::quantize_nhwc", mutates_args=(),
                         device_types="cuda")
def _quantize_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: one launch (a checked
    argument, made contiguous here)."""
    return _quantize_launch(x.contiguous())


@_quantize_op.register_fake
def _(x):
    n, c, h, w = x.shape
    return (torch.empty((n, h, w, _round_up(c, CIN_ALIGN)), dtype=torch.int8,
                        device=x.device),
            torch.empty((n,), dtype=torch.float32, device=x.device))


def _auto(xq, *args, **kwargs):
    fn = cuda_qconv if xq.device.type == "cuda" else qconv_plain
    return fn(xq, *args, **kwargs)


def _auto_quantize(x):
    fn = cuda_quantize_nhwc if x.device.type == "cuda" else \
        quantize_nhwc_plain
    return fn(x)


ROUTES = ("auto", "torch", "kernel")
_OPS = {"qconv": {"auto": _auto, "torch": qconv_plain, "kernel": cuda_qconv},
        "quantize": {"auto": _auto_quantize, "torch": quantize_nhwc_plain,
                     "kernel": cuda_quantize_nhwc}}


def resolve(route: str, op: str = "qconv"):
    """The function of ``op`` (``qconv``, the int8 conv, or ``quantize``,
    the activation's quantization) for a route (``auto``, ``torch``,
    ``kernel``)."""
    try:
        return _OPS[op][route]
    except KeyError:
        if op not in _OPS:
            raise ValueError(f"op must be one of {tuple(_OPS)}, got "
                             f"{op!r}") from None
        raise ValueError(f"qconv route must be one of {ROUTES}, "
                         f"got {route!r}") from None


def quantize_nhwc(x: torch.Tensor, route: str = "auto"):
    """The activation's codes and scales by ``route``'s function: the
    kernel for a CUDA tensor under ``auto``, the plain twin for a CPU
    one."""
    return resolve(route, "quantize")(x)
