"""Jacobi relaxation: the hand-written CUDA kernel and its plain twin.

``cuda_jacobi`` launches ``csrc/jacobi.cu``, the Hopper replacement for the
TPU kernel ``panodepth/kernels/jacobi.py::pallas_jacobi`` (the source note
there says what bounds it).  ``jacobi_plain`` is the same function in plain
PyTorch, the counterpart of ``panodepth.fusion.jacobi``; the CPU tests hold
it against the JAX package, and the card holds the kernel against it.

Both have the signature of ``fusion.jacobi``.  :func:`resolve` maps the
``--jacobi`` choice to one of them: ``auto`` takes the kernel for a CUDA
tensor and the twin for a CPU tensor, ``kernel`` always the kernel (which
raises on a CPU tensor), ``torch`` always the twin.  Nothing falls back.

``cuda_jacobi`` reaches the kernel through the PyTorch operator
``panodepth_torch::jacobi`` (``torch.library.custom_op``, CUDA only, with
a fake implementation for tracers), so a program that ``torch.export``
traces holds the kernel as one node (``serve.py``).  The operator has no
CPU implementation: on a CPU tensor it raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

# the operators' namespace: the package's name, so that an earlier
# checkout's wrappers imported beside these (scripts/torch_kernel_ab.py)
# register operators of their own
OPS = __name__.split(".")[0]

# kernel launches made by cuda_jacobi in this process
LAUNCHES = 0


def lap4_refwrap(img: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian ``c - 0.25*(((l + r) + u) + d)`` of an (H, W) map,
    or of each map of a (B, H, W) stack, with the reference's flat-index
    taps.

    The reference reads taps as ``buffer[yy * width + xx]`` (Depth.cpp:
    1696-1701), so the left tap of column 0 is the previous row's last
    pixel and the right tap of column W-1 the next row's first (PARITY.md
    quirk #19); rows roll vertically.  All four taps are flat rolls of each
    map on its own, never across the maps of a stack.
    """
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h * w)
    left = torch.roll(flat, 1, 1).view(img.shape)
    right = torch.roll(flat, -1, 1).view(img.shape)
    up = torch.roll(flat, w, 1).view(img.shape)
    down = torch.roll(flat, -w, 1).view(img.shape)
    return img - 0.25 * (left + right + up + down)


def jacobi_plain(buf, target, covered, iterations, step, reg):
    """Jacobi relaxation toward the target Laplacian (Depth.cpp:1680-1717),
    in the op order of the TPU kernel's ``_step`` (jacobi.py:44-50).
    ``buf``/``target`` are (H, W) or a (B, H, W) stack; ``covered`` is
    (H, W), shared by the stack."""
    one_minus_reg = 1.0 - reg
    for _ in range(iterations):
        upd = buf + (target - lap4_refwrap(buf)) * step
        upd = upd * one_minus_reg + buf * reg
        upd = torch.clamp(upd, 0.0, 1.0)
        buf = torch.where(covered, upd, buf)
    return buf


def _library():
    from . import _build

    lib = _build.load("jacobi")
    fn = lib.panodepth_jacobi
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_double, ctypes.c_double] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.panodepth_cuda_error_string.argtypes = [ctypes.c_int]
        lib.panodepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


# (cols, rows) micro-tiles csrc/jacobi.cu has a kernel for, and the most
# warps a block may have (its launch bounds: 1024 threads)
TILES = ((2, 4), (4, 4))
MAX_WARPS = 32
SMEM_DEFAULT = 48 * 1024  # shared memory a block gets without opting in
MAX_BATCH = 65535  # panoramas a launch takes: the grid's z limit


@dataclasses.dataclass(frozen=True)
class JacobiPlan:
    """How ``csrc/jacobi.cu`` covers one (h, w) level.

    A block relaxes a window of ``32 * cols`` columns by ``warps * rows``
    rows ``halo`` iterations per launch (the last launch the rest) and
    writes the window less ``halo`` cells on every side: the tile.  Lane l
    of warp g holds rows ``g*rows ..`` and columns ``l*cols ..`` of it.
    """

    h: int
    w: int
    iterations: int
    cols: int
    rows: int
    warps: int
    halo: int

    @property
    def window(self):
        return self.warps * self.rows, 32 * self.cols

    @property
    def tile(self):
        wh, ww = self.window
        return wh - 2 * self.halo, ww - 2 * self.halo

    @property
    def grid(self):
        th, tw = self.tile
        return -(-self.w // tw), -(-self.h // th)

    @property
    def blocks(self) -> int:
        gx, gy = self.grid
        return gx * gy

    @property
    def launches(self) -> int:
        return -(-self.iterations // self.halo)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory per block, what the kernel is launched
        with: the edge buffer, 2 buffers x (top, bottom) rows of every
        warp."""
        return 4 * 4 * self.warps * 32 * self.cols

    @property
    def opt_in(self) -> bool:
        """Above the default 48 KB the launch raises the kernel's dynamic
        shared-memory limit."""
        return self.smem_bytes > SMEM_DEFAULT


def plan_for(h: int, w: int, iterations: int) -> JacobiPlan:
    """The launch plan of one level (pure; the CPU tests check it).

    From the per-level sweep of ``scripts/torch_kernel_ab.py --sweep`` on
    an H100 (PERF.md): the 512x256 level is latency-bound (131,072 pixels
    over 132 SMs), best as 64x64 windows of 2x4 micro-tiles, 16 warps and
    16 iterations per launch: 128 blocks of 16 warps.  At 1024x512, 64x128
    windows of 2x4 micro-tiles, 32 warps, 12 iterations per launch: 130
    blocks of 32 warps.  The large levels are throughput-bound: 128x128
    windows of 4x4 micro-tiles, 32 warps, 16 iterations per launch (the
    halo recomputed ~1.8x the interior, 4 launches at 50 iterations; the
    edge buffer takes 64 KB, so these blocks opt in).  ``halo`` never
    exceeds ``iterations``.
    """
    if h * w <= 512 * 256:
        cols, rows, warps, halo = 2, 4, 16, 16
    elif h * w <= 1024 * 512:
        cols, rows, warps, halo = 2, 4, 32, 12
    else:
        cols, rows, warps, halo = 4, 4, 32, 16
    return JacobiPlan(int(h), int(w), int(iterations), cols, rows, warps,
                      max(1, min(halo, int(iterations))))


def launches_for(h: int, w: int, iterations: int) -> int:
    """Kernel launches that :func:`cuda_jacobi` makes for ``iterations`` at
    an (h, w) level."""
    return plan_for(h, w, iterations).launches


def _check(buf, target, covered):
    """Type and device errors raise TypeError, layout errors ValueError."""
    for name, t, dtype in (("buf", buf, torch.float32),
                           ("target", target, torch.float32),
                           ("covered", covered, torch.bool)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise TypeError(f"cuda_jacobi: {name} must be a CUDA tensor "
                            f"(the plain version runs on the CPU)")
        if t.dtype != dtype:
            raise TypeError(f"cuda_jacobi: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cuda_jacobi: {name} must be contiguous")
        if t.device != buf.device:
            raise TypeError("cuda_jacobi: all tensors must be on one device")
    if buf.dim() not in (2, 3) or target.shape != buf.shape:
        raise ValueError(f"cuda_jacobi: buf and target must be (H, W) or "
                         f"(B, H, W) of one shape, got {tuple(buf.shape)} "
                         f"and {tuple(target.shape)}")
    if covered.shape != buf.shape[-2:]:
        raise ValueError(f"cuda_jacobi: covered must be 2-D of shape "
                         f"{tuple(buf.shape[-2:])}, got {tuple(covered.shape)}")
    if buf.dim() == 3 and not 1 <= buf.shape[0] <= MAX_BATCH:
        raise ValueError(f"cuda_jacobi: a batch of {buf.shape[0]} is outside "
                         f"1..{MAX_BATCH} (the grid's z limit)")


def cuda_jacobi(buf, target, covered, iterations, step, reg):
    """The CUDA kernel ``csrc/jacobi.cu``, several iterations per launch
    (:func:`plan_for`).

    ``buf``/``target`` are contiguous f32 CUDA tensors, (H, W) or a (B, H,
    W) batch of panoramas, ``covered`` an (H, W) bool mask shared by the
    batch.  One launch sequence serves the whole batch, and each panorama
    gets the bits it gets alone.  Returns a new tensor; ``buf`` is not
    written.  Runs on the current stream and does not synchronise.
    """
    _check(buf, target, covered)
    iterations = int(iterations)
    if iterations < 0:
        raise ValueError(f"cuda_jacobi: iterations must be >= 0, "
                         f"got {iterations}")
    if iterations == 0:
        return buf.clone()
    return _jacobi_op(buf, target, covered, iterations, float(step),
                      float(reg))


@torch.library.custom_op(f"{OPS}::jacobi", mutates_args=(),
                         device_types="cuda")
def _jacobi_op(buf: torch.Tensor, target: torch.Tensor, covered: torch.Tensor,
               iterations: int, step: float, reg: float) -> torch.Tensor:
    """The operator's CUDA implementation: the launches of the level's plan
    (checked arguments, ``iterations`` > 0).  The inputs are made
    contiguous here, as ``group_norm``'s are: a traced program's strides
    may differ from the eager call's."""
    buf, target, covered = (t.contiguous() for t in (buf, target, covered))
    h, w = buf.shape[-2:]
    return run_plan(buf, target, covered, step, reg, plan_for(h, w, iterations))


@_jacobi_op.register_fake
def _(buf, target, covered, iterations, step, reg):
    return torch.empty_like(buf)


def run_plan(buf, target, covered, step, reg, plan: JacobiPlan):
    """Launch the kernel with ``plan`` (checked arguments; also what
    ``scripts/torch_kernel_ab.py`` times other plans with)."""
    global LAUNCHES
    h, w = plan.h, plan.w
    batch = buf.shape[0] if buf.dim() == 3 else 1
    # the kernel's window indices within a panorama are 32-bit (the
    # panorama's offset is 64-bit)
    if (h + plan.window[0] + 1) * w >= 2 ** 31:
        raise ValueError(f"cuda_jacobi: {h}x{w} exceeds 32-bit indexing")
    lib = _library()
    with torch.cuda.device(buf.device):
        out = torch.empty_like(buf)
        scratch = torch.empty_like(buf) if plan.launches > 1 else out
        cov = covered.view(torch.uint8)
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.panodepth_jacobi(
            buf.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            target.data_ptr(), cov.data_ptr(), batch, h, w, plan.iterations,
            float(step), float(reg), plan.cols, plan.rows, plan.warps,
            plan.halo, plan.smem_bytes, int(plan.opt_in), stream)
    if err != 0:
        msg = lib.panodepth_cuda_error_string(err).decode()
        raise RuntimeError(f"jacobi kernel launch failed: {msg} ({err})")
    LAUNCHES += plan.launches
    return out


def _auto(buf, target, covered, iterations, step, reg):
    fn = cuda_jacobi if buf.device.type == "cuda" else jacobi_plain
    return fn(buf, target, covered, iterations, step, reg)


JACOBI_KINDS = ("auto", "torch", "kernel")


def resolve(kind: str):
    """The relaxation function for a ``--jacobi`` choice."""
    try:
        return {"auto": _auto, "torch": jacobi_plain,
                "kernel": cuda_jacobi}[kind]
    except KeyError:
        raise ValueError(f"jacobi must be one of {JACOBI_KINDS}, "
                         f"got {kind!r}") from None
