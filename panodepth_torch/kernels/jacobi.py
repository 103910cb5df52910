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
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches made by cuda_jacobi in this process
LAUNCHES = 0


def lap4_refwrap(img: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian ``c - 0.25*(((l + r) + u) + d)`` of an (H, W) map
    with the reference's flat-index taps.

    The reference reads taps as ``buffer[yy * width + xx]`` (Depth.cpp:
    1696-1701), so the left tap of column 0 is the previous row's last
    pixel and the right tap of column W-1 the next row's first (PARITY.md
    quirk #19); rows roll vertically.  All four taps are flat rolls.
    """
    h, w = img.shape
    flat = img.reshape(-1)
    left = torch.roll(flat, 1).view(h, w)
    right = torch.roll(flat, -1).view(h, w)
    up = torch.roll(flat, w).view(h, w)
    down = torch.roll(flat, -w).view(h, w)
    return img - 0.25 * (left + right + up + down)


def jacobi_plain(buf, target, covered, iterations, step, reg):
    """Jacobi relaxation toward the target Laplacian (Depth.cpp:1680-1717),
    in the op order of the TPU kernel's ``_step`` (jacobi.py:44-50)."""
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.panodepth_jacobi_steps_per_launch.argtypes = []
        lib.panodepth_jacobi_steps_per_launch.restype = ctypes.c_int
        lib.panodepth_cuda_error_string.argtypes = [ctypes.c_int]
        lib.panodepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launches_for(iterations: int) -> int:
    """Kernel launches that :func:`cuda_jacobi` makes for ``iterations``
    (the kernel does several iterations per launch); builds the library."""
    per_launch = _library().panodepth_jacobi_steps_per_launch()
    return -(-int(iterations) // per_launch)


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
        if t.dim() != 2 or t.shape != buf.shape:
            raise ValueError(f"cuda_jacobi: {name} must be 2-D of shape "
                             f"{tuple(buf.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"cuda_jacobi: {name} must be contiguous")
        if t.device != buf.device:
            raise TypeError("cuda_jacobi: all tensors must be on one device")


def cuda_jacobi(buf, target, covered, iterations, step, reg):
    """The CUDA kernel ``csrc/jacobi.cu``, several iterations per launch.

    ``buf``/``target`` are contiguous f32 (H, W) CUDA tensors, ``covered`` a
    bool mask of the same shape.  Returns a new tensor; ``buf`` is not
    written.  Runs on the current stream and does not synchronise.
    """
    global LAUNCHES
    _check(buf, target, covered)
    iterations = int(iterations)
    if iterations < 0:
        raise ValueError(f"cuda_jacobi: iterations must be >= 0, "
                         f"got {iterations}")
    h, w = buf.shape
    if (h + 64) * w >= 2 ** 31:  # the kernel's window indices are 32-bit
        raise ValueError(f"cuda_jacobi: {h}x{w} exceeds 32-bit indexing")
    if iterations == 0:
        return buf.clone()
    lib = _library()
    launches = launches_for(iterations)
    with torch.cuda.device(buf.device):
        out = torch.empty_like(buf)
        scratch = torch.empty_like(buf) if launches > 1 else out
        cov = covered.view(torch.uint8)
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.panodepth_jacobi(
            buf.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            target.data_ptr(), cov.data_ptr(), h, w, iterations,
            float(step), float(reg), stream)
    if err != 0:
        msg = lib.panodepth_cuda_error_string(err).decode()
        raise RuntimeError(f"jacobi kernel launch failed: {msg} ({err})")
    LAUNCHES += launches
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
