"""GroupNorm inference: the hand-written CUDA kernel and its plain twin.

``cuda_group_norm`` launches ``csrc/groupnorm.cu``, the Hopper replacement
for the TPU kernel ``panodepth/kernels/groupnorm.py::group_norm`` (the
source note there says what bounds it).  ``group_norm_plain`` is the same
function in plain PyTorch, flax's ``GroupNorm`` (``_compute_stats`` and
``_normalize``) as ``panodepth.models.norm.GroupNorm`` runs it: f32 sums of
x and x² per (image, group), ``var = max(E[x²] - E[x]², 0)``, then
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``, an optional ReLU
and one cast.  The CPU tests hold the twin against the JAX package, and
the card holds the kernel against the twin.

Both take an NCHW activation ``x`` (bf16 or f32) and f32 per-channel
``scale``/``bias``.  :func:`resolve` maps a route to one of them: ``auto``
takes the kernel for a CUDA tensor and the twin for a CPU tensor,
``kernel`` always the kernel (which raises on a CPU tensor), ``torch``
always the twin.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches made by cuda_group_norm in this process (two per call)
LAUNCHES = 0

_DTYPES = (torch.bfloat16, torch.float32)


def group_norm_plain(x, scale, bias, num_groups: int, eps: float = 1e-6,
                     relu: bool = False, out_dtype=torch.float32):
    """GroupNorm of the (N, C, ...) tensor ``x`` over every dim but N, in
    flax's op order (see the module docstring)."""
    n, c = x.shape[:2]
    cg = c // num_groups
    xg = x.reshape(n, num_groups, -1).to(torch.float32)
    count = xg.shape[-1]
    mean = xg.sum(-1) / count
    mean2 = (xg * xg).sum(-1) / count
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps).repeat_interleave(cg, 1) * scale
    shape = (n, c) + (1,) * (x.dim() - 2)
    y = (x.to(torch.float32) - mean.repeat_interleave(cg, 1).view(shape)) \
        * mul.view(shape) + bias.view((1, c) + (1,) * (x.dim() - 2))
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(out_dtype)


_LIB = None


def _library():
    """The built library, its argument types set (built at first use)."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("groupnorm")
        lib.panodepth_group_norm.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        lib.panodepth_group_norm.restype = ctypes.c_int
        for name in ("panodepth_group_norm_chunk",
                     "panodepth_group_norm_launches_per_call"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.panodepth_group_norm_error_string.argtypes = [ctypes.c_int]
        lib.panodepth_group_norm_error_string.restype = ctypes.c_char_p
        lib.chunk = lib.panodepth_group_norm_chunk()
        lib.launches_per_call = lib.panodepth_group_norm_launches_per_call()
        _LIB = lib
    return _LIB


def launches_per_call() -> int:
    """Kernel launches per :func:`cuda_group_norm` call; builds the library."""
    return _library().launches_per_call


def _check(x, scale, bias, num_groups, out_dtype):
    """Type and device errors raise TypeError, layout errors ValueError."""
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise TypeError(f"cuda_group_norm: {name} must be a CUDA tensor "
                            f"(the plain version runs on the CPU)")
        if t.device != x.device:
            raise TypeError("cuda_group_norm: all tensors must be on one "
                            "device")
        if not t.is_contiguous():
            raise ValueError(f"cuda_group_norm: {name} must be contiguous")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"cuda_group_norm: x and the output must be bf16 or "
                        f"f32, got {x.dtype} -> {out_dtype}")
    if x.dim() < 3:
        raise ValueError(f"cuda_group_norm: x must be (N, C, ...), got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"cuda_group_norm: {name} must be f32 of shape "
                             f"({c},), got {t.dtype} {tuple(t.shape)}")
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"cuda_group_norm: {num_groups} groups do not "
                         f"divide {c} channels")
    if x.numel() >= 2 ** 31:
        raise ValueError("cuda_group_norm: the kernel's channel index is "
                         "32-bit; x is too large")


def cuda_group_norm(x, scale, bias, num_groups: int, eps: float = 1e-6,
                    relu: bool = False, out_dtype=torch.float32):
    """The CUDA kernel ``csrc/groupnorm.cu``: two launches per call.

    ``x`` is a contiguous (N, C, ...) bf16 or f32 CUDA tensor, ``scale``
    and ``bias`` f32 (C,).  Returns a new ``out_dtype`` tensor.  Runs on
    the current stream and does not synchronise.
    """
    global LAUNCHES
    num_groups = int(num_groups)
    _check(x, scale, bias, num_groups, out_dtype)
    n, c = x.shape[:2]
    hw = x.numel() // max(n * c, 1)
    lib = _library()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    chunks = -(-(c // num_groups) * hw // lib.chunk)
    partials = torch.empty(n * num_groups * chunks * 2, dtype=torch.float32,
                           device=x.device)
    err = lib.panodepth_group_norm(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
        int(out_dtype == torch.bfloat16), partials.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), n, c, hw, num_groups, float(eps),
        int(bool(relu)), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.panodepth_group_norm_error_string(err).decode()
        raise RuntimeError(f"groupnorm kernel launch failed: {msg} ({err})")
    LAUNCHES += lib.launches_per_call
    return y


def _auto(x, *args, **kwargs):
    fn = cuda_group_norm if x.device.type == "cuda" else group_norm_plain
    return fn(x, *args, **kwargs)


ROUTES = ("auto", "torch", "kernel")


def resolve(route: str):
    """The GroupNorm function for a route (``auto``, ``torch``, ``kernel``)."""
    try:
        return {"auto": _auto, "torch": group_norm_plain,
                "kernel": cuda_group_norm}[route]
    except KeyError:
        raise ValueError(f"groupnorm route must be one of {ROUTES}, "
                         f"got {route!r}") from None
