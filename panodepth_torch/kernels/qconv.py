"""int8 convolution: the hand-written CUDA kernel and its plain twin.

The int8 perspective graph (``models/layers.QConv``, the counterpart of
``panodepth/models/perspective.py::QConv``) convolves int8 activation codes
with int8 weight codes into exact int32 sums and scales them back to the
compute type.  The JAX package leaves that conv to XLA
(``lax.conv_general_dilated(..., preferred_element_type=jnp.int32)``,
perspective.py:68-72); on the card no PyTorch conv computes it (``F.conv2d``
takes no int8), so the port has a kernel of its own.  It is not the port
of a TPU kernel: no Pallas kernel of the JAX package computes this.

``cuda_qconv`` launches ``csrc/qconv.cu``: an implicit GEMM on the int8
tensor cores with the scaling epilogue fused (the source note says what
bounds it).  ``qconv_plain`` is the same function in plain PyTorch: the
conv in float64 on the integer codes (exact: every partial sum is an
integer far below 2^53), cast to int32, then the epilogue in PyTorch ops.
Both take

* ``xq``: int8 (N, H, W, Cinp), the activation's codes NHWC with the
  channels zero-padded to a multiple of 16 (:func:`to_nhwc`);
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
the kernel (which raises on a CPU tensor), ``torch`` always the twin.
Nothing falls back.  The CPU tests hold the twin against the JAX package,
and the card holds the kernel against the twin on the same codes.

``cuda_qconv`` reaches the kernel through the PyTorch operator
``panodepth_torch::qconv`` (``torch.library.custom_op``, CUDA only, with a
fake implementation for tracers), so a program that ``torch.export``
traces holds the kernel as one node (``serve.py``).  The int8 graph is for
inference: neither version has a backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

# the operators' namespace: the package's name (see kernels/jacobi.py)
OPS = __name__.split(".")[0]

# kernel launches made by the wrappers in this process (one per call)
LAUNCHES = 0

CIN_ALIGN = 16  # the input's channels padded to this (a 16-byte copy)
K_ALIGN = 64    # the weights' K padded to this (the kernel's K tile)
_DTYPES = (torch.bfloat16, torch.float32)


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
    card).  Returns (int8 NCHW codes, f32 (N,) scales)."""
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


_LIB = None


def _library():
    """The built library, its argument types set (built at first use)."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("qconv")
        lib.panodepth_qconv.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 14 + [
            ctypes.c_void_p]
        lib.panodepth_qconv.restype = ctypes.c_int
        lib.panodepth_qconv_error_string.argtypes = [ctypes.c_int]
        lib.panodepth_qconv_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
            sums: bool):
    """One launch on checked arguments: the output, or (output, int32
    sums) with ``sums``."""
    global LAUNCHES
    kh, kw = kernel
    n, h, w, cinp = xq.shape
    cout = wq.shape[0]
    ho = out_size(h, kh, strides[0], pads[0])
    wo = out_size(w, kw, strides[1], pads[1])
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("cuda_qconv: the kernel copies 16 bytes at a time; "
                         "xq and wq must be 16-byte aligned")
    lib = _library()
    y = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=xq.device)
    acc = (torch.empty((n, cout, ho, wo), dtype=torch.int32,
                       device=xq.device) if sums else None)
    err = lib.panodepth_qconv(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        int(out_dtype == torch.bfloat16),
        None if acc is None else acc.data_ptr(), n, h, w, cinp, cout, kh, kw,
        wq.shape[1], strides[0], strides[1], pads[0][0], pads[1][0], ho, wo,
        torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        msg = lib.panodepth_qconv_error_string(err).decode()
        raise RuntimeError(f"qconv kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return (y, acc) if sums else y


def cuda_qconv(xq, wq, sx, scale, bias, kernel, strides, pads,
               out_dtype=torch.bfloat16):
    """The CUDA kernel ``csrc/qconv.cu``, one launch a call (see the module
    docstring for the arguments).  Returns a new NCHW ``out_dtype`` tensor;
    runs on the current stream and does not synchronise."""
    kernel, strides = tuple(map(int, kernel)), tuple(map(int, strides))
    pads = tuple(tuple(map(int, p)) for p in pads)
    _check(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype)
    return _qconv_op(xq, wq, sx, scale, bias, *kernel, *strides, *pads[0],
                     *pads[1], out_dtype)


def cuda_qconv_sums(xq, wq, sx, scale, bias, kernel, strides, pads,
                    out_dtype=torch.bfloat16):
    """The kernel's output and its int32 sums (N, Cout, Ho, Wo) from one
    launch, outside the operator: for holding the kernel against
    :func:`qconv_sums_plain`."""
    kernel, strides = tuple(map(int, kernel)), tuple(map(int, strides))
    pads = tuple(tuple(map(int, p)) for p in pads)
    _check(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype)
    return _launch(xq, wq, sx, scale, bias, kernel, strides, pads, out_dtype,
                   sums=True)


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


def _auto(xq, *args, **kwargs):
    fn = cuda_qconv if xq.device.type == "cuda" else qconv_plain
    return fn(xq, *args, **kwargs)


ROUTES = ("auto", "torch", "kernel")


def resolve(route: str):
    """The int8 conv for a route (``auto``, ``torch``, ``kernel``)."""
    try:
        return {"auto": _auto, "torch": qconv_plain,
                "kernel": cuda_qconv}[route]
    except KeyError:
        raise ValueError(f"qconv route must be one of {ROUTES}, "
                         f"got {route!r}") from None
