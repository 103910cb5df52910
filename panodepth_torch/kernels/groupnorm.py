"""GroupNorm inference: the hand-written CUDA kernel and its plain twin.

``cuda_group_norm`` launches ``csrc/groupnorm.cu``, the Hopper replacement
for the TPU kernel ``panodepth/kernels/groupnorm.py::group_norm`` (the
source note there says what bounds it).  ``group_norm_plain`` is the same
function in plain PyTorch, flax's ``GroupNorm`` (``_compute_stats`` and
``_normalize``) as ``panodepth.models.norm.GroupNorm`` runs it: the means
of x and x² per (image, group), ``var = max(E[x²] - E[x]², 0)``, then
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``, an optional ReLU
and one cast.  Both take the means as f64 sums divided in f64 and rounded
once to f32 (flax sums in f32): the sums of bf16 inputs are then exact
in any order, so the kernel and the twin agree on the statistics bit for
bit even where ``E[x²] - E[x]²`` cancels (a group whose mean dwarfs its
spread), and an image normalises to the same bits under any plan and at
any batch.  The CPU tests hold the twin against the JAX package, and the
card holds the kernel against the twin.

Both take an NCHW activation ``x`` (bf16 or f32) and f32 per-channel
``scale``/``bias``.  :func:`resolve` maps a route to one of them: ``auto``
takes the kernel for a CUDA tensor and the twin for a CPU tensor,
``kernel`` always the kernel (which raises on a CPU tensor), ``torch``
always the twin.  Nothing falls back.

Training: neither the kernel nor the TPU kernel has a backward.
:func:`group_norm_train` is the differentiable form the JAX package trains
with, flax's stock computation (f32 sums, so not bit-equal to the twin's
f64 ones); ``auto`` takes it under grad mode where an input requires grad,
and ``kernel`` raises there.

``cuda_group_norm`` reaches the kernel through the PyTorch operator
``panodepth_torch::group_norm`` (``torch.library.custom_op``, CUDA only,
with a fake implementation for tracers), so a program that
``torch.export`` traces holds the kernel as one node (``serve.py``).  The
operator has no CPU implementation: on a CPU tensor it raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

# the operators' namespace: the package's name, so that an earlier
# checkout's wrappers imported beside these (scripts/torch_kernel_ab.py)
# register operators of their own
OPS = __name__.split(".")[0]

# kernel launches made by cuda_group_norm in this process (one per call)
LAUNCHES = 0

_DTYPES = (torch.bfloat16, torch.float32)


def group_norm_plain(x, scale, bias, num_groups: int, eps: float = 1e-6,
                     relu: bool = False, out_dtype=torch.float32):
    """GroupNorm of the (N, C, ...) tensor ``x`` over every dim but N, in
    flax's op order (see the module docstring)."""
    n, c = x.shape[:2]
    cg = c // num_groups
    xg = x.reshape(n, num_groups, -1).to(torch.float64)
    count = xg.shape[-1]
    mean = (xg.sum(-1) / count).to(torch.float32)
    mean2 = ((xg * xg).sum(-1) / count).to(torch.float32)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps).repeat_interleave(cg, 1) * scale
    shape = (n, c) + (1,) * (x.dim() - 2)
    y = (x.to(torch.float32) - mean.repeat_interleave(cg, 1).view(shape)) \
        * mul.view(shape) + bias.view((1, c) + (1,) * (x.dim() - 2))
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(out_dtype)


def group_norm_train(x, scale, bias, num_groups: int, eps: float = 1e-6,
                     relu: bool = False, out_dtype=torch.float32):
    """GroupNorm as flax trains it (``_compute_stats`` with
    ``force_float32_reductions``, then ``_normalize``): ``x`` in f32, the
    means of x and x² per (image, group) as f32 sums, ``var = max(E[x²] -
    E[x]², 0)``, ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``,
    an optional ReLU, one cast.  Differentiable; it keeps no f64 copy of
    the activation."""
    n, c = x.shape[:2]
    cg = c // num_groups
    xf = x.to(torch.float32)
    xg = xf.reshape(n, num_groups, -1)
    mean = xg.mean(-1)
    mean2 = (xg * xg).mean(-1)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps).repeat_interleave(cg, 1) * scale
    shape = (n, c) + (1,) * (x.dim() - 2)
    y = (xf - mean.repeat_interleave(cg, 1).view(shape)) * mul.view(shape) \
        + bias.view((1, c) + (1,) * (x.dim() - 2))
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def needs_grad(*tensors) -> bool:
    """True under grad mode where one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


_LIB = None


def _library():
    """The built library, its argument types set (built at first use)."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("groupnorm")
        lib.panodepth_group_norm.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
            ctypes.c_double] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.panodepth_group_norm.restype = ctypes.c_int
        lib.panodepth_group_norm_launches_per_call.argtypes = []
        lib.panodepth_group_norm_launches_per_call.restype = ctypes.c_int
        lib.panodepth_group_norm_error_string.argtypes = [ctypes.c_int]
        lib.panodepth_group_norm_error_string.restype = ctypes.c_char_p
        lib.launches_per_call = lib.panodepth_group_norm_launches_per_call()
        _LIB = lib
    return _LIB


def launches_per_call() -> int:
    """Kernel launches per :func:`cuda_group_norm` call; builds the library."""
    return _library().launches_per_call


SMS = 132                 # the H100 SXM's streaming multiprocessors
MAX_CLUSTER = 16          # 8 is portable; 16 with the non-portable opt-in
MIN_SLICE = 3072          # elements a block gets before a span is split
VEC = 8                   # elements per vector access (16 bytes of bf16)
SMEM_MAX = 232448         # a block's shared memory on sm_90
SMEM_STATIC = 1024        # kept for the kernel's own __shared__ variables
SMEM_DEFAULT = 48 * 1024 - SMEM_STATIC  # dynamic bytes without the opt-in


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How ``csrc/groupnorm.cu`` covers one call: ``n * groups`` clusters
    of ``cluster`` blocks, block k of a cluster owning elements
    ``[k*slice, (k+1)*slice)`` of its (image, group) span, kept in shared
    memory if ``staged``."""

    n: int
    channels: int
    hw: int
    groups: int
    in_bytes: int
    cluster: int
    slice: int
    staged: bool

    @property
    def span(self) -> int:
        return self.channels // self.groups * self.hw

    @property
    def blocks(self) -> int:
        return self.n * self.groups * self.cluster

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory per block, what the kernel is launched
        with: the slice and one vector of alignment slack."""
        return self.in_bytes * (self.slice + VEC) if self.staged else 0

    @property
    def opt_in(self) -> bool:
        """Above the default 48 KB (less the kernel's own variables) the
        launch raises the kernel's dynamic shared-memory limit."""
        return self.smem_bytes > SMEM_DEFAULT

    def slices(self, image: int, group: int):
        """(start, end) element offsets in ``x`` of each block's slice of
        one span, in rank order (empty slices included)."""
        base = (image * self.groups + group) * self.span
        return [(base + min(k * self.slice, self.span),
                 base + min((k + 1) * self.slice, self.span))
                for k in range(self.cluster)]


def slice_for(span: int, cluster: int) -> int:
    """Elements per block: a multiple of VEC, so that slices start aligned."""
    per_block = -(-span // cluster)
    return max(VEC, -(-per_block // VEC) * VEC)


def plan_for(n: int, channels: int, hw: int, groups: int,
             in_bytes: int) -> GroupNormPlan:
    """The launch plan of one call (pure; the CPU tests check it).

    The cluster size K is the least power of two that puts ``groups * K``
    blocks, one image's, on the 132 SMs, at most 16 and while a slice keeps
    at least MIN_SLICE elements; then doubled further (to 16) while the
    slice does not fit in shared memory.  A slice that does not fit at
    K = 16 is not staged (read twice).  K does not depend on ``n``: the
    slices, and so the sum order of every (image, group), are the same at
    any batch (and f64 sums of bf16 inputs do not depend on the order at
    all), so an image normalises to the same bits at batch 1 (the CLI) and
    batch 2 (the e2e call).  MIN_SLICE is measured (``scripts/
    torch_kernel_ab.py --sweep``, PERF.md): a cluster's barriers add ~0.9
    us to a call (floor 3.56 us against 2.64 us for a lone block), more
    than splitting a span of a few thousand elements saves.
    """
    span = channels // groups * hw
    fits = lambda k: in_bytes * (slice_for(span, k) + VEC) <= \
        SMEM_MAX - SMEM_STATIC
    k = 1
    while (k < MAX_CLUSTER and groups * k < SMS
           and span // (2 * k) >= MIN_SLICE):
        k *= 2
    while k < MAX_CLUSTER and not fits(k):
        k *= 2
    return GroupNormPlan(int(n), int(channels), int(hw), int(groups),
                         int(in_bytes), k, slice_for(span, k), fits(k))


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
        raise ValueError("cuda_group_norm: the kernel's element index is "
                         "32-bit; x is too large")


def cuda_group_norm(x, scale, bias, num_groups: int, eps: float = 1e-6,
                    relu: bool = False, out_dtype=torch.float32):
    """The CUDA kernel ``csrc/groupnorm.cu``: one launch per call
    (:func:`plan_for`).

    ``x`` is a contiguous (N, C, ...) bf16 or f32 CUDA tensor, ``scale``
    and ``bias`` f32 (C,).  Returns a new ``out_dtype`` tensor.  Runs on
    the current stream and does not synchronise.  The kernel has no
    backward: under grad mode a tensor that requires grad is refused.
    """
    if needs_grad(x, scale, bias):
        raise RuntimeError("cuda_group_norm has no backward: call it under "
                           "torch.no_grad() or inference_mode(), or take the "
                           "'auto' route to train (group_norm_train)")
    num_groups = int(num_groups)
    _check(x, scale, bias, num_groups, out_dtype)
    return _group_norm_op(x, scale, bias, num_groups, float(eps), bool(relu),
                          out_dtype)


@torch.library.custom_op(f"{OPS}::group_norm", mutates_args=(),
                         device_types="cuda")
def _group_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float, relu: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the call's plan
    (checked arguments).  The inputs are made contiguous here: a traced
    program may pass a tensor whose strides its tracer got wrong (a cuDNN
    output in channels-last order that the trace took for contiguous, so
    that the ``contiguous()`` before the call was dropped)."""
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    n, c = x.shape[:2]
    hw = x.numel() // max(n * c, 1)
    plan = plan_for(n, c, hw, num_groups, x.element_size())
    return run_plan(x, scale, bias, eps, relu, out_dtype, plan)


@_group_norm_op.register_fake
def _(x, scale, bias, num_groups, eps, relu, out_dtype):
    return torch.empty(x.shape, dtype=out_dtype, device=x.device)


def run_plan(x, scale, bias, eps, relu, out_dtype, plan: GroupNormPlan):
    """Launch the kernel with ``plan`` (checked arguments; also what
    ``scripts/torch_kernel_ab.py`` times other cluster sizes with)."""
    global LAUNCHES
    lib = _library()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    err = lib.panodepth_group_norm(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
        int(out_dtype == torch.bfloat16), scale.data_ptr(), bias.data_ptr(),
        plan.n, plan.channels, plan.hw, plan.groups, float(eps),
        int(bool(relu)), plan.cluster, plan.slice, int(plan.staged),
        plan.smem_bytes, int(plan.opt_in),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.panodepth_group_norm_error_string(err).decode()
        raise RuntimeError(f"groupnorm kernel launch failed: {msg} ({err})")
    LAUNCHES += lib.launches_per_call
    return y


def _auto(x, scale, bias, *args, **kwargs):
    if needs_grad(x, scale, bias):
        fn = group_norm_train
    elif x.device.type == "cuda":
        fn = cuda_group_norm
    else:
        fn = group_norm_plain
    return fn(x, scale, bias, *args, **kwargs)


ROUTES = ("auto", "torch", "kernel")


def resolve(route: str):
    """The GroupNorm function for a route (``auto``, ``torch``, ``kernel``).
    ``auto``: :func:`group_norm_train` under grad mode where an input
    requires grad, else the kernel on a CUDA tensor and the twin on a CPU
    tensor."""
    try:
        return {"auto": _auto, "torch": group_norm_plain,
                "kernel": cuda_group_norm}[route]
    except KeyError:
        raise ValueError(f"groupnorm route must be one of {ROUTES}, "
                         f"got {route!r}") from None
