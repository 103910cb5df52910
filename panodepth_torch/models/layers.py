"""Flax's layers as the JAX nets use them: ``nn.Conv`` (in NCHW),
``nn.Dense``, ``nn.LayerNorm``, ``nn.MultiHeadDotProductAttention``,
``nn.GRUCell`` and ``nn.gelu``; and the int8 graph's ``QConv``.

The port's nets keep flax's parameter names (``kernel``, ``bias``) and
submodule names (``Conv_0``, ``Dense_1``, ...), so a checkpoint maps onto
them by path (``models/weights.py``); only the kernels' layouts differ:
conv kernels are OIHW here (flax: HWIO) and dense kernels (out, in)
(flax: (in, out)).

Numerics follow flax: a layer with ``dtype`` casts its input, kernel and
bias to it, convolves (the output rounded to ``dtype``) and then adds the
bias as a separate ``dtype`` operation.  ``padding="SAME"`` is lax's: for
stride s and kernel k the total pad ``max((ceil(n/s) - 1) * s + k - n, 0)``
goes ``total // 2`` before and the rest after, so a 3x3 stride-2 conv pads
(0, 1) and a 7x7 stride-2 one (2, 3); ``padding=k // 2`` would shift the
phase.

Every parameter is trainable, and a fresh layer is drawn as flax draws it
(:func:`init_params` redraws a whole net from one ``torch.Generator``):
conv, dense and attention kernels ``lecun_normal`` (a normal truncated at
two standard deviations, rescaled to variance 1/fan_in, the fan-in
counting every contracted axis and the receptive field), the GRU's
recurrent kernels ``orthogonal``, biases 0 (or a constant where the JAX
net sets one), norm scales 1.  A loaded checkpoint
(``e2e.load_model_checkpoint``) is an inference net: its parameters
require no gradient.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses import fake_tensor

from .. import graphs
from ..kernels import qconv as kqconv

Pads = Union[str, Sequence[Tuple[int, int]]]

# the standard deviation of a unit normal truncated to (-2, 2), by which
# jax's variance_scaling divides to keep the requested variance
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(t, scale: float, fan_in: int, generator=None):
    """``jax.nn.initializers.variance_scaling(scale, "fan_in",
    "truncated_normal")`` into ``t`` in place: a unit normal truncated to
    (-2, 2) times ``sqrt(scale / fan_in) / 0.8796``, so that the values keep
    variance ``scale / fan_in`` and none lies beyond two of the untruncated
    standard deviations.  ``lecun_normal`` is scale 1, ``he_normal`` 2."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(math.sqrt(scale / fan_in) / _TRUNC_STD)


def init_params(model: nn.Module, generator=None) -> nn.Module:
    """Redraw every parameter of ``model`` as flax initialises it, in
    module order from ``generator`` (the layers' ``init_flax_``).  Returns
    ``model``.  The draws are not flax's bits (another generator), only its
    distributions."""
    for m in model.modules():
        init = getattr(m, "init_flax_", None)
        if init is not None:
            init(generator)
    return model


# lax's SAME padding (before, after) of one spatial axis
same_pads = kqconv.same_pads


def train_layout(x, kernel):
    """``x`` made contiguous where a conv will take the kernel's gradient.
    PyTorch's CPU convolution (2.13, oneDNN) writes out of bounds in the
    kernel's gradient of a strided 1x1 conv whose input is a
    channels-last view (the nets' first conv takes the RGB as a permuted
    NHWC tensor): the gradient comes out wrong, or the heap is corrupted.
    Inference keeps its layout (and bits)."""
    if torch.is_grad_enabled() and kernel.requires_grad:
        return x.contiguous()
    return x


class Derived(nn.Module):
    """A module whose forward uses a tensor derived from its parameters
    (a cast, a standardisation), computed once and kept until a parameter
    is replaced, moved or written in place.

    Under grad mode, where a parameter requires grad, the value is made
    anew on every call and not kept: the gradient flows back through it to
    the parameters, and an optimizer step is seen at the next call.  The
    cache (and the captured graphs' hold on it) is for inference only.

    Under a tracer (``torch.export``) the value is made from the real
    parameters outside the trace, so an exported program holds it as a
    constant and casts nothing per call, as a captured graph does.  A
    tracer that has made the parameters themselves fake (the module is a
    submodule of the traced module) is refused: export a function that
    closes over the nets, as ``serve`` does."""

    def derived(self, make, *params):
        tracing = graphs.tracing()
        if tracing and any(fake_tensor.is_fake(p) for p in params):
            raise RuntimeError(
                f"{type(self).__name__}: traced with fake parameters; keep "
                f"the module out of the traced module's submodules")
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return make()
        if tracing:
            with graphs.untraced():
                return self._derived(make, params)
        return self._derived(make, params)

    def _derived(self, make, params):
        key = tuple((p.data_ptr(), p.dtype, p._version) for p in params)
        if getattr(self, "_derived_key", None) != key:
            self._derived_value = make()
            self._derived_key = key
        # a graph captured with this value reads it until it is evicted
        return graphs.hold(self._derived_value)


class Conv(Derived):
    """``flax.linen.Conv``: ``padding`` is ``"SAME"`` or explicit
    ((top, bottom), (left, right)) pads."""

    def __init__(self, cin: int, features: int, kernel=(3, 3), strides=(1, 1),
                 padding: Pads = "SAME", use_bias: bool = True,
                 dtype=torch.bfloat16, bias_init: float = 0.0):
        super().__init__()
        kh, kw = kernel
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.bias_init = bias_init
        self.kernel = nn.Parameter(torch.empty(features, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.init_flax_()

    def init_flax_(self, generator=None):
        """flax's ``lecun_normal`` kernel (fan-in cin * kh * kw) and a
        constant bias (``bias_init``, 0 by default)."""
        variance_scaling_(self.kernel, 1.0, self.kernel[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.fill_(self.bias_init)

    def weight(self):
        """The kernel as the conv uses it (cast to ``dtype``)."""
        return self.derived(lambda: self.kernel.to(self.dtype), self.kernel)

    def forward(self, x):
        x = train_layout(x.to(self.dtype), self.kernel)
        kh, kw = self.kernel.shape[2:]
        if self.padding == "SAME":
            (t, b), (l, r) = (same_pads(x.shape[2], kh, self.strides[0]),
                              same_pads(x.shape[3], kw, self.strides[1]))
        else:
            (t, b), (l, r) = self.padding
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        y = F.conv2d(x, self.weight(), stride=self.strides)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class QConv(Derived):
    """``panodepth.models.perspective.QConv``: the int8 post-training
    quantized conv of the int8 perspective graph, inference only.

    ``kernel_q`` holds int8 weight codes (OIHW) and ``scale`` their f32
    per-output-channel scales (made by ``models/quantize.py``); both, and
    the f32 ``bias``, are fixed: no parameter requires grad.  Per call the
    activation is quantized per image and written NHWC
    (``kernels.qconv.quantize_nhwc``), then the int8 conv with int32 sums
    and the scaling epilogue runs, with lax's SAME pads; both in
    ``route``'s functions (``kernels/qconv.resolve``: ``auto`` the CUDA
    kernels on the card, the plain twins on the CPU).
    The kernel's layout of the weights is a derived tensor, made once and
    held like the other convs' casts."""

    def __init__(self, cin: int, features: int, kernel=(3, 3), strides=(1, 1),
                 use_bias: bool = True, dtype=torch.bfloat16,
                 route: str = "auto"):
        super().__init__()
        kh, kw = kernel
        self.strides = tuple(strides)
        self.dtype = dtype
        self.route = route
        fixed = lambda t: nn.Parameter(t, requires_grad=False)
        self.kernel_q = fixed(torch.zeros(features, cin, kh, kw,
                                          dtype=torch.int8))
        self.scale = fixed(torch.ones(features))
        self.bias = fixed(torch.zeros(features)) if use_bias else None

    def init_flax_(self, generator=None):
        """flax's init of the quantized tree: zero codes, unit scales, zero
        bias (real values come from a float net, ``models/quantize.py``)."""
        with torch.no_grad():
            self.kernel_q.zero_()
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def weight(self):
        """The codes as the kernel reads them (``kernels.qconv.
        prepare_weight``)."""
        return self.derived(lambda: kqconv.prepare_weight(self.kernel_q),
                            self.kernel_q)

    def forward(self, x):
        kh, kw = self.kernel_q.shape[2:]
        pads = (same_pads(x.shape[2], kh, self.strides[0]),
                same_pads(x.shape[3], kw, self.strides[1]))
        xq, sx = kqconv.quantize_nhwc(x, self.route)
        return kqconv.resolve(self.route)(
            xq, self.weight(), sx, self.scale, self.bias, (kh, kw),
            self.strides, pads, self.dtype)


def set_qconv_route(module: nn.Module, route: str) -> nn.Module:
    """Set ``route`` on every QConv inside ``module``; returns it."""
    kqconv.resolve(route)  # refuse an unknown route here
    for m in module.modules():
        if isinstance(m, QConv):
            m.route = route
    return module


class Dense(nn.Module):
    """``flax.linen.Dense`` over the last axis; ``kernel`` is (out, in).
    ``orthogonal`` draws the kernel as ``initializers.orthogonal()`` (the
    GRU's recurrent kernels) instead of ``lecun_normal``."""

    def __init__(self, cin: int, features: int, dtype=torch.bfloat16,
                 use_bias: bool = True, orthogonal: bool = False):
        super().__init__()
        self.dtype = dtype
        self.orthogonal = orthogonal
        self.kernel = nn.Parameter(torch.empty(features, cin))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.init_flax_()

    def init_flax_(self, generator=None):
        if self.orthogonal:
            with torch.no_grad():
                nn.init.orthogonal_(self.kernel, generator=generator)
        else:
            variance_scaling_(self.kernel, 1.0, self.kernel.shape[1],
                              generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.kernel.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def mean_f32(x, dims):
    """``jnp.mean`` of a bf16 or f32 tensor: an f32 sum divided in f32, one
    rounding to ``x``'s type."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    return (x.to(torch.float32).sum(dims) / n).to(x.dtype)


def gelu(x):
    """``flax.linen.gelu``: the tanh approximation (``approximate=True``),
    each step in ``x``'s type with its constants rounded to it."""
    c = torch.full((), math.sqrt(2.0 / math.pi), dtype=x.dtype,
                   device=x.device)
    k = torch.full((), 0.044715, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis: ``epsilon`` 1e-6, f32
    statistics with the fast variance ``max(E[x²] - E[x]², 0)``, the
    affine in f32, one cast to ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype=torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_flax_(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.to(torch.float32)
        n = x.shape[-1]
        mean = xf.sum(-1, keepdim=True) / n
        mean2 = (xf * xf).sum(-1, keepdim=True) / n
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias
        return y.to(self.dtype)


class DenseGeneral(Derived):
    """The projections of ``flax.linen.MultiHeadDotProductAttention``:
    ``kernel`` holds the output axes first, then the contracted ones
    (``query``: (heads, head_dim, in); ``out``: (out, heads, head_dim)),
    ``bias`` has the output axes' shape."""

    def __init__(self, cin, features, dtype=torch.bfloat16):
        super().__init__()
        cin, features = tuple(cin), tuple(features)
        self.dtype = dtype
        self.fan_in = math.prod(cin)
        self.kernel = nn.Parameter(torch.empty(features + cin))
        self.bias = nn.Parameter(torch.empty(features))
        self.init_flax_()

    def init_flax_(self, generator=None):
        """``lecun_normal`` over the flattened (in, out) kernel: the fan-in
        is the product of the contracted axes."""
        variance_scaling_(self.kernel, 1.0, self.fan_in, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        """``x`` (..., prod(in)) -> (..., prod(features)) in ``dtype``."""
        w = self.derived(lambda: self.kernel.to(self.dtype).reshape(
            self.bias.numel(), -1), self.kernel)
        y = F.linear(x.to(self.dtype), w)
        return y + self.bias.to(self.dtype).reshape(-1)


class MultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` (self-attention, no mask,
    no dropout) in flax's op order, every step in ``dtype``: the query
    divided by sqrt(head_dim) before the product, the softmax in ``dtype``
    (its sum in f32, rounded once, as ``jnp.sum`` takes it), and the output
    projected back to the input width."""

    def __init__(self, cin: int, num_heads: int, qkv_features: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.heads, self.head_dim = num_heads, qkv_features // num_heads
        self.dtype = dtype
        hd = (num_heads, self.head_dim)
        self.query = DenseGeneral((cin,), hd, dtype)
        self.key = DenseGeneral((cin,), hd, dtype)
        self.value = DenseGeneral((cin,), hd, dtype)
        self.out = DenseGeneral(hd, (cin,), dtype)

    def forward(self, x):  # (B, L, C)
        b, n, _ = x.shape
        split = lambda t: t.view(b, n, self.heads, self.head_dim)
        q = split(self.query(x))
        k, v = split(self.key(x)), split(self.value(x))
        q = q / torch.full((), math.sqrt(self.head_dim), dtype=self.dtype,
                           device=x.device)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        u = torch.exp(w - w.amax(-1, keepdim=True))
        w = u / u.to(torch.float32).sum(-1, keepdim=True).to(self.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(y.reshape(b, n, -1))


class GRUCell(nn.Module):
    """``flax.linen.GRUCell``: ``ir``/``iz``/``in`` with biases, ``hr``/
    ``hz`` without, ``hn`` with one (the ``h*`` kernels drawn orthogonal);
    ``n = tanh(in(x) + r * hn(h))``,
    ``h' = (1 - z) * n + z * h``.  The carry is f32 (flax's
    ``param_dtype``), so ``h'`` is f32 while the gates are ``dtype``."""

    def __init__(self, cin: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(cin, features, dtype))
        for name in ("hr", "hz"):
            self.add_module(name, Dense(features, features, dtype,
                                        use_bias=False, orthogonal=True))
        self.hn = Dense(features, features, dtype, orthogonal=True)

    def scan(self, x, reverse: bool = False):
        """``nn.RNN(cell)`` over (B, L, C) from a zero carry; ``reverse``
        runs the sequence backwards and returns it in the original order
        (``keep_order=True``).  The input projections of all steps are
        taken at once (each row is its own product)."""
        xr, xz, xn = (getattr(self, n)(x) for n in ("ir", "iz", "in"))
        h = torch.zeros(x.shape[0], self.hn.kernel.shape[0],
                        dtype=torch.float32, device=x.device)
        out = [None] * x.shape[1]
        for t in (reversed(range(x.shape[1])) if reverse
                  else range(x.shape[1])):
            r = torch.sigmoid(xr[:, t] + self.hr(h))
            z = torch.sigmoid(xz[:, t] + self.hz(h))
            n = torch.tanh(xn[:, t] + r * self.hn(h))
            h = (1.0 - z) * n + z * h
            out[t] = h
        return torch.stack(out, 1)
