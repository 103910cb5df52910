"""The zoo's nets in plain float32 PyTorch: FastPanoNet, the GroupNorm
perspective net and the normalizer-free one.

Written from the published layer equations of the zoo's families (a
ResNet encoder and RefineNet decoder; FastPanoNet's circular padding,
latitude channels and squeeze-excitation gate; NF-ResNet's scaled weight
standardisation, Brock et al. 2021).  The weights are read from the zoo's
``*.params.npz`` by flax path, with no code of the program.  Every conv
runs in float32 with TF32 off, unless a conv of the configuration's
lower-precision kind is asked to run quantized:

``quant`` maps a conv's kind to a bit width.  A quantized conv takes
symmetric per-output-channel weight codes (absmax / (2^(b-1) - 1), made
in numpy float32) and per-image activation codes (absmax of the image,
at least 1e-8), sums the code products exactly (float64), and scales the
sums back in float32 before the bias.  At 8 bits this is the int8
perspective graph's arithmetic; it also serves the control, the
reference computed one precision step below what the configuration
states.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

_KEY = re.compile(r"\['([^']+)'\]")
RELU_GAIN = math.sqrt(2.0 / (1.0 - 1.0 / math.pi))


def read_npz(path: str, device) -> dict:
    """{``A.B.kernel``: f32 tensor} of a zoo checkpoint: bf16 bit patterns
    widened, conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out,
    in)."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            a = z[key]
            if a.dtype == np.uint16:
                a = (a.astype(np.uint32) << 16).view(np.float32)
            a = np.asarray(a, np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            name = ".".join(_KEY.findall(key)[1:])
            out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def same_pads(n: int, k: int, s: int):
    """lax's SAME padding (before, after) of one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Net:
    """A net's parameters and the precision of each conv kind."""

    def __init__(self, params: dict, quant: dict = None):
        self.p = params
        self.quant = quant or {}
        self._wq = {}
        # when a list, every conv, dense and norm appends its shapes here
        # (the operation counts of ``portbench/counts``)
        self.record = None

    def conv(self, x, name, stride=1, pads="SAME", bias=True, kind="conv",
             weight=None):
        """``name``'s conv on NCHW ``x``: explicit ``pads`` ((t, b), (l, r))
        or SAME; ``weight`` overrides the stored kernel (a standardised
        one); ``kind`` selects the conv's precision in ``quant``."""
        w = self.p[name + ".kernel"] if weight is None else weight
        kh, kw = w.shape[2:]
        if pads == "SAME":
            pads = (same_pads(x.shape[2], kh, stride),
                    same_pads(x.shape[3], kw, stride))
        (t, b), (l, r) = pads
        x = F.pad(x, (l, r, t, b))
        if self.record is not None:
            n, cin, hp, wp = x.shape
            self.record.append(dict(
                op="conv", name=name, kind=kind, n=n, cin=cin,
                h=hp - t - b, w=wp - l - r, cout=w.shape[0], kh=kh, kw=kw,
                bias=bias,
                ho=(hp - kh) // stride + 1, wo=(wp - kw) // stride + 1))
        bits = self.quant.get(kind)
        if bits is None:
            y = F.conv2d(x, w, stride=stride)
        elif bits == "fp8":
            y = F.conv2d(to_fp8(x, (1, 2, 3)), to_fp8(w, (1, 2, 3)),
                         stride=stride)
        else:
            y = self._qconv(x, w, name, stride, bits)
        if bias:
            y = y + self.p[name + ".bias"][:, None, None]
        return y

    def _qconv(self, x, w, name, stride, bits):
        top = float(2 ** (bits - 1) - 1)
        if name not in self._wq:
            k = w.detach().cpu().numpy().astype(np.float32)
            s = np.maximum(np.abs(k).max(axis=(1, 2, 3)), 1e-12) / top
            s = s.astype(np.float32)
            q = np.clip(np.round(k / s[:, None, None, None]), -top, top)
            self._wq[name] = (torch.from_numpy(q).to(x.device, torch.float64),
                              torch.from_numpy(s).to(x.device))
        wq, ws = self._wq[name]
        amax = x.abs().amax(dim=(1, 2, 3))
        sx = torch.clamp_min(amax, 1e-8) / top
        xq = torch.clamp(torch.round(x / sx[:, None, None, None]), -top, top)
        acc = F.conv2d(xq.to(torch.float64), wq, stride=stride)
        return acc.to(torch.float32) * (sx[:, None] * ws[None, :])[
            :, :, None, None]

    def group_norm(self, x, name, relu=False):
        c = x.shape[1]
        if self.record is not None:
            self.record.append(dict(op="group_norm", name=name,
                                    elements=x.numel()))
        y = F.group_norm(x, math.gcd(c, 32), self.p[name + ".scale"],
                         self.p[name + ".bias"], eps=1e-6)
        return torch.relu(y) if relu else y

    def dense(self, x, name):
        if self.record is not None:
            k = self.p[name + ".kernel"]
            self.record.append(dict(op="dense", name=name, n=x.shape[0],
                                    cin=k.shape[1], cout=k.shape[0]))
        return F.linear(x, self.p[name + ".kernel"], self.p[name + ".bias"])


def to_fp8(t, dims):
    """``t`` rounded to float8 e4m3 after scaling the absmax over ``dims``
    to the format's largest value (448), then scaled back, in float32."""
    s = torch.clamp_min(t.abs().amax(dim=dims, keepdim=True), 1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def up2(x):
    """Nearest 2x upsample."""
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)


def resize(x, size):
    """``jax.image.resize(..., "bilinear")``: a triangle filter that
    antialiases a downsample, width first, then height."""
    h, w = size
    if x.shape[-1] != w:
        x = F.interpolate(x, size=(x.shape[-2], w), mode="bilinear",
                          align_corners=False, antialias=True)
    if x.shape[-2] != h:
        x = F.interpolate(x, size=(h, x.shape[-1]), mode="bilinear",
                          align_corners=False, antialias=True)
    return x


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# -- FastPanoNet -----------------------------------------------------------

class FastPano(Net):
    """(B, W/2, W, 3) RGB in [0, 1] -> (B, W/2, W) depth in 0~1."""

    STAGES = (2, 2, 2, 2)

    def circ(self, x, name, stride=1, bias=True, kind="conv"):
        k = self.p[name + ".conv.kernel"].shape[2]
        pw = (k - 1) // 2
        if pw:
            x = torch.cat([x[..., -pw:], x, x[..., :pw]], dim=3)
        return self.conv(x, name + ".conv", stride, ((pw, pw), (0, 0)),
                         bias, kind)

    def res_block(self, x, name, stride):
        y = self.group_norm(self.circ(x, name + ".CircConv_0", stride,
                                      False), name + ".GroupNorm_0", True)
        y = self.group_norm(self.circ(y, name + ".CircConv_1", 1, False),
                            name + ".GroupNorm_1")
        if name + ".Conv_0.kernel" in self.p:
            x = self.group_norm(self.conv(x, name + ".Conv_0", stride,
                                          bias=False), name + ".GroupNorm_2")
        return torch.relu(y + x)

    def __call__(self, rgb):
        b, h, w, _ = rgb.shape
        x = rgb.permute(0, 3, 1, 2)
        zen = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
        lat = torch.from_numpy(np.stack([np.cos(zen), np.sin(zen)])).to(
            x.device)[None, :, :, None].expand(b, 2, h, w)
        x = torch.cat([x, lat], 1)
        x = self.group_norm(self.circ(x, "CircConv_0", 2, False),
                            "GroupNorm_0", True)
        skips, k = [], 0
        for blocks in self.STAGES:
            for i in range(blocks):
                x = self.res_block(x, f"CircResBlock_{k}", 2 if i == 0 else 1)
                k += 1
            skips.append(x)
        s = x.mean((2, 3))
        s = self.dense(torch.relu(self.dense(s, "GlobalContext_0.Dense_0")),
                       "GlobalContext_0.Dense_1")
        x = x * torch.sigmoid(s)[:, :, None, None]
        y = self.circ(x, "CircConv_1", bias=False)
        for k, skip in enumerate(list(reversed(skips[:-1])) + [None]):
            n = f"CircFusionBlock_{k}"
            y = self.circ(up2(y), n + ".CircConv_0")
            if skip is not None:
                y = y + self.circ(skip, n + ".CircConv_1", bias=False)
            y = self.res_block(y, n + ".CircResBlock_0", 1)
        y = torch.relu(self.circ(y, "CircConv_2"))
        hh, ww = y.shape[-2:]
        yp = torch.cat([y[..., -1:], y, y[..., :1]], -1)
        y = resize(yp, (hh * 2, (ww + 2) * 2))[..., 2:-2]
        y = torch.relu(self.circ(y, "CircConv_3"))
        return torch.sigmoid(self.conv(y, "Conv_0", kind="head")[:, 0])


# -- the perspective nets --------------------------------------------------

class PerspectiveGN(Net):
    """The GroupNorm perspective net: (B, H, W, 3) -> (B, H, W) > 0."""

    def res_block(self, x, name, stride):
        y = self.group_norm(self.conv(x, name + ".Conv_0", stride,
                                      bias=False), name + ".GroupNorm_0",
                            True)
        y = self.group_norm(self.conv(y, name + ".Conv_1", bias=False),
                            name + ".GroupNorm_1")
        if name + ".Conv_2.kernel" in self.p:
            x = self.group_norm(self.conv(x, name + ".Conv_2", stride,
                                          bias=False), name + ".GroupNorm_2")
        return torch.relu(y + x)

    def __call__(self, rgb):
        x = rgb.permute(0, 3, 1, 2)
        x = self.group_norm(self.conv(x, "Conv_0", 2, bias=False),
                            "GroupNorm_0", True)
        skips, k = [], 0
        for blocks in (2, 2, 2, 2):
            for i in range(blocks):
                x = self.res_block(x, f"ResBlock_{k}", 2 if i == 0 else 1)
                k += 1
            skips.append(x)
        y = self.conv(skips[-1], "Conv_1", bias=False)
        for k, skip in enumerate(list(reversed(skips[:-1])) + [None]):
            n = f"FusionBlock_{k}"
            y = self.conv(up2(y), n + ".Conv_0")
            if skip is not None:
                y = y + self.conv(skip, n + ".Conv_1", bias=False)
            y = self.res_block(y, n + ".ResBlock_0", 1)
        y = torch.relu(self.conv(y, "Conv_2"))
        y = resize(y, (y.shape[2] * 2, y.shape[3] * 2))
        y = torch.relu(self.conv(y, "Conv_3"))
        return softplus(self.conv(y, "Conv_4", kind="head")[:, 0])


class PerspectiveNF(Net):
    """The normalizer-free perspective net: (B, H, W, 3) -> (B, H, W) > 0."""

    ALPHA = 0.2

    def __init__(self, params, quant=None):
        super().__init__(params, quant)
        self._std = {}

    def ws(self, x, name, stride=1, gain=RELU_GAIN):
        if name not in self._std:
            w = self.p[name + ".kernel"]
            mu = w.mean((1, 2, 3), keepdim=True)
            var = ((w - mu) ** 2).mean((1, 2, 3), keepdim=True)
            fan_in = w[0].numel()
            w = (w - mu) * torch.rsqrt(var * fan_in + 1e-8)
            self._std[name] = w * (gain * self.p[name + ".gain"])[
                :, None, None, None]
        return self.conv(x, name, stride, weight=self._std[name])

    def block(self, x, name, stride, beta):
        out = torch.relu(x * (1.0 / beta))
        y = torch.relu(self.ws(out, name + ".WSConv_0", stride))
        y = self.ws(y, name + ".WSConv_1")
        if name + ".WSConv_2.kernel" in self.p:
            x = self.ws(out, name + ".WSConv_2", stride)
        return x + self.ALPHA * y

    def __call__(self, rgb):
        x = rgb.permute(0, 3, 1, 2)
        x = self.ws(x, "WSConv_0", 2, gain=1.0)
        skips, k, var = [], 0, 1.0
        for blocks in (2, 2, 2, 2):
            for i in range(blocks):
                x = self.block(x, f"NFResBlock_{k}", 2 if i == 0 else 1,
                               math.sqrt(var))
                var = (1.0 if i == 0 else var) + self.ALPHA ** 2
                k += 1
            skips.append(x)
        y = self.ws(skips[-1], "WSConv_1", gain=1.0)
        for k, skip in enumerate(list(reversed(skips[:-1])) + [None]):
            n = f"NFFusionBlock_{k}"
            y = self.ws(up2(y), n + ".WSConv_0", gain=1.0)
            if skip is not None:
                y = (y + self.ws(skip, n + ".WSConv_1", gain=1.0)) \
                    * (1.0 / math.sqrt(2.0))
            y = self.block(y, n + ".NFResBlock_0", 1, 1.0)
        y = torch.relu(self.ws(torch.relu(y), "WSConv_2"))
        y = resize(y, (y.shape[2] * 2, y.shape[3] * 2))
        y = torch.relu(self.ws(y, "WSConv_3"))
        return softplus(self.conv(y, "Conv_0", kind="head")[:, 0])


NETS = {"fastpano": FastPano, "perspective_gn": PerspectiveGN,
        "perspective_nf": PerspectiveNF}


def depth01(net, rgb):
    """The net's output divided by its per-image 99th percentile (linear
    interpolation between ranks) and clipped to [0, 1]."""
    pred = net(rgb)
    hi = torch.quantile(pred.reshape(pred.shape[0], -1), 0.99, dim=1)
    return torch.clamp(pred / torch.clamp_min(hi, 1e-6)[:, None, None],
                       0.0, 1.0)
