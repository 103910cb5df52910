"""Operations and bytes of the configuration's work per panorama, and the
least time the card's peaks allow for each kernel's share of it."""

from __future__ import annotations

from ..reference import layout as L
from . import peaks
from .shapes import records

# the perspective GN net's convs whose input the program holds in
# bfloat16 (a cast or convs' outputs, no norm between): the stem, the
# first fusion block's first conv (after the bottleneck conv), each fusion
# block's residual block's first conv (the sum of the block's two convs)
# and the conv after the 2x resize; every other input is float32, a
# norm's output or a residual sum with one
BF16_INPUTS = {"Conv_0", "FusionBlock_0.Conv_0", "Conv_3"}


def bf16_input(name: str) -> bool:
    return name in BF16_INPUTS or (name.startswith("FusionBlock_")
                                   and name.endswith(".ResBlock_0.Conv_0"))


def conv_flops(r: dict) -> int:
    return 2 * r["n"] * r["ho"] * r["wo"] * r["cout"] * r["cin"] * r["kh"] \
        * r["kw"]


def net_flops(config: dict, root: str) -> dict:
    """{precision: FLOPs a panorama}: convs and dense layers at the
    precision the configuration states for their net, the f32 output heads
    at float32."""
    out = {}
    for net, recs in records(config, root).items():
        prec = config["precision"][net]
        for r in recs:
            if r["op"] == "conv":
                f, p = conv_flops(r), "float32" if r["kind"] == "head" \
                    else prec
            elif r["op"] == "dense":
                f, p = 2 * r["n"] * r["cin"] * r["cout"], prec
            else:
                continue
            out[p] = out.get(p, 0) + f
    return out


def least_step_s(config: dict, root: str) -> float:
    """The nets' counted work a panorama at the published peaks."""
    return sum(f / peaks.FLOPS[p] for p, f in net_flops(config,
                                                        root).items())


def jacobi(config: dict) -> dict:
    """The relaxation a panorama: 14 float32 operations a covered
    pixel-iteration, 13 bytes a pixel of each level (buffer, target and
    output float32, the mask one byte)."""
    pipe = config["pipeline"]
    _, ranges = L.layout_tables(pipe["layout_spec"])
    ops = nbytes = 0
    for lvl in L.pyramid(ranges, pipe["out_width"]):
        ops += 14 * int((lvl.inv_cov > 0).sum()) * lvl.iterations
        nbytes += 13 * lvl.width * lvl.height
    return _bound(ops, nbytes, "float32")


def groupnorm(config: dict, root: str) -> dict:
    """Every GroupNorm of a panorama: a bfloat16 conv output read, a
    float32 output written; 8 operations an element (3 for the sums, 5 to
    normalise)."""
    elements = sum(r["elements"] for recs in records(config, root).values()
                   for r in recs if r["op"] == "group_norm")
    return _bound(8 * elements, 6 * elements, "float32")


def _qconvs(config: dict, root: str):
    if config["precision"]["perspective"] != "int8":
        return []
    return [r for r in records(config, root)["perspective"]
            if r["op"] == "conv" and r["kind"] == "conv"]


def qconv(config: dict, root: str) -> dict:
    """The int8 convs of a panorama: operations at the int8 peak; bytes of
    the codes at their own channel count, the weight codes, the scales,
    the bias and the bfloat16 output."""
    ops = nbytes = 0
    for r in _qconvs(config, root):
        ops += conv_flops(r)
        nbytes += (r["n"] * r["h"] * r["w"] * r["cin"]
                   + r["cout"] * r["kh"] * r["kw"] * r["cin"]
                   + 4 * (r["n"] + r["cout"] * (2 if r["bias"] else 1))
                   + 2 * r["n"] * r["cout"] * r["ho"] * r["wo"])
    return _bound(ops, nbytes, "int8")


def quantize(config: dict, root: str) -> dict:
    """The activations' quantization ahead of each int8 conv: the input
    read once, one code written an element, one float32 scale an image."""
    nbytes = 0
    for r in _qconvs(config, root):
        elements = r["n"] * r["cin"] * r["h"] * r["w"]
        esize = 2 if bf16_input(r["name"]) else 4
        nbytes += elements * (esize + 1) + 4 * r["n"]
    return _bound(0, nbytes, "int8")


def _bound(ops: int, nbytes: int, precision: str) -> dict:
    ops_s = ops / peaks.FLOPS[precision]
    bytes_s = nbytes / peaks.HBM_BYTES_PER_S
    return dict(ops=ops, bytes=nbytes, bound_s=max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes")
