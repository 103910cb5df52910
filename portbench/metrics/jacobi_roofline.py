"""``kernels.jacobi`` (``jacobi_tile``) against its bound: 14 float32
operations a covered pixel-iteration at 67 TFLOP/s, or 13 bytes a pixel
of each level at 3.35 TB/s, whichever is longer (``counts/work.jacobi``)."""

from portbench.counts import work
from portbench.harness.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, work.jacobi(ctx.config), "jacobi_tile")
