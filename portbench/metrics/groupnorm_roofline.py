"""``kernels.groupnorm`` (``gn_cluster``) against its bound: every
GroupNorm of a panorama, a bfloat16 input read and a float32 output
written at 3.35 TB/s (``counts/work.groupnorm``)."""

from portbench.counts import work
from portbench.harness.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, work.groupnorm(ctx.config, str(ctx.root)), "gn_cluster")
