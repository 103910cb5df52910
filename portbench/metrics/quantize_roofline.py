"""``kernels.qconv``'s quantization (``quantize_kernel``) against its
bound: each input read once, a code written an element, the scales,
at 3.35 TB/s (``counts/work.quantize``)."""

from portbench.counts import work
from portbench.harness.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, work.quantize(ctx.config, str(ctx.root)), "quantize_kernel")
