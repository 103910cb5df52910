"""``kernels.qconv`` (``qconv_kernel``) against its bound: the int8
convs' operations at 1979 TOP/s, or their bytes at 3.35 TB/s, whichever
is longer (``counts/work.qconv``)."""

from portbench.counts import work
from portbench.harness.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, work.qconv(ctx.config, str(ctx.root)), "qconv_kernel")
