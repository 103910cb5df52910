"""The e2e step's share of the card's peak: the least time the nets'
counted work takes at the published peaks (``counts/work.least_step_s``:
bfloat16 convs at 989 TFLOP/s, int8 convs at 1979 TOP/s, the float32
heads at 67 TFLOP/s), times the panoramas completed in the traced
window, over that window."""

from portbench.counts import work


def read(ctx):
    res = ctx.result
    if ctx.loop != "closed" or not ctx.trace or not res.trace_panos:
        return None
    return 100.0 * work.least_step_s(ctx.config, str(ctx.root)) \
        * res.trace_panos / ctx.trace["window_s"]
