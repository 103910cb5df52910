"""The 95th percentile, in ms, of the latency of every request due in the
window, timed as ``latency_p50_ms`` is, from each request's due time to
the return of ``Batcher.submit``; a failed request counts as the loop's
timeout plus the window.  The served tail sits where arrivals spill past a
full batch into a third batcher cycle, so it swings from run to run more
than an end-to-end bound can hold: it is read here, beside the median."""

import numpy as np


def read(ctx):
    lat = getattr(ctx.result, "latency_ms", None)
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 95))
