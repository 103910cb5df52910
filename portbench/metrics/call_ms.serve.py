"""ms of each call of the ``serve.Artifact`` that the batcher makes in the
window, timed by a wrapper the harness hands the batcher in place of the
artifact, from the call to its outputs on the host: the median."""

import statistics


def read(ctx):
    calls = getattr(ctx.result, "call_ms", None)
    return statistics.median(calls) if calls else None
