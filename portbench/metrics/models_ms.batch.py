"""ms a panorama of ``e2e.models_stage`` (the baseline net, extraction,
the perspective net): its graph replayed, then ``fuse_stage``'s, CUDA
events around each, the median over the steps after the window."""

import statistics


def read(ctx):
    st = getattr(ctx.result, "stages", None)
    return statistics.median(st["models_ms"]) if st else None
