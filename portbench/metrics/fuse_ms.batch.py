"""ms a panorama of ``e2e.fuse_stage`` (registration and fusion with its
Jacobi): replayed after ``models_stage``'s, CUDA
events around each, the median over the steps after the window."""

import statistics


def read(ctx):
    st = getattr(ctx.result, "stages", None)
    return statistics.median(st["fuse_ms"]) if st else None
