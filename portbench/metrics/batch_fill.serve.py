"""``daemon.Batcher``'s fill over the window: its items over its batches
times the artifact's batch, from the batcher's own ``stats``."""


def read(ctx):
    b = getattr(ctx.result, "batcher", None)
    if not b or not b.get("batches"):
        return None
    return 100.0 * b["items"] / (b["batches"] * ctx.result.batch)
