"""ms ``daemon.Batcher``'s runner takes to stack a batch's items on the
host, the mean over the window's batches: the change in the batcher's own
``stack_s`` over the change in its ``batches``."""


def read(ctx):
    b = getattr(ctx.result, "batcher", None)
    if not b or "stack_s" not in b or not b.get("batches"):
        return None
    return 1e3 * b["stack_s"] / b["batches"]
