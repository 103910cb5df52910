"""ms an item of ``daemon.Batcher`` waits, from its enqueue to the start of
its batch's stack, the mean over the window's items: the change in the
batcher's own ``wait_s`` over the change in its ``items``."""


def read(ctx):
    b = getattr(ctx.result, "batcher", None)
    if not b or "wait_s" not in b or not b.get("items"):
        return None
    return 1e3 * b["wait_s"] / b["items"]
