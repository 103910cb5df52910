"""Share of the traced window in which no kernel ran on the device, in
an open-loop (served) cell: 100 x (1 - kernel busy / window), the kernel
busy time the union of the kernels' intervals.  Copies and sets do not count as busy:
the breakdown's device operations list them by their own names."""


def read(ctx):
    if ctx.loop != "open" or not ctx.trace or not ctx.trace["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["kernel_busy_s"] / ctx.trace["window_s"])
