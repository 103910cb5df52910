"""ms of host work a ``graphs.Graphed`` call does in a closed-loop cell
(the e2e graph's ``full``: key, input copy, clone), from the program's
own span totals (``panodepth_torch.debug.span_totals``, kept while the
profiler records: the traced slice and the batch collected after it):
the ``panodepth.graphs.call`` spans' seconds less their
``panodepth.graphs.replay`` children's, over their number.  The replay
is left out: its launch waits for the batch still on the card, so it
follows the device's backlog, not the host's work."""

import sys


def read(ctx):
    if ctx.loop != "closed" or not ctx.trace:
        return None
    debug = sys.modules.get("panodepth_torch.debug")
    totals = getattr(debug, "span_totals", dict)()
    call = totals.get("panodepth.graphs.call")
    if not call:
        return None
    replay = totals.get("panodepth.graphs.replay", {"s": 0.0})
    return 1e3 * (call["s"] - replay["s"]) / call["n"]
