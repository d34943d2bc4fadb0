"""Share of the program's request spans (``danet.request``: each
``Separator.separate`` call, which ends in its copy to the host) in which
no operation ran on the card: the idle time the program leaves, without
the client's time between requests.  None without such spans."""
from perfbench.harness import spans

MOVES = "request_ms_p50"
UNIT = "%"


def read(ctx):
    if ctx.slice is None:
        return None
    req = spans.named(ctx.slice, "danet.request")
    total = spans.length(req)
    if total <= 0:
        return None
    busy = spans.overlap(req, spans.device(ctx.slice))
    return 100.0 * (1.0 - busy / total)
