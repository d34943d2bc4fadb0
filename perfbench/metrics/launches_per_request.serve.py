"""Operations on the card (kernels, copies, sets) that start inside the
program's request spans (``danet.request``), over the number of those
spans.  None without such spans."""
import bisect

from perfbench.harness import spans

MOVES = "request_ms_p50"
UNIT = "ops"


def read(ctx):
    if ctx.slice is None:
        return None
    req = spans.named(ctx.slice, "danet.request")
    if not req:
        return None
    starts = [s for s, _ in req]
    n = 0
    for _, s, _ in ctx.slice.device:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < req[i][1]:
            n += 1
    return n / len(req)
