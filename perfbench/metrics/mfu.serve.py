"""The forward FLOPs of every request of the traced slice, each at its own
frame count, over the slice's wall time and the card's peak."""
from perfbench.harness import counts

MOVES = "request_ms_p95"
UNIT = "%"


def read(ctx):
    if ctx.slice is None or not ctx.requests:
        return None
    flops = sum(counts.forward_flops(ctx.keys, ctx.widths, 1, t)
                for t in ctx.requests)
    peak = counts.PEAK_FLOPS[ctx.keys.get("COMPUTE_DTYPE", "float32")]
    return 100.0 * flops / ctx.slice.window_s / peak
