"""The training step's model FLOPs (``counts.forward_flops`` x 3) times
the steps of the traced slice, over its wall time and the card's peak
for COMPUTE_DTYPE."""
from perfbench.harness import counts

MOVES = "train_mix_per_s"
UNIT = "%"


def read(ctx):
    if ctx.slice is None or not ctx.steps:
        return None
    flops = 3.0 * counts.forward_flops(ctx.keys, ctx.widths, ctx.rows,
                                       ctx.frames) * ctx.steps
    peak = counts.PEAK_FLOPS[ctx.keys.get("COMPUTE_DTYPE", "float32")]
    return 100.0 * flops / ctx.slice.window_s / peak
