"""The global batch's model FLOPs per step (x 3 for training) times the
steps of the traced slice, over its wall time and the peak of all the
cards."""
from perfbench.harness import counts

MOVES = "mesh_train_mix_per_s"
UNIT = "%"


def read(ctx):
    if ctx.slice is None or not ctx.steps:
        return None
    flops = 3.0 * counts.forward_flops(ctx.keys, ctx.widths, ctx.rows,
                                       ctx.frames) * ctx.steps
    peak = counts.PEAK_FLOPS[ctx.keys.get("COMPUTE_DTYPE", "float32")]
    return 100.0 * flops / ctx.slice.window_s / (ctx.chips * peak)
