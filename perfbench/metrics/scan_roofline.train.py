"""The training scans' least time (each layer's saving forward, kernel 2,
and backward, kernel 3: ``counts.train_scan_bound_s``) times the steps of
the traced slice, over the device time of the LSTM scan kernels there."""
import re

from perfbench.harness import counts

MOVES = "train_mix_per_s"
UNIT = "%"
SCANS = re.compile(r"lstm_scan")


def read(ctx):
    if ctx.slice is None or not ctx.steps:
        return None
    spent = ctx.slice.time_of(lambda n: SCANS.search(n) is not None)
    if spent <= 0:
        return None
    bound = counts.train_scan_bound_s(ctx.keys, ctx.widths, ctx.rows,
                                      ctx.frames) * ctx.steps
    return 100.0 * bound / spent
