"""The lean scans' least time (kernel B, ``counts.infer_scan_bound_s``)
over every request of the traced slice, over the device time of the LSTM
scan kernels there."""
import re

from perfbench.harness import counts

MOVES = "request_ms_p95"
UNIT = "%"
SCANS = re.compile(r"lstm_scan")


def read(ctx):
    if ctx.slice is None or not ctx.requests:
        return None
    spent = ctx.slice.time_of(lambda n: SCANS.search(n) is not None)
    if spent <= 0:
        return None
    bound = sum(counts.infer_scan_bound_s(ctx.keys, ctx.widths, 1, t)
                for t in ctx.requests)
    return 100.0 * bound / spent
