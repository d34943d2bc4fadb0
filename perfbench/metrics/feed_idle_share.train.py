"""Share of the traced slice in which the card idled while the driving
thread waited for a prepared batch or copied it onto the card (the
program's ``danet.train.feed_wait`` and ``danet.train.put`` spans): the
exact intersection of the device's gaps with those spans, over the
slice's wall time.  None without such spans."""
from perfbench.harness import spans

MOVES = "train_mix_per_s"
UNIT = "%"


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.window_s <= 0:
        return None
    feed = spans.named(sl, "danet.train.feed_wait", "danet.train.put")
    if not feed:
        return None
    return 100.0 * spans.overlap(spans.idle(sl), feed) * 1e-6 / sl.window_s
