"""Rank 0's time in NCCL kernels (the union of their intervals) over the
union of all its device operations' intervals, in the traced slice: the
collectives with their wait for the slowest rank."""
MOVES = "mesh_train_mix_per_s"
UNIT = "%"


def read(ctx):
    if ctx.slice is None or ctx.slice.busy_s <= 0:
        return None
    nccl = ctx.slice.busy_of(lambda n: "nccl" in n.lower())
    if nccl <= 0:
        return None
    return 100.0 * nccl / ctx.slice.busy_s
