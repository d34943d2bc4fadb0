"""Share of the traced slice in which no operation ran on the card (rank
0's card on a mesh): 1 - the union of the device operations' intervals
over the slice's wall time."""
MOVES = "mesh_train_mix_per_s"
UNIT = "%"


def read(ctx):
    if ctx.slice is None or ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)
