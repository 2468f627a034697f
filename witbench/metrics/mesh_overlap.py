"""mesh_overlap: the cards' summed busy time in the traced window over
the window's wall time (x): how many cards' work overlaps on average."""


def read(ctx):
    if ctx.trace is None or ctx.chips < 2:
        return None
    return sum(ctx.trace.busy_s().values()) / ctx.trace.window_s
