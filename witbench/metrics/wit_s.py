"""wit_s: the lanes the window's batches completed over the window's
seconds (host clock); in a checked cell every one of them was checked."""

from witbench import stats


def read(ctx):
    return stats.rate(ctx.n_batches * ctx.lanes, ctx.window_s)
