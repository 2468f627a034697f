"""idle_share: the share of the traced window in which no operation ran
on the card, from the union of its operations' intervals, averaged over
the cards the cell uses, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = sum(ctx.trace.busy_s().values()) / ctx.chips
    return 100 * (1 - busy / ctx.trace.window_s)
