"""check_ms: the median over the window's batches of the R1CS checker's
span on the device, first operation to last, any card (the trace)."""

import statistics


def read(ctx):
    spans = ctx.trace.layer_spans_ms("wb.check") if ctx.trace else []
    return statistics.median(spans) if spans else None
