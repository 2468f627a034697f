"""run_ms: the median over the window's batches of the witness program's
span on the device, from the first operation the entry launched to the
last one's end on any card (the profiler's trace)."""

import statistics


def read(ctx):
    spans = ctx.trace.layer_spans_ms("wb.run") if ctx.trace else []
    return statistics.median(spans) if spans else None
