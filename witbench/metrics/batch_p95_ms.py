"""batch_p95_ms: the 95th percentile of every batch's latency in the
window (host clock), from the call into the entry to the verdicts on the
host, or the witness complete on the card(s)."""

from witbench import stats


def read(ctx):
    if len(ctx.latencies_s) < 2:
        return None
    return stats.p95(ctx.latencies_s) * 1e3
