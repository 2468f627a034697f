"""The statistics the end-to-end metrics and the bounds are made of."""

import statistics


def p95(values):
    """The 95th percentile of every value, by the inclusive method of
    Python's statistics.quantiles (linear between the two nearest ranks)."""
    if len(values) < 2:
        raise ValueError("a percentile of fewer than two values")
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def rate(count, seconds):
    """count over seconds: all the work and all the time of a window."""
    return count / seconds

