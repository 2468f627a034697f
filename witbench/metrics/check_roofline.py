"""check_roofline: the R1CS checker's least time a batch over its span on
the device (check_ms), in %: z read once and the R1CS's entries once, at
their least bytes, over the HBM bandwidth, or its word products over the
integer rate, the larger, for one card's share of the batch
(witbench/roofline.py)."""

from witbench import manifest, roofline


def read(ctx):
    ms = manifest.reader("check_ms").read(ctx)
    if not ms:
        return None
    nbytes, ops = roofline.check_work(ctx.counts, ctx.entry.per_shard)
    least, _ = roofline.least_s(nbytes, ops, ctx.int_rate)
    return 100 * least * 1e3 / ms
