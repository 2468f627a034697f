"""run_roofline: the witness program's least time a batch over its span
on the device (run_ms), in %.  The least time is the larger of its least
bytes (the inputs read once, the witness rows written once, each value at
its least bytes: full elements at ceil(bits(p) / 8), run_mixed's narrow
rows at a bit) over the HBM bandwidth and its word products over the
integer rate, for one card's share of the batch (witbench/roofline.py)."""

from witbench import manifest, roofline


def lane_out_bytes(ctx):
    e, elem = ctx.entry, ctx.counts["elem_bytes"]
    if e.kind == "run_mixed":
        narrow, wide = e.layout
        return len(narrow) / 8 + elem * len(wide)
    return elem * ctx.counts["n_witness"]


def read(ctx):
    ms = manifest.reader("run_ms").read(ctx)
    if not ms:
        return None
    nbytes, ops = roofline.run_work(ctx.counts, lane_out_bytes(ctx),
                                    ctx.entry.per_shard)
    least, _ = roofline.least_s(nbytes, ops, ctx.int_rate)
    return 100 * least * 1e3 / ms
