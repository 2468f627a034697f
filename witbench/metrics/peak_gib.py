"""peak_gib: torch.cuda.max_memory_allocated over the run, on the fullest
card, in GiB."""


def read(ctx):
    return None if ctx.peak is None else ctx.peak / 2 ** 30
