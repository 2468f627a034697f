"""setup_s: from the process's start to the window's: importing, reading
or building the compiled program, building or loading the kernels, the
card's context, making the input pool and the warm-up batches."""


def read(ctx):
    return ctx.setup_s
