"""Host ms a step waiting on the port's loader (`next()` of its prefetched
data_loader), mean over the window's steps outside the traced slice."""

from benchmark.harness import readers


def read(ctx):
    return readers.mean_ms(ctx, "train", ctx.data_wait_s)
