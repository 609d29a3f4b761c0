"""Host ms a step inside `train_step` (launching forward, backward, clipping
and AdamW, no sync), mean over the window's steps outside the traced slice."""

from benchmark.harness import readers


def read(ctx):
    return readers.mean_ms(ctx, "train", ctx.host_step_s)
