"""The train steps' model operations (valid stories, forward and backward, no
recomputation) per second of device time between step ends, outside the
traced slice, as a share of the H100's 989 TFLOP/s dense bf16."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx, "train")
