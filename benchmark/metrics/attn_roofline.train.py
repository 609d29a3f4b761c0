"""The attention calls' least time (max of operations at 989 TFLOP/s and bytes
at 3.35 TB/s, counted from the configuration's shapes, forward and backward)
over the device time of the flash kernels, traced slice."""

from benchmark.harness import readers


def read(ctx):
    return readers.attention_roofline_pct(ctx, "train")
