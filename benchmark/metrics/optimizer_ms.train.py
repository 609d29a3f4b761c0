"""Device ms a step of the AdamW's `_foreach` kernels (names holding `foreach`
or `multi_tensor`), traced slice."""

from benchmark.harness import readers


def read(ctx):
    return readers.device_ms(ctx, "train", ("foreach", "multi_tensor"))
