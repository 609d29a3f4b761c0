"""Device ms a batch of the kernels launched inside the CLIP tower's forward
(`encoder.visual_model`), over the traced slice."""

from benchmark.harness import readers


def read(ctx):
    return readers.tower_ms(ctx, "eval")
