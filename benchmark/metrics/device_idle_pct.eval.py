"""Share of an untraced batch's time in which nothing runs on the card: 1 - the
card-only slice's busy time a batch (the union of kernel, copy and set
intervals) over the mean time between batch ends outside the traced slices."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_pct(ctx, "eval")
