"""The harness: cells resolved from BENCHMARK.json, inputs and weights
from the seed, FLOP and byte counts, the profiler slice, the judgement."""
