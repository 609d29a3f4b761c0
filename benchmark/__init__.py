"""Benchmark of the PyTorch/CUDA sequencer: `python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""
