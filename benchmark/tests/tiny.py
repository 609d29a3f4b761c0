"""Tiny configurations and a CPU run of a driver, for the tests."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from benchmark.harness.common import Run, load_module, read_json
from benchmark.harness.weights import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"vocab_size": 1000, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 160}
TINY_VISION = {"layers": [1, 1, 1, 1], "width": 8, "heads": 4,
               "output_dim": 32, "image_resolution": 32}
TINY_SEQ = {"max_seq_length": 96, "per_seq_max_length": 20,
            "dtype": "float32"}


def tiny_config(tmp_path, name: str, dtype: str = "float32"):
    """The configuration file of `name`, cut to test size, as loaded."""
    raw = read_json(os.path.join(ROOT, "benchmark", "configs", name + ".json"))
    raw.update(TINY)
    raw["sequencer"].update(TINY_SEQ, dtype=dtype)
    if raw.get("vision"):
        raw["vision"].update(TINY_VISION)
    path = os.path.join(str(tmp_path), name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return load_config(path)


def tiny_traffic(name: str, **over):
    t = copy.deepcopy(read_json(os.path.join(
        ROOT, "benchmark", "traffic", name + ".json")))
    small = {"train": dict(batch=4, pool_stories=16, warmup_steps=1,
                           trace_slice=[1, 1], reference_block_rows=2),
             "eval": dict(eval_batch=4, pool_stories=16, warmup_batches=1,
                          trace_slice=[1, 1], check_stories=6,
                          reference_block_rows=3)}[t["driver"]]
    t.update(small)
    if t.get("images_per_story"):
        t["image_size"] = TINY_VISION["image_resolution"]
    t.update(over)
    return t


def cpu_run(tmp_path, cell: str, limits, seed: int = 12345,
            dtype: str = "float32", **kw):
    """Drives `cell` on the CPU at test size; returns the driver's result."""
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = {c["name"]: c for c in bench["workloads"]}[cell]
    traffic = tiny_traffic(w["traffic"])
    run = Run(root=ROOT, bench=bench, cell=w,
              cfg=tiny_config(tmp_path, w["config"], dtype), traffic=traffic,
              limits=limits, seed=seed, seconds=0.5, trace=False,
              t0=time.perf_counter(), device=torch.device("cpu"), **kw)
    driver = load_module(os.path.join(ROOT, "benchmark", "drivers",
                                      traffic["driver"] + ".py"),
                         "bench_driver_" + traffic["driver"])
    return driver.drive(run)
