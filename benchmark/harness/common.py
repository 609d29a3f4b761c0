"""One run of one cell: what BENCHMARK.json names for it, the isolation
guard, the per-layer metric readers and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_sequencing_tpu")


@dataclass
class Run:
    root: str
    bench: Dict
    cell: Dict
    cfg: Dict
    traffic: Dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: Any = None
    # planted faults (tests): a replacement of the program's train step;
    # wrappers of the evaluator's decode and of each batch it is fed
    step_fn: Optional[Callable] = None
    wrap_decode: Optional[Callable] = None
    wrap_batch: Optional[Callable] = None


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: str, workload: str) -> Dict:
    """The cell's entries: workload, configuration entry, the parsed
    configuration and traffic files, and the driver's path."""
    from .weights import load_config
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = read_json(os.path.join(root, "benchmark", "traffic",
                                     cell["traffic"] + ".json"))
    driver = os.path.join(root, "benchmark", "drivers",
                          traffic["driver"] + ".py")
    return {"bench": bench, "cell": cell, "config": conf,
            "cfg": load_config(os.path.join(root, conf["file"])),
            "traffic": traffic, "driver": driver}


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules (of `modules`) that are the JAX
    package, JAX or Flax, compared whole: `multimodal_sequencing_tpu_torch`
    is another name."""
    tops = {m.split(".")[0] for m in list(sys.modules if modules is None
                                          else modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def applies(entry: Dict, cell: str, reported: List[str]) -> bool:
    """Whether a metric entry is reported in this cell: it lists the cell,
    or it has no list and the cell reports the metric it moves (a
    per-layer one) or it is end to end."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell, [])]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    e2e = [m["name"] for m in end_to_end(bench, cell)]
    return [m for m in bench["per_layer"] if applies(m, cell, e2e)]


def read_per_layer(root: str, bench: Dict, cell: str, ctx) -> Dict:
    """Each per-layer metric of the cell from its reader
    (`benchmark/metrics/<name>.py`, `read(ctx)`); one that finds nothing
    is left out."""
    out = {}
    for m in per_layer(bench, cell):
        path = os.path.join(root, "benchmark", "metrics", m["name"] + ".py")
        mod = load_module(path, "bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def emit(result: Dict, info: Dict) -> None:
    """The cell's line of counts, the result as the last line of standard
    output, and each compared number beside its limit as the last lines of
    standard error."""
    checks = result.pop("checks")
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                        for n, c in checks.items()}
    print(json.dumps(info), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'} (worst at {c['at']})",
              file=sys.stderr, flush=True)
