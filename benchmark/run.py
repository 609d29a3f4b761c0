#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration file and a
traffic file (`benchmark/traffic/<traffic>.json`), whose `driver` names
`benchmark/drivers/<driver>.py`; the compared numbers' limits are in
`benchmark/limits/<cell>.json`. With `--trace 0` the result carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, each
read by `benchmark/metrics/<metric>.py` from the traced slice. It needs
the card: without CUDA, or with fewer cards than the cell asks for, it
prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch
    torch.set_num_threads(2)  # few host threads: steadier host timings
    from benchmark.harness import common
    from benchmark.harness.judge import load_limits

    r = common.resolve(ROOT, args.workload)
    chips = int(r["cell"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); {have} found",
              file=sys.stderr)
        return 2
    run = common.Run(root=ROOT, bench=r["bench"], cell=r["cell"],
                     cfg=r["cfg"], traffic=r["traffic"],
                     limits=load_limits(ROOT, args.workload), seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace), t0=T0,
                     device=torch.device("cuda", 0))
    driver = common.load_module(r["driver"], "bench_driver")
    res = driver.drive(run)
    bad = common.forbidden_loaded()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    bench, cell = r["bench"], args.workload
    if args.trace:
        metrics = common.read_per_layer(ROOT, bench, cell, res["ctx"])
    else:
        metrics = {m["name"]: {"value": float(res["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in common.end_to_end(bench, cell)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(res["peak_bytes"])}
    if args.trace:
        tr, host = (s.trace for s in res["traces"])
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
    result = {"correct": all(c["ok"] for c in res["checks"].values())
              and res["failed"] == 0,
              "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": host.idle_gaps(10)}
    result["checks"] = res["checks"]
    info = {"cell": cell, "seed": args.seed, "trace": args.trace,
            "card": common.power_limit(),
            "peak_bf16_flops": 989e12, **res["info"]}
    common.emit(result, info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
