#!/usr/bin/env python3
"""The readings that the limits of `benchmark/limits/<cell>.json` are set
from, on the card at the cell's own size, many seeds in one process:

  train cells: the program's first steps against the reference (the lower
  reading), the reference computed with float8 operands in the program's
  place (the control), and the reference with half of each batch left out
  of the loss (a planted fault), each against the reference;
  eval cells: the program's heat maps of the sampled stories against the
  reference's, and the float8 reference's against the reference's.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed. It runs no measured window.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worst_leaves(prog, ref, n=6):
    import statistics
    med = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref}
    return [[k, gaps[k], prog[k], ref[k]] for k in
            sorted(gaps, key=gaps.get, reverse=True)[:n]] + [["median", med]]


def _no_dropout(attention):
    def wrapped(q, k, v, key_keep, p=0.0, bits=None, *rest, **kw):
        return attention(q, k, v, key_keep, p, None, *rest, **kw)
    return wrapped


def _keys_cut(attention, at=512):
    def wrapped(q, k, v, key_keep, p=0.0, bits=None, *rest, **kw):
        if key_keep is not None and key_keep.shape[-1] > at:
            key_keep = key_keep.clone()
            key_keep[:, at:] = False
        return attention(q, k, v, key_keep, p, bits, *rest, **kw)
    return wrapped


ATTN_FAULTS = {"attn_no_dropout": _no_dropout, "attn_keys_cut": _keys_cut}


@contextlib.contextmanager
def planted(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=3,
                    help="eval cells: batches the program evaluates a seed")
    ap.add_argument("--program-dtype", default=None,
                    help="run the program in this dtype instead of the "
                         "configuration's (a second witness)")
    ap.add_argument("--skip-faults", action="store_true",
                    help="train cells: the program's readings alone")
    ap.add_argument("--no-tf32", action="store_true",
                    help="keep TF32 off in the program too")
    ap.add_argument("--attn-faults", action="store_true",
                    help="train cells: also the reference with attention's "
                         "dropout left out, and with the keys from the "
                         "512th on left out (planted faults of the flash "
                         "kernels at long S)")
    ap.add_argument("--leaf-gaps", action="store_true",
                    help="train cells: print every leaf's gap in its share "
                         "of the first step's gradient outside the tower")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from benchmark.harness import common
    from benchmark.harness.judge import TOWER, shares, train_numbers
    from benchmark.reference import model as rmodel

    r = common.resolve(ROOT, args.workload)
    if args.no_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.program_dtype:
        r["cfg"]["dtype"] = args.program_dtype
        r["cfg"]["raw"]["sequencer"]["dtype"] = args.program_dtype
    driver = common.load_module(r["driver"], "bench_driver")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = common.Run(root=ROOT, bench=r["bench"], cell=r["cell"],
                         cfg=r["cfg"], traffic=r["traffic"], limits={},
                         seed=seed, seconds=0.0, trace=False, t0=t0,
                         device=torch.device("cuda", 0))
        st = driver.prepare(run)
        out = {"cell": args.workload, "seed": seed}
        if r["traffic"]["driver"] == "train":
            prog = driver.first_steps(run, st)
            stories, images = st["stories"], st["images"]
            del st
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ref = driver.reference(run, stories, images)
            out["reference_s"] = time.perf_counter() - t1
            got = {"program": prog}
            if not args.skip_faults:
                got["control_fp8"] = driver.reference(run, stories, images,
                                                      quant=rmodel.fp8)
                got["half_batch"] = driver.reference(
                    run, stories, images,
                    rows_used=r["traffic"]["batch"] // 2)
            if args.attn_faults:
                for key, fault in ATTN_FAULTS.items():
                    with planted(rmodel, "attention", fault(rmodel.attention)):
                        got[key] = driver.reference(run, stories, images)
            for key, g in got.items():
                out[key] = train_numbers(g, ref)
                out[key]["worst_grad_leaves"] = worst_leaves(
                    g["grad"], ref["grad"])
                joint = [n for n in ref["grad"] if not n.startswith(TOWER)]
                out[key]["worst_share_leaves"] = worst_leaves(
                    shares(g["grad"], joint), shares(ref["grad"], joint),
                    len(joint) if args.leaf_gaps else 6)
        else:
            feed = driver.batches(st["ds"], r["traffic"])
            picks = []

            def batches():
                for _ in range(args.batches):
                    p, b = next(feed)
                    picks.extend(p)
                    yield b

            driver.evaluate(st, batches())
            hms = np.concatenate([x[0] for x in st["evaluator"].records])
            st["model"] = None
            torch.cuda.empty_cache()
            from benchmark.reference import data as rdata
            rng = np.random.default_rng(seed)
            k = min(r["traffic"]["check_stories"], len(picks))
            sample = np.sort(rng.choice(len(picks), size=k, replace=False))
            inputs = rdata.story_inputs(st["stories"],
                                        [picks[i] for i in sample], seed,
                                        r["cfg"], st["images"])
            t1 = time.perf_counter()
            ref = driver.reference_heatmaps(run, inputs)
            out["reference_s"] = time.perf_counter() - t1
            ctrl = driver.reference_heatmaps(run, inputs, rmodel.fp8)
            out["program"] = {"heatmap_gap": [
                float(np.abs(hms[sample] - ref).max()), "sampled stories"]}
            out["control_fp8"] = {"heatmap_gap": [
                float(np.abs(ctrl - ref).max()), "sampled stories"]}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
