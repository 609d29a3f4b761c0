"""Closed-loop sort evaluation: `SortEvaluator.evaluate` with the heat-map
method over the port's `SortDataset` loader, batch after batch and epoch
after epoch over the pool, as `trainers.eval` runs a checkpoint sweep;
each batch is packed, run forward in the evaluator's micro-batches,
decoded to orders (on the card with `device_decode`) and, at the end,
scored.

Set-up makes the pool and the weights from the seed, builds the model
cast for inference and runs `warmup_batches` batches. The window feeds
`evaluate` until `--seconds` have passed on the host clock; it ends when
`evaluate` returns its metrics, after a synchronize. After the window
the reference judges every order against the heat map it was decoded
from, the metrics against the orders and the gold orders, and a sample
of the heat maps, drawn from the seed, against its own forward.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from multimodal_sequencing_tpu_torch.data.datasets import data_loader

from benchmark.harness import flops, port
from benchmark.harness.common import Run, forbidden_loaded
from benchmark.harness.judge import checks
from benchmark.harness.readers import Context
from benchmark.harness.stories import make_pool
from benchmark.harness.trace import UNIT, slices
from benchmark.harness.weights import make_weights
from benchmark.reference import data as rdata
from benchmark.reference import evaluate as reval
from benchmark.reference import model as rmodel

from benchmark.drivers.train import TowerRange


def prepare(run: Run) -> Dict:
    cfg, traffic, seed = run.cfg, run.traffic, run.seed
    stories, images = make_pool(traffic, seed)
    if traffic["pool_stories"] % traffic["eval_batch"]:
        raise ValueError("the pool must be a multiple of the eval batch")
    ds = port.dataset("eval", cfg, stories, images, seed)
    model = port.build_model(cfg, traffic, make_weights(cfg, seed, run.device),
                             run.device, for_eval=True)
    return {"stories": stories, "images": images, "ds": ds, "model": model,
            "evaluator": port.evaluator(cfg, traffic, run.device)}


def batches(ds, traffic: Dict):
    """([(epoch, story), ...], batch) of the loader, epoch after epoch."""
    b = traffic["eval_batch"]
    epoch = 0
    while True:
        for j, batch in enumerate(data_loader(ds, b, epoch=epoch)):
            yield [(epoch, i) for i in range(j * b, (j + 1) * b)], batch
        epoch += 1


def evaluate(st: Dict, feed) -> Dict[str, float]:
    return st["evaluator"].evaluate(feed, "heat_map",
                                    {"heatmap": st["model"]})


def judge(run: Run, st: Dict, picks: List, results: Dict[str, float],
          quant=rmodel._id) -> Dict:
    """The compared numbers: order_faults (orders that are not the
    naive_v2_sum argmax of their own heat map), metric_gap (the largest
    gap between a reported metric and the same metric of the reported
    orders against the gold ones) and heatmap_gap (the largest gap of a
    sampled story's heat map to the reference's)."""
    cfg, traffic = run.cfg, run.traffic
    records = st["evaluator"].records
    hms = np.concatenate([r[0] for r in records])
    orders = [o for r in records for o in r[1]]
    if len(orders) != len(picks) or len(hms) != len(picks):
        # stories fed to the evaluator and never answered
        missing = float(abs(len(picks) - min(len(orders), len(hms))))
        return {"order_faults": (missing, f"{len(orders)} orders, "
                                 f"{len(hms)} heat maps, {len(picks)} fed"),
                "metric_gap": (float("inf"), "not judged"),
                "heatmap_gap": (float("inf"), "not judged")}
    n = cfg["max_story_length"]
    golds = [list(np.argsort(rdata.scramble(n, run.seed, e, i)))
             for e, i in picks]
    faults = reval.order_faults(hms, orders)
    ref_metrics = reval.metrics(orders, golds, n)
    metric_gap = max(abs(results[m] - ref_metrics[m]) for m in reval.METRICS)
    rng = np.random.default_rng(run.seed)
    k = min(traffic["check_stories"], len(picks))
    sample = np.sort(rng.choice(len(picks), size=k, replace=False))
    inputs = rdata.story_inputs(st["stories"], [picks[i] for i in sample],
                                run.seed, cfg, st["images"])
    ref_hm = reference_heatmaps(run, inputs, quant)
    gaps = np.abs(hms[sample] - ref_hm)
    worst = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
    return {"order_faults": (float(faults), f"{len(orders)} orders"),
            "metric_gap": (float(metric_gap), f"{results} vs {ref_metrics}"),
            "heatmap_gap": (float(gaps.max()),
                            f"story {picks[sample[worst[0]]]} pair "
                            f"{tuple(int(x) for x in worst[1:])}")}


def reference_heatmaps(run: Run, inputs: Dict, quant=rmodel._id):
    weights = make_weights(run.cfg, run.seed, run.device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return reval.heatmaps(weights, run.cfg, inputs,
                              run.traffic["reference_block_rows"], quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def drive(run: Run) -> Dict:
    cfg, traffic = run.cfg, run.traffic
    cuda = run.device.type == "cuda"
    marks = {"start": time.perf_counter() - run.t0}
    st = prepare(run)
    marks["prepared"] = time.perf_counter() - run.t0
    ev, model = st["evaluator"], st["model"]
    if run.wrap_decode is not None:
        ev.decode = run.wrap_decode(ev.decode)
    feed = batches(st["ds"], traffic)
    warm = traffic["warmup_batches"]
    evaluate(st, (next(feed)[1] for _ in range(warm)))
    ev.records = []
    tower = TowerRange(model, run.trace)
    sls = slices(traffic) if run.trace else []
    dev_sl, host_sl = (sls + [None, None])[:2]
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"loaded before the window: {bad}")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches0 = port.launch_counts()
    setup_s = time.perf_counter() - run.t0

    B = traffic["eval_batch"]
    ends, waits, picks = [], [], []
    state = {"u": 0, "rf": None}
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    t_w0 = time.perf_counter()
    if cuda:
        ev0.record()

    def close_unit():
        u = state["u"]
        if state["rf"] is not None:
            state["rf"].__exit__(None, None, None)
            state["rf"] = None
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ends.append(e)
        for sl in sls:
            sl.after(u)
        state["u"] = u + 1

    def timed():
        while True:
            u = state["u"]
            if u and (time.perf_counter() - t_w0 >= run.seconds
                      and all(u >= sl.end for sl in sls)):
                return
            for sl in sls:
                sl.before(u)
            traced = host_sl is not None and host_sl.covers(u)
            tower.active = traced
            if traced:
                state["rf"] = torch.autograd.profiler.record_function(UNIT)
                state["rf"].__enter__()
            t = time.perf_counter()
            p, batch = next(feed)
            waits.append(time.perf_counter() - t)
            picks.extend(p)
            yield batch if run.wrap_batch is None else run.wrap_batch(batch)
            close_unit()

    results = evaluate(st, timed())
    if cuda:
        torch.cuda.synchronize()
    t_w1 = time.perf_counter()
    window_s = t_w1 - t_w0
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"loaded by the end of the window: {bad}")
    u = state["u"]
    launches = {k: (v - launches0[k]) / max(u, 1)
                for k, v in port.launch_counts().items()}
    if cuda:
        evs = [ev0] + ends
        intervals = [a.elapsed_time(b) / 1e3 for a, b in zip(evs, evs[1:])]
        peak = torch.cuda.max_memory_allocated()
    else:
        intervals, peak = [window_s / max(u, 1)] * u, 0
    n_img = traffic.get("images_per_story", 0)
    micro = B * 4
    rows = -(-B // micro) * micro
    skip = set()
    for sl in sls:
        sl.finish()
        skip |= set(range(sl.first - 1, sl.end + 1))
    outside = [i for i in range(len(intervals)) if i not in skip]
    ctx = Context(
        kind="eval", unit_seconds=[intervals[i] for i in outside],
        data_wait_s=[waits[i] for i in outside if i < len(waits)],
        flops_per_unit=flops.model_flops(cfg, B, False, n_img),
        attention_least_s_per_unit=flops.attention_least_seconds(
            cfg, rows, False, n_img),
        trace=dev_sl and dev_sl.trace,
        host_trace=host_sl and host_sl.trace,
        peak_bytes=peak,
        has_tower=tower.present)
    e2e = {"eval_stories_per_s": len(picks) / window_s, "setup_s": setup_s}

    del model, feed
    st["model"] = None
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge(run, st, picks, results)
    marks["judge_s"] = time.perf_counter() - t_ref
    return {"e2e": e2e, "ctx": ctx, "checks": checks(numbers, run.limits),
            "attempted": len(picks), "failed": int(numbers["order_faults"][0]),
            "peak_bytes": peak, "traces": sls,
            "info": {"batches": u, "batch_time_samples": len(intervals),
                     "stories_per_batch": B, "micro_batch_rows": rows,
                     "launches_per_batch": launches, "window_s": window_s,
                     "metrics": results, "setup_marks_s": marks}}
