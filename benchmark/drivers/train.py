"""Closed-loop fine-tuning: `train/steps.py::train_step` with the port's
AdamW on batches from its `data_loader` through `prefetch`, epoch after
epoch over the pool, as `train/loop.py::_train_loop` drives them; each
step is launched as soon as the host can, and nothing syncs between steps
but what the program does itself.

Set-up makes the pool and the weights from the seed, builds the model and
its optimizer on the card, and drives the first `check_steps` steps
through the window's own call and feed: their losses, the first step's
clipped gradient (read from the optimizer's second moment) and the
parameters' change over them are what the reference judges after the
window. Then `warmup_steps` more steps, and the window: steps until
`--seconds` have passed on the host clock, then a synchronize. A CUDA
event after each step's update gives the step times.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch
from multimodal_sequencing_tpu_torch.data.datasets import (data_loader,
                                                           prefetch)
from multimodal_sequencing_tpu_torch.train.steps import train_step

from benchmark.harness import flops, port
from benchmark.harness.common import Run, forbidden_loaded
from benchmark.harness.judge import checks, train_numbers
from benchmark.harness.readers import Context
from benchmark.harness.stories import make_pool
from benchmark.harness.trace import UNIT, slices
from benchmark.harness.weights import kinds, make_weights
from benchmark.reference import data as rdata
from benchmark.reference import model as rmodel
from benchmark.reference.train import grad_norms_from_nu, train_steps


class Feed:
    """The loader's batches, epoch after epoch, as the trainer's loop
    takes them."""

    def __init__(self, ds, batch: int, seed: int):
        self.ds, self.batch, self.seed = ds, batch, seed
        self.epoch = 0
        self.it = self._open()

    def _open(self):
        return prefetch(data_loader(self.ds, self.batch, shuffle=True,
                                    seed=self.seed, epoch=self.epoch))

    def __next__(self):
        while True:
            try:
                return next(self.it)
            except StopIteration:
                self.epoch += 1
                self.it = self._open()


class TowerRange:
    """`record_function("bench.tower_fwd")` around the CLIP tower's
    forward while `active` (hooks only in a traced run)."""

    def __init__(self, model, traced: bool):
        self.active, self.rf = False, None
        tower = getattr(model.encoder, "visual_model", None)
        self.present = tower is not None
        if self.present and traced:
            tower.register_forward_pre_hook(self._enter)
            tower.register_forward_hook(self._exit)

    def _enter(self, *_):
        if self.active:
            self.rf = torch.autograd.profiler.record_function(
                "bench.tower_fwd")
            self.rf.__enter__()

    def _exit(self, *_):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


def prepare(run: Run):
    cfg, traffic, seed = run.cfg, run.traffic, run.seed
    stories, images = make_pool(traffic, seed)
    if traffic["pool_stories"] % traffic["batch"]:
        raise ValueError("the pool must be a multiple of the batch")
    ds = port.dataset("train", cfg, stories, images, seed)
    model = port.build_model(cfg, traffic, make_weights(cfg, seed, run.device),
                             run.device)
    opt = port.optimizer(model, traffic)
    return {"stories": stories, "images": images, "model": model, "opt": opt,
            "feed": Feed(ds, traffic["batch"], seed)}


def first_steps(run: Run, st: Dict) -> Dict:
    """The program's readings of the first `check_steps` steps."""
    step_fn = run.step_fn or train_step
    losses, out = [], {}
    for k in range(run.traffic["check_steps"]):
        res = step_fn(st["model"], st["opt"], next(st["feed"]), k, run.seed)
        losses.append(res["loss"])
        if k == 0:
            out["grad"] = grad_norms_from_nu(port.optimizer_nu(st["opt"]))
    start = make_weights(run.cfg, run.seed, run.device)
    out.update(port.program_readings(st["model"], st["opt"], start, run.cfg))
    del start
    out["losses"] = [float(x) for x in losses]
    return out


def reference(run: Run, stories, images, quant=rmodel._id,
              rows_used=None) -> Dict:
    """The reference's readings of the same first steps, from the seed."""
    cfg, traffic = run.cfg, run.traffic
    picks = rdata.batch_picks(traffic["pool_stories"], traffic["batch"],
                              run.seed, 0, traffic["check_steps"])
    batches = [rdata.story_inputs(stories, p, run.seed, cfg, images)
               for p in picks]
    weights = make_weights(cfg, run.seed, run.device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return train_steps(weights, kinds(cfg), cfg, batches, run.seed,
                           traffic["optimizer"],
                           block_rows=traffic["reference_block_rows"],
                           quant=quant, rows_used=rows_used)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def drive(run: Run) -> Dict:
    cfg, traffic, seed = run.cfg, run.traffic, run.seed
    cuda = run.device.type == "cuda"
    marks = {"start": time.perf_counter() - run.t0}
    st = prepare(run)
    marks["prepared"] = time.perf_counter() - run.t0
    prog = first_steps(run, st)
    marks["first_steps"] = time.perf_counter() - run.t0
    step_fn = run.step_fn or train_step
    model, opt, feed = st["model"], st["opt"], st["feed"]
    step = traffic["check_steps"]
    for _ in range(traffic["warmup_steps"]):
        step_fn(model, opt, next(feed), step, seed)
        step += 1
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

    B = traffic["batch"]
    ends, spans, losses = [], [], []
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    t_w0 = time.perf_counter()
    if cuda:
        ev0.record()
    u = 0
    while True:
        for sl in sls:
            sl.before(u)
        traced = host_sl is not None and host_sl.covers(u)
        tower.active = traced
        rf = (torch.autograd.profiler.record_function if traced
              else lambda _: contextlib.nullcontext())
        with rf(UNIT):
            ta = time.perf_counter()
            with rf("bench.data_wait"):
                batch = next(feed)
            tb = time.perf_counter()
            with rf("bench.train_step"):
                out = step_fn(model, opt, batch, step, seed)
            tc = time.perf_counter()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        for sl in sls:
            sl.after(u)
        losses.append(out["loss"])
        spans.append((tb - ta, tc - tb))
        step += 1
        u += 1
        if (time.perf_counter() - t_w0 >= run.seconds
                and all(u >= sl.end for sl in sls)):
            break
    if cuda:
        torch.cuda.synchronize()
    t_w1 = time.perf_counter()
    window_s = t_w1 - t_w0
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"loaded by the end of the window: {bad}")

    launches = {k: (v - launches0[k]) / u
                for k, v in port.launch_counts().items()}
    if cuda:
        evs = [ev0] + ends
        intervals = [a.elapsed_time(b) / 1e3 for a, b in zip(evs, evs[1:])]
        peak = torch.cuda.max_memory_allocated()
    else:
        intervals = [s[0] + s[1] for s in spans]
        peak = 0
    finite = [bool(torch.isfinite(x)) for x in losses]
    n_img = traffic.get("images_per_story", 0)
    skip = set()
    for sl in sls:
        sl.finish()
        skip |= set(range(sl.first - 1, sl.end + 1))
    outside = [i for i in range(u) if i not in skip]
    ctx = Context(
        kind="train", unit_seconds=[intervals[i] for i in outside],
        data_wait_s=[spans[i][0] for i in outside],
        host_step_s=[spans[i][1] for i in outside],
        flops_per_unit=flops.model_flops(cfg, B, True, n_img),
        attention_least_s_per_unit=flops.attention_least_seconds(
            cfg, B, True, n_img),
        trace=dev_sl and dev_sl.trace,
        host_trace=host_sl and host_sl.trace,
        peak_bytes=peak,
        has_tower=tower.present)
    e2e = {"train_stories_per_s": B * u / window_s,
           "train_step_ms.p90": float(np.percentile(intervals, 90)) * 1e3,
           "setup_s": setup_s}

    stories, images = st["stories"], st["images"]
    del st, model, opt, feed, batch, out, losses
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(run, stories, images)
    marks["reference_s"] = time.perf_counter() - t_ref
    numbers = train_numbers(prog, ref)
    return {"e2e": e2e, "ctx": ctx, "checks": checks(numbers, run.limits),
            "attempted": B * u, "failed": B * finite.count(False),
            "peak_bytes": peak, "traces": sls,
            "info": {"steps": u, "step_time_samples": len(intervals),
                     "p90_samples_beyond": int(sum(
                         1 for x in intervals
                         if x > np.percentile(intervals, 90))),
                     "stories_per_step": B, "launches_per_step": launches,
                     "window_s": window_s, "reference_losses": ref["losses"],
                     "program_losses": prog["losses"], "setup_marks_s": marks}}
