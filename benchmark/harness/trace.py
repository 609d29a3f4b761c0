"""The traced slices: `torch.profiler` over fixed runs of steps or
batches inside the window, read from its Chrome trace. The first traces
the card alone, for device time and idle share; the second the host too,
for the benchmark's ranges and the host op that each idle gap waits on.

Device time is the union of the intervals of kernels, copies and sets on
the card (not a sum of self times, which counts overlap twice). A
kernel's launch is the CUDA runtime or driver event of the same
correlation id; a kernel belongs to a benchmark range (`bench.*`) when its
launch lies inside one on the same host thread. The slice's wall time runs
from the start of its first `bench.unit` range (without host tracing: its
first device interval) to the end of its last device interval.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNIT = "bench.unit"


class Slice:
    """Starts and stops the profiler around a fixed run of units: with
    `cpu`, host ops and the benchmark's ranges too (their cost lengthens
    the host's side of each unit), else the card's activity alone. It
    starts without a synchronize, so the host keeps its lead over the
    card; the kernels recorded are those launched from the slice's first
    unit on. The trace is read after the window (`finish`)."""

    def __init__(self, first: int, count: int, cpu: bool):
        self.first, self.count, self.cpu = first, count, cpu
        self.prof = None
        self.path: Optional[str] = None
        self.trace: Optional["Trace"] = None

    @property
    def end(self) -> int:
        return self.first + self.count

    def covers(self, unit: int) -> bool:
        return self.first <= unit < self.end

    def before(self, unit: int) -> None:
        if unit == self.first:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CUDA]
            if self.cpu:
                acts.append(ProfilerActivity.CPU)
            self.prof = profile(activities=acts)
            self.prof.start()

    def after(self, unit: int) -> None:
        """At the slice's end: stop and write the trace out (a later
        profiler session would clear this one's events)."""
        if unit == self.end - 1 and self.prof is not None:
            torch.cuda.synchronize()
            self.prof.stop()
            fd, self.path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            self.prof.export_chrome_trace(self.path)
            self.prof = None

    def finish(self) -> Optional["Trace"]:
        """Reads the written trace (after the window)."""
        if self.path is not None and self.trace is None:
            try:
                with open(self.path) as f:
                    self.trace = Trace(json.load(f), self.count)
            finally:
                os.remove(self.path)
        return self.trace


def slices(traffic) -> list:
    """The traced run's two slices: the card alone (`trace_slice`), then
    the card with the host (`host_trace_slice`)."""
    return [Slice(*traffic["trace_slice"], cpu=False),
            Slice(*traffic["host_trace_slice"], cpu=True)]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    def __init__(self, chrome: Dict, units: int):
        events = (chrome.get("traceEvents", chrome)
                  if isinstance(chrome, dict) else chrome)
        self.units = units
        self.kernels = []      # (name, start_us, end_us, correlation)
        self.cpu_ops = []      # (name, start_us, end_us, tid)
        self.ranges = []       # (name, start_us, end_us, tid)
        self.launch = {}       # correlation -> (ts_us, tid)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.kernels.append((e.get("name", ""), ts, ts + dur,
                                     (e.get("args") or {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.ranges.append((e.get("name", ""), ts, ts + dur,
                                    e.get("tid")))
            elif cat == "cpu_op":
                self.cpu_ops.append((e.get("name", ""), ts, ts + dur,
                                     e.get("tid")))
        units_r = [r for r in self.ranges if r[0] == UNIT]
        first = min((k[1] for k in self.kernels), default=0.0)
        self.start = min((r[1] for r in units_r), default=first)
        self.end = max((k[2] for k in self.kernels), default=self.start)
        self.busy = union([(a, b) for _, a, b, _ in self.kernels
                           if b > self.start])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(min(b, self.end) - max(a, self.start)
                   for a, b in self.busy if b > self.start) / 1e6

    def device_s(self, match) -> float:
        """Union of the device intervals whose name `match` accepts."""
        return sum(b - a for a, b in union(
            [(a, b) for n, a, b, _ in self.kernels if match(n)])) / 1e6

    def device_s_under(self, range_name: str) -> Optional[float]:
        """Device time of the kernels launched inside `range_name` ranges;
        None when the slice holds no such range."""
        rs = [(a, b, tid) for n, a, b, tid in self.ranges if n == range_name]
        if not rs:
            return None
        picked = []
        for name, a, b, corr in self.kernels:
            at = self.launch.get(corr)
            if at is None:
                continue
            ts, tid = at
            if any(r0 <= ts <= r1 and t == tid for r0, r1, t in rs):
                picked.append((a, b))
        return sum(b - a for a, b in union(picked)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for name, a, b, _ in self.kernels:
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between device intervals in the slice, each
        named by the innermost host op or benchmark range, on any host
        thread, that was running at the gap's start."""
        gaps = []
        prev_end = self.start
        for a, b in self.busy:
            if a > prev_end:
                gaps.append((a - prev_end, prev_end, a))
            prev_end = max(prev_end, b)
        gaps.sort(reverse=True)
        host = sorted(self.cpu_ops + self.ranges, key=lambda r: r[1])
        starts = [r[1] for r in host]
        out = []
        for length, g0, g1 in gaps[:n]:
            k = bisect.bisect_right(starts, g0)
            label, best = "host: none", None
            for name, a, b, _ in host[:k]:
                if a <= g0 < b and (best is None or b - a < best):
                    label, best = name, b - a
            out.append([label, length / 1e6])
        return out
