"""Profiling and timing harness (counterpart of `utils/profiling.py`).

`trace(log_dir)` captures a `torch.profiler` trace around arbitrary code;
`StepTimer` reports steady-state step times, waiting for the card
(`torch.cuda.synchronize`) where the JAX harness fetches a value to the
host; `StepTraceWindow` is `--profile_dir` of the training loops: a trace
over steps [start, start + n) of the loop, closed safely when the loop ends
inside the window. CUDA activity is recorded when the run is on the card.
A trace is written by rank 0 only, as a Chrome trace
(`trace_rank0.json`, readable by Perfetto and `chrome://tracing`) in
`log_dir`, where the JAX package writes a TensorBoard profile.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

TRACE_NAME = "trace_rank0.json"


def _activities(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _sync(value=None) -> None:
    """Wait for the card (the counterpart of fetching `value` to the
    host); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _export(prof, log_dir: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Capture a torch.profiler trace of the block into `log_dir` (CUDA
    activity too when a card is present, unless `cuda` says otherwise)."""
    cuda = torch.cuda.is_available() if cuda is None else cuda
    prof = torch.profiler.profile(activities=_activities(cuda))
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        if _rank0():
            _export(prof, log_dir)


class StepTimer:
    """Wall-clock timer for steps with warmup, waiting for the card after
    each call."""

    def __init__(self, warmup: int = 5):
        self.warmup = warmup
        self.times = []

    def measure(self, fn: Callable, *args, iters: int = 20,
                sync_value: Optional[Callable] = None):
        """fn(*args) -> output; `sync_value(output)` names what the step
        must have finished (its wait is for the whole card)."""
        out = None
        for _ in range(self.warmup):
            out = fn(*args)
            _sync(sync_value(out) if sync_value else out)
        self.times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(sync_value(out) if sync_value else out)
            self.times.append(time.perf_counter() - t0)
        return out

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.times) * 1000)

    @property
    def p50_ms(self) -> float:
        return float(np.median(self.times) * 1000)


class StepTraceWindow:
    """--profile_dir support for training loops: a torch.profiler trace
    over steps [start, start+n) relative to the loop's first step, closed
    safely when the loop ends inside the window. Only rank 0 traces."""

    def __init__(self, log_dir: Optional[str], start: int = 2, n: int = 3,
                 cuda: bool = False):
        self.log_dir = log_dir if _rank0() else None
        self.start, self.end = start, start + n - 1
        self.cuda = cuda
        self.active = False
        self._prof = None

    def before_step(self, rel_step: int):
        if self.log_dir and rel_step == self.start and not self.active:
            self._prof = torch.profiler.profile(
                activities=_activities(self.cuda))
            self._prof.start()
            self.active = True

    def after_step(self, rel_step: int, sync=None) -> bool:
        """Returns True when the trace was just closed."""
        if self.active and rel_step >= self.end:
            self.close(sync)
            return True
        return False

    def close(self, sync=None):
        if self.active:
            _sync(sync)
            self._prof.stop()
            _export(self._prof, self.log_dir)
            self._prof = None
            self.active = False
