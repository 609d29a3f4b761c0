"""What the per-layer metric readers share: the context a run hands them
and the arithmetic over it. A reader returns None where its cell has
nothing for it to read."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .flops import PEAK_BF16_FLOP_PER_S
from .trace import Trace


@dataclass
class Context:
    kind: str                          # "train" or "eval"
    unit_seconds: List[float]          # device time between unit ends,
                                       # units outside the traced slice
    data_wait_s: List[float] = field(default_factory=list)
    host_step_s: List[float] = field(default_factory=list)
    flops_per_unit: float = 0.0        # valid stories' model operations
    attention_least_s_per_unit: float = 0.0
    trace: Optional[Trace] = None       # the card alone
    host_trace: Optional[Trace] = None  # the card and the host
    peak_bytes: int = 0
    has_tower: bool = False


def mean_ms(ctx: Context, kind: str, xs: List[float]) -> Optional[float]:
    if ctx.kind != kind or not xs:
        return None
    return 1e3 * sum(xs) / len(xs)


def mfu_pct(ctx: Context, kind: str) -> Optional[float]:
    if ctx.kind != kind or not ctx.unit_seconds:
        return None
    rate = ctx.flops_per_unit * len(ctx.unit_seconds) / sum(ctx.unit_seconds)
    return 100.0 * rate / PEAK_BF16_FLOP_PER_S


def tower_ms(ctx: Context, kind: str) -> Optional[float]:
    tr = ctx.host_trace
    if ctx.kind != kind or tr is None or not ctx.has_tower:
        return None
    s = tr.device_s_under("bench.tower_fwd")
    return None if s is None else 1e3 * s / tr.units


def attention_roofline_pct(ctx: Context, kind: str) -> Optional[float]:
    if ctx.kind != kind or ctx.trace is None:
        return None
    s = ctx.trace.device_s(lambda n: "flash_fwd" in n or "flash_bwd_" in n)
    if s <= 0:
        return None
    return 100.0 * ctx.attention_least_s_per_unit * ctx.trace.units / s


def device_ms(ctx: Context, kind: str, patterns) -> Optional[float]:
    if ctx.kind != kind or ctx.trace is None:
        return None
    s = ctx.trace.device_s(lambda n: any(p in n.lower() for p in patterns))
    return None if s <= 0 else 1e3 * s / ctx.trace.units


def idle_pct(ctx: Context, kind: str) -> Optional[float]:
    """The share of an untraced unit's time in which nothing runs on the
    card: the card-only slice's busy time a unit (kernel durations, which
    the profiler leaves as they are) against the mean time between unit
    ends outside the slices. The slice's own wall time is not used: the
    profiler's cost on every launch lengthens the host's side of each
    traced unit, and where the host paces the step that reads as idle."""
    if (ctx.kind != kind or ctx.trace is None or ctx.trace.busy_s <= 0
            or not ctx.unit_seconds):
        return None
    unit = sum(ctx.unit_seconds) / len(ctx.unit_seconds)
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.units / unit)
