"""The traced slice's arithmetic on a synthetic Chrome trace."""

import pytest

from benchmark.harness import readers
from benchmark.harness.trace import Trace, union


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    # host: a unit range 0-100 us, a tower range 10-30 us; two streams of
    # kernels that overlap between 20 and 30 us, then a gap 60-80 us while
    # the host sits in `aten::copy_`
    events = [
        _ev("user_annotation", "bench.unit", 0, 100),
        _ev("user_annotation", "bench.tower_fwd", 10, 20),
        _ev("cpu_op", "aten::copy_", 55, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=3),
        _ev("kernel", "conv_fprop", 10, 20, tid=7, corr=1),
        _ev("kernel", "flash_fwd_bf16_kernel", 20, 20, tid=8, corr=2),
        _ev("kernel", "multi_tensor_apply_kernel", 40, 20, tid=7, corr=3),
        _ev("gpu_memcpy", "Memcpy HtoD", 80, 20, tid=7),
        {"ph": "f", "cat": "ac2g", "ts": 0},
    ]
    return Trace({"traceEvents": events}, units=2)


def test_union_counts_overlap_once():
    assert union([(10, 30), (20, 40), (40, 60), (80, 100)]) == [
        (10, 60), (80, 100)]


def test_busy_window_and_idle_share():
    tr = _trace()
    # busy: 10-60 and 80-100 = 70 us of a 100 us window (from the unit's
    # start to the last device interval's end); a sum of kernel times
    # would count 80 us
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(70e-6)
    # 35 us busy a unit (two units) against untraced units of 40 and 60 us
    ctx = readers.Context(kind="train", unit_seconds=[40e-6, 60e-6],
                          trace=tr)
    assert readers.idle_pct(ctx, "train") == pytest.approx(30.0)
    assert readers.idle_pct(ctx, "eval") is None
    assert readers.idle_pct(readers.Context(kind="train", unit_seconds=[],
                                            trace=tr), "train") is None


def test_kernels_under_a_range_and_by_name():
    tr = _trace()
    # launched inside bench.tower_fwd (10-30 us): the conv and the flash
    # kernel, whose device intervals overlap: 10-40 us
    assert tr.device_s_under("bench.tower_fwd") == pytest.approx(30e-6)
    assert tr.device_s_under("bench.absent") is None
    assert tr.device_s(lambda n: "flash_fwd" in n) == pytest.approx(20e-6)
    ctx = readers.Context(kind="train", unit_seconds=[1.0], trace=tr,
                          host_trace=tr, has_tower=True)
    assert readers.tower_ms(ctx, "train") == pytest.approx(15e-3)
    assert readers.device_ms(ctx, "train", ("multi_tensor",)) == \
        pytest.approx(10e-3)
    # attention's least time of 5 us a unit against 20 us of flash kernels
    ctx.attention_least_s_per_unit = 5e-6
    assert readers.attention_roofline_pct(ctx, "train") == pytest.approx(50.0)


def test_breakdown_lists():
    tr = _trace()
    gaps = tr.idle_gaps()
    assert gaps[0][0] == "aten::copy_"
    assert gaps[0][1] == pytest.approx(20e-6)
    ops = dict(tr.top_ops())
    assert ops["conv_fprop"] == pytest.approx(20e-6)
    assert len(tr.top_ops(2)) == 2


def test_throughput_readers():
    ctx = readers.Context(kind="eval", unit_seconds=[0.5, 0.5],
                          flops_per_unit=989e12 * 0.1,
                          data_wait_s=[0.001, 0.003])
    # 0.1 s of peak work in each 0.5 s unit: 20 %
    assert readers.mfu_pct(ctx, "eval") == pytest.approx(20.0)
    assert readers.mfu_pct(ctx, "train") is None
    assert readers.mean_ms(ctx, "eval", ctx.data_wait_s) == pytest.approx(2.0)
