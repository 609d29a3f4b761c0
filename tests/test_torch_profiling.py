"""The port's profiling harness (`utils/profiling.py`, counterpart of the
JAX package's): the step window of `--profile_dir`, `StepTimer`, `trace`,
and `--profile_dir` through the train and pretrain CLIs (JAX
`tests/test_cli_e2e.py:514-525`), whose Chrome trace holds the step's
operations."""

import json
import os

import jax  # noqa: F401  (the JAX package's platform set-up)
import pytest
import torch

from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.utils.profiling import (
    TRACE_NAME, StepTimer, StepTraceWindow, trace)

torch.set_num_threads(1)


def _events(log_dir):
    with open(os.path.join(log_dir, TRACE_NAME)) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


@pytest.mark.parametrize("n_steps,closed_at", [(10, 4), (4, None)])
def test_step_window_traces_steps_two_to_four(tmp_path, n_steps, closed_at):
    win = StepTraceWindow(str(tmp_path))
    x = torch.ones(8, 8)
    closed = []
    for step in range(n_steps):
        win.before_step(step)
        assert win.active == (2 <= step <= 4)
        with torch.profiler.record_function(f"step_{step}"):
            x = x @ x / 8
        if win.after_step(step, sync=x):
            closed.append(step)
    assert closed == ([closed_at] if closed_at is not None else [])
    assert win.active == (closed_at is None)
    win.close()  # the loop ended inside the window
    assert not win.active
    names = _events(tmp_path)
    assert {f"step_{s}" for s in range(2, min(5, n_steps))} <= set(names)
    assert "step_1" not in names and "step_5" not in names


def test_step_window_without_a_dir_traces_nothing(tmp_path):
    win = StepTraceWindow(None)
    for step in range(6):
        win.before_step(step)
        assert not win.active
        assert not win.after_step(step)
    win.close()


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer(warmup=2)
    x = torch.ones(16, 16)
    out = timer.measure(lambda a: a @ a, x, iters=5)
    assert torch.equal(out, x @ x)
    assert len(timer.times) == 5 and timer.mean_ms > 0 and timer.p50_ms > 0
    with trace(str(tmp_path)):
        with torch.profiler.record_function("traced_block"):
            x @ x
    assert "traced_block" in _events(tmp_path)


def test_profile_dir_through_the_train_cli(wikihow_dir, tmp_path):
    trace_dir = str(tmp_path / "trace")
    res = tcli.main_train([
        "--model_name_or_path", "simple", "--model_size", "tiny",
        "--do_train", "--task_name", "wikihow_hl_v1",
        "--hierarchical_version", "v1", "--data_dir", wikihow_dir,
        "--max_seq_length", "96", "--per_seq_max_length", "12",
        "--per_gpu_train_batch_size", "2", "--max_steps", "6",
        "--save_steps", "0", "--profile_dir", trace_dir, "--seed", "0",
        "--output_dir", str(tmp_path / "out"), "--overwrite_output_dir",
        "--device", "cpu"])
    assert res.global_step == 6
    names = set(_events(trace_dir))
    # the step's operations: products, the attention's softmax, the
    # optimizer's foreach updates
    assert {"aten::linear", "aten::softmax"} <= names
    assert any(n.startswith("aten::_foreach") for n in names)


def test_profile_dir_through_the_pretrain_cli_ends_inside_the_window(
        wikihow_dir, tmp_path):
    trace_dir = str(tmp_path / "trace")
    res = tcli.main_pretrain([
        "--model_name_or_path", "simple", "--model_size", "tiny",
        "--do_train", "--data_dirs", wikihow_dir, "--data_names", "wikihow",
        "--max_seq_length", "60", "--per_seq_max_length", "12",
        "--per_gpu_train_batch_size", "2", "--max_steps", "4",
        "--save_steps", "0", "--profile_dir", trace_dir,
        "--output_dir", str(tmp_path / "out"), "--overwrite_output_dir",
        "--device", "cpu"])
    assert res.global_step == 4
    assert "aten::linear" in set(_events(trace_dir))
