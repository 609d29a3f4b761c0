"""The port's twin of `tests/test_quality_gate.py::test_quality_heatmap`: a
tiny heat-map sequencer trained through the port's train CLI on the CPU,
on the same rank-coded synthetic articles, must recover the order of unseen
dev articles through the port's full eval harness (decode, metrics, output
files), with the host decode and with `--device_decode`, at the JAX gate's
thresholds (tau >= 0.9, partial match >= 0.9).

Run it with `pytest tests/test_torch_quality.py -m quality`; the root
conftest marks it `slow`, so Tier-1 leaves it out."""

import os

import pytest
import torch

from test_quality_gate import (_assert_quality, _common,  # noqa: F401
                               ordered_wikihow_dir)

pytestmark = pytest.mark.quality

torch.set_num_threads(1)

STEPS = 300


def _port(argv):
    return argv + ["--device", "cpu"]


def test_quality_heatmap(ordered_wikihow_dir, tmp_path):  # noqa: F811
    from multimodal_sequencing_tpu_torch.train.cli import main_eval, main_train
    out = str(tmp_path)
    main_train(_port(_common(ordered_wikihow_dir, out) + [
        "--do_train", "--task_name", "wikihow_hl_v1", "--max_steps",
        str(STEPS), "--save_steps", str(STEPS), "--num_train_epochs", "100",
        "--overwrite_output_dir", "--hierarchical_version", "v1"]))
    ckpt = os.path.join(out, f"checkpoint-{STEPS}")
    for extra in ([], ["--device_decode"]):
        res = main_eval(_port(_common(ordered_wikihow_dir, out) + [
            "--task_name", "wikihow_sort", "--sort_method", "heat_map",
            "--eval_splits", "dev", "--model_name_or_path_1", ckpt,
            "--hierarchical_version", "v1", *extra]))
        _assert_quality(res["dev"], out)
