"""The port's twins of `tests/test_quality_gate.py::test_quality_heatmap`
and `::test_quality_pretrain_mlm_perplexity`: a tiny heat-map sequencer
trained through the port's train CLI on the CPU, on the same rank-coded
synthetic articles, must recover the order of unseen dev articles through
the port's full eval harness (decode, metrics, output files), with the host
decode and with `--device_decode`, at the JAX gate's thresholds (tau >=
0.9, partial match >= 0.9); and 100 steps of the port's pretraining CLI
must bring the masked-LM perplexity of the held-out articles below the JAX
gate's 50.

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


def test_quality_pretrain_mlm_perplexity(ordered_wikihow_dir,  # noqa: F811
                                         tmp_path):
    import numpy as np
    from multimodal_sequencing_tpu_torch.train.cli import main_pretrain
    out = str(tmp_path)
    main_pretrain(_port(_common(ordered_wikihow_dir, out) + [
        "--do_train", "--do_eval", "--task_name", "wikihow_pretrain",
        "--max_steps", "100", "--save_steps", "0",
        "--num_train_epochs", "100", "--overwrite_output_dir"]))
    res = {}
    with open(os.path.join(out, "eval_results_pretrain.txt")) as f:
        for line in f:
            k, _, v = line.strip().partition(" = ")
            res[k] = float(v)
    assert res["eval_perplexity"] < 50.0, res
    assert np.isfinite(res["eval_mlm"]), res
