"""The port's CLIs across ranks: `main_train` (the sequencer and BERSON)
and `main_pretrain` with `--num_cpu_devices` (gloo ranks on the CPU,
spawned by the CLI), as the JAX package's `tests/test_cli_e2e.py:472-512`
drives its virtual CPU mesh. Each run is held against the single-process
run of the same global batch: its logged losses (1e-5 relative), its eval
metrics, and a checkpoint that the single-process eval reads to the same
metrics. The layouts JAX refuses raise JAX's errors."""

import contextlib
import json
import os
import signal

import jax  # noqa: F401  (the JAX package's platform set-up)
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu_torch.train import cli as tcli

torch.set_num_threads(1)

# a run of ranks that hangs fails its test after this many seconds (the
# CLI's polling loop is interrupted, and it stops the ranks)
SPAWN_TIMEOUT_S = 300


@contextlib.contextmanager
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"ranks ran past {SPAWN_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(SPAWN_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _spawn_timeout():
    with _deadline():
        yield


def _train_argv(data, out, batch, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", data, "--max_seq_length", "96",
            "--per_seq_max_length", "12", "--per_gpu_train_batch_size",
            str(batch), "--per_gpu_eval_batch_size", "2",
            "--learning_rate", "1e-3", "--warmup_steps", "1",
            "--logging_steps", "1", "--seed", "0", "--eval_splits", "dev",
            "--output_dir", str(out), "--overwrite_output_dir",
            "--device", "cpu", *extra]


def _berson_argv(data, out, batch, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--do_train", "--task_name", "wikihow_hl_v1",
            "--wrapper_model_type", "berson", "--beam_size", "2",
            "--data_dir", data, "--max_seq_length", "64",
            "--per_seq_max_length", "8", "--per_gpu_train_batch_size",
            str(batch), "--per_gpu_eval_batch_size", "2",
            "--learning_rate", "1e-3", "--warmup_steps", "1",
            "--logging_steps", "1", "--seed", "0", "--eval_splits", "dev",
            "--additional_wrapper_level_objectives", "time_contrastive",
            "--output_dir", str(out), "--overwrite_output_dir",
            "--device", "cpu", *extra]


def _pretrain_argv(data, out, batch, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--do_train", "--do_eval", "--data_dirs", data,
            "--data_names", "wikihow", "--max_seq_length", "60",
            "--per_seq_max_length", "12", "--per_gpu_train_batch_size",
            str(batch), "--per_gpu_eval_batch_size", "2",
            "--learning_rate", "1e-3", "--warmup_steps", "1",
            "--logging_steps", "1", "--seed", "0", "--max_steps", "3",
            "--save_steps", "0", "--eval_splits", "dev",
            "--multimodal_pretrain_objectives", "margin_loss",
            "time_contrastive", "swapping_based_nsp",
            "--output_dir", str(out), "--overwrite_output_dir",
            "--device", "cpu", *extra]


def _losses(res):
    return [h["loss"] for h in res.history]


def _scalars(out):
    with open(os.path.join(out, "logs", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def tp_sp_fsdp_run(wikihow_dir, tmp_path_factory):
    """4 ranks as 2 data x 2 model with TP + SP + FSDP, 3 steps of 2
    stories a data rank (the second batch the final partial one), a save
    at step 2, then --do_eval; and the single-process run of batch 4."""
    par_out = tmp_path_factory.mktemp("par")
    one_out = tmp_path_factory.mktemp("one")
    extra = ["--max_steps", "3", "--save_steps", "2", "--do_eval"]
    with _deadline():
        par = tcli.main_train(_train_argv(
            wikihow_dir, par_out, 2, *extra, "--num_cpu_devices", "4",
            "--model_parallel_size", "2", "--sequence_parallel", "--fsdp"))
    one = tcli.main_train(_train_argv(wikihow_dir, one_out, 4, *extra))
    return par, one, par_out, one_out


def test_train_tp_sp_fsdp_follows_one_process(tp_sp_fsdp_run):
    par, one, par_out, one_out = tp_sp_fsdp_run
    assert par.model is None and par.global_step == one.global_step == 3
    np.testing.assert_allclose(_losses(par), _losses(one), rtol=1e-5)
    # rank 0 alone writes the log
    assert len(_scalars(par_out)) == len(_scalars(one_out))


def test_train_tp_sp_fsdp_checkpoints_match_one_process(tp_sp_fsdp_run):
    _, _, par_out, one_out = tp_sp_fsdp_run
    for name in ("checkpoint-2", "checkpoint-3"):
        got = torch.load(os.path.join(par_out, name, "model.pt"))
        want = torch.load(os.path.join(one_out, name, "model.pt"))
        assert set(got) == set(want)
        steps = int(name.split("-")[1])
        for k in want:
            assert got[k].shape == want[k].shape
            # the attention key biases' gradient is zero but for rounding
            # (softmax is invariant to a shift of a row's scores), which
            # Adam turns into steps of up to lr either way
            atol = 2 * steps * 1e-3 if k.endswith("key.bias") else 2e-5
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=atol, err_msg=k)
        opt = torch.load(os.path.join(par_out, name, "optimizer.pt"))
        assert opt["step"] == int(name.split("-")[1])
        assert set(opt["optimizer"]["mu"]) == set(want)


def _eval_cli(wikihow_dir, ckpt, out):
    return tcli.main_eval([
        "--model_name_or_path", str(ckpt), "--model_size", "tiny",
        "--task_name", "wikihow_sort", "--sort_method", "heat_map",
        "--hierarchical_version", "v1", "--data_dir", wikihow_dir,
        "--max_seq_length", "96", "--per_seq_max_length", "12",
        "--per_gpu_eval_batch_size", "2", "--eval_splits", "dev",
        # the train run's seed: the dev stories' scramble follows it
        "--seed", "0", "--output_dir", str(out), "--device", "cpu"])["dev"]


def test_train_tp_sp_fsdp_eval_matches_one_process(tp_sp_fsdp_run,
                                                   wikihow_dir, tmp_path):
    # the run's own eval (on every rank, rank 0 reporting) against the
    # single-process run's, and the single-process eval CLI on the
    # checkpoints of both runs, which gives the run's own eval
    par, one, par_out, one_out = tp_sp_fsdp_run
    assert set(par.eval_results) == {"checkpoint-2", "checkpoint-3"}
    metrics = ("partial_match", "exact_match", "tau")
    for name, res in par.eval_results.items():
        for metric in metrics:
            assert res[metric] == pytest.approx(
                one.eval_results[name][metric])
        got = _eval_cli(wikihow_dir, par_out / name, tmp_path / "par")
        want = _eval_cli(wikihow_dir, one_out / name, tmp_path / "one")
        for metric in metrics:
            assert got[metric] == pytest.approx(want[metric])
            assert got[metric] == pytest.approx(res[metric])
    with open(tmp_path / "par" / "output_order.txt") as f, \
            open(tmp_path / "one" / "output_order.txt") as g:
        assert f.read() == g.read()


def test_berson_tp_sp_fsdp_follows_one_process(wikihow_dir, tmp_path):
    extra = ["--max_steps", "2", "--save_steps", "0"]
    par = tcli.main_train(_berson_argv(
        wikihow_dir, tmp_path / "par", 1, *extra, "--num_cpu_devices", "4",
        "--model_parallel_size", "2", "--sequence_parallel", "--fsdp"))
    one = tcli.main_train(_berson_argv(wikihow_dir, tmp_path / "one", 2,
                                       *extra))
    assert par.global_step == one.global_step == 2
    np.testing.assert_allclose(_losses(par), _losses(one), rtol=1e-5)


def test_pretrain_data_parallel_follows_one_process(wikihow_dir, tmp_path):
    par = tcli.main_pretrain(_pretrain_argv(
        wikihow_dir, tmp_path / "par", 2, "--num_cpu_devices", "2"))
    one = tcli.main_pretrain(_pretrain_argv(wikihow_dir, tmp_path / "one", 4))
    assert par.global_step == one.global_step == 3
    for a, b in zip(par.history, one.history):
        assert set(a) == set(b)
        for k in a:
            if k not in ("time", "steps_per_sec"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           err_msg=k)
    assert par.eval_results == pytest.approx(one.eval_results, rel=1e-6)
    assert (tmp_path / "par" / "eval_results_pretrain.txt").exists()


@pytest.mark.parametrize("argv,error,match", [
    (["--pipeline_parallel_size", "2", "--model_parallel_size", "2"],
     ValueError, "mutually exclusive"),
    (["--pipeline_parallel_size", "2", "--sequence_parallel"],
     ValueError, "mutually exclusive"),
    (["--pipeline_parallel_size", "2", "--wrapper_model_type", "berson",
      "--model_parallel_size", "2"], NotImplementedError, "pick one"),
    (["--pipeline_parallel_size", "2", "--wrapper_model_type", "berson",
      "--sequence_parallel"], NotImplementedError, "pipelined BERSON"),
    # one process cannot hold a pipeline of two stages (JAX's mesh error)
    (["--pipeline_parallel_size", "2"], ValueError, "does not fit 1 devices"),
    (["--model_parallel_size", "2"], ValueError, "does not fit 1 devices"),
])
def test_layouts_jax_refuses_raise_its_errors(wikihow_dir, tmp_path, argv,
                                              error, match):
    with pytest.raises(error, match=match):
        tcli.main_train(_train_argv(wikihow_dir, tmp_path, 2, "--max_steps",
                                    "1", *argv))


def test_train_pipeline_follows_one_process(wikihow_dir, tmp_path):
    # tests/test_cli_e2e.py's pipelined fine-tune on four gloo ranks (2 data
    # x 2 stages), with FSDP and a save and eval at step 2, against the
    # single-process run of the same global batch
    extra = ["--max_steps", "2", "--save_steps", "2", "--do_eval",
             "--pipeline_microbatches", "2"]
    par = tcli.main_train(_train_argv(
        wikihow_dir, tmp_path / "par", 2, *extra, "--num_cpu_devices", "4",
        "--pipeline_parallel_size", "2", "--fsdp"))
    one = tcli.main_train(_train_argv(wikihow_dir, tmp_path / "one", 4,
                                      *extra))
    assert par.global_step == one.global_step == 2
    np.testing.assert_allclose(_losses(par), _losses(one), rtol=1e-5)
    got = torch.load(tmp_path / "par" / "checkpoint-2" / "model.pt")
    want = torch.load(tmp_path / "one" / "checkpoint-2" / "model.pt")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    for metric in ("partial_match", "exact_match", "tau"):
        assert par.eval_results["checkpoint-2"][metric] == pytest.approx(
            one.eval_results["checkpoint-2"][metric])


def test_berson_pipeline_follows_one_process(wikihow_dir, tmp_path):
    # tests/test_cli_e2e.py's pipelined BERSON on four gloo ranks
    extra = ["--max_steps", "2", "--save_steps", "0",
             "--pipeline_microbatches", "2"]
    par = tcli.main_train(_berson_argv(
        wikihow_dir, tmp_path / "par", 2, *extra, "--num_cpu_devices", "4",
        "--pipeline_parallel_size", "2"))
    one = tcli.main_train(_berson_argv(wikihow_dir, tmp_path / "one", 4,
                                       *extra))
    assert par.global_step == one.global_step == 2
    np.testing.assert_allclose(_losses(par), _losses(one), rtol=1e-5)


def test_pretraining_refuses_the_pipeline(wikihow_dir, tmp_path):
    with pytest.raises(NotImplementedError, match="pretraining trains"):
        tcli.main_pretrain(_pretrain_argv(wikihow_dir, tmp_path, 2,
                                          "--pipeline_parallel_size", "2"))
