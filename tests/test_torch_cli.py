"""The eval CLI's checkpoint sweeps (`--eval_all_checkpoints`,
`--iters_to_eval`) and the example cache (`--use_cached`,
`--overwrite_cache`) of the port, against the JAX package's rules: the
sweep's root, tags and output file names, results equal to evaluating each
checkpoint alone; the cache's path (the JAX package's name with
`_torch.pkl`), what is read and rewritten, and that a JAX-named cache is
never opened. The multimodal CLIP path through both CLIs: its config and
tower config equal the JAX package's, a tiny `--multimodal` run trains,
checkpoints and evaluates on the CPU, and a ViT the encoder cannot take
raises."""

import json
import os
import pickle
import shutil

import jax  # noqa: F401  (both frameworks load in one test process)
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu_torch.train import cli as tcli

from test_torch_train import MAX_LEN, _eval_argv, _train_argv  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run_dir(wikihow_dir, tmp_path_factory):
    """A tiny port run with checkpoint-2 and checkpoint-4."""
    out = tmp_path_factory.mktemp("sweep") / "run"
    tcli.main_train(_train_argv(wikihow_dir, out, "--max_steps", "4",
                                "--save_steps", "2", "--overwrite_output_dir"))
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4", "logs"]
    return out


def _eval(wikihow_dir, out, *extra):
    return tcli.main_eval(_eval_argv(wikihow_dir, out, "simple", *extra))


@pytest.mark.parametrize("how", [["--eval_all_checkpoints"],
                                 ["--iters_to_eval", "2", "4"],
                                 ["--iters_to_eval", "4", "--iters_to_eval",
                                  "2"]])
def test_sweep_equals_each_checkpoint_alone(wikihow_dir, run_dir, tmp_path,
                                            how):
    out = tmp_path / "sweep"
    got = _eval(wikihow_dir, out, "--model_name_or_path_1", str(run_dir), *how)
    assert sorted(got) == ["checkpoint-2", "checkpoint-4"]
    for tag in got:
        alone = _eval(wikihow_dir, tmp_path / tag, "--model_name_or_path_1",
                      str(run_dir / tag))
        assert got[tag] == alone
        # each split is written as {split}_{tag}
        assert (out / f"eval_results_split_dev_{tag}.txt").read_text() == (
            tmp_path / tag / "eval_results_split_dev.txt").read_text()
    assert not (out / "eval_results_split_dev.txt").exists()
    assert (out / "output_order.txt").read_text() == (
        tmp_path / "checkpoint-4" / "output_order.txt").read_text()


def test_sweep_of_one_checkpoint_is_not_tagged(wikihow_dir, run_dir, tmp_path):
    got = _eval(wikihow_dir, tmp_path, "--model_name_or_path_1", str(run_dir),
                "--iters_to_eval", "4")
    assert sorted(got) == ["dev"]
    assert (tmp_path / "eval_results_split_dev.txt").is_file()
    assert got == _eval(wikihow_dir, tmp_path / "alone",
                        "--model_name_or_path_1", str(run_dir / "checkpoint-4"))


def test_sweep_root_falls_back_to_the_output_dir(wikihow_dir, run_dir,
                                                 tmp_path):
    out = tmp_path / "run"
    shutil.copytree(run_dir, out)
    # no --model_name_or_path_1, and --model_name_or_path is no directory
    got = _eval(wikihow_dir, out, "--eval_all_checkpoints")
    assert sorted(got) == ["checkpoint-2", "checkpoint-4"]
    assert (out / "eval_results_split_dev_checkpoint-2.txt").is_file()
    # nothing found: the base model alone (a fresh init), as in JAX
    empty = tmp_path / "empty"
    assert sorted(_eval(wikihow_dir, empty, "--eval_all_checkpoints")) == [
        "dev"]


def _data_copy(wikihow_dir, tmp_path):
    data = tmp_path / "data"
    shutil.copytree(wikihow_dir, data)
    return str(data)


def _cache_args(data_dir, *extra):
    return tcli.parse_args("eval", _eval_argv(data_dir, "out", "simple",
                                              "--use_cached", *extra))


def test_cache_path_is_the_jax_name_with_torch_suffix(wikihow_dir, tmp_path):
    data = _data_copy(wikihow_dir, tmp_path)
    args = _cache_args(data)
    at = _eval_argv(data, "out", "simple").index("--device")
    argv = _eval_argv(data, "out", "simple", "--use_cached")
    jargs = jcli.build_parser("eval").parse_args(argv[:at] + argv[at + 2:])
    before = set(os.listdir(data))
    jcli.load_examples(jargs, "wikihow", "sort", "dev")
    (jax_name,) = [n for n in set(os.listdir(data)) - before
                   if n.startswith("cached_")]
    assert jax_name == f"cached_dev_simple_{MAX_LEN}_wikihow_sort.pkl"
    path = tcli.example_cache_path(args, "wikihow", "sort", "dev")
    assert os.path.dirname(path) == data
    assert os.path.basename(path) == jax_name[:-len(".pkl")] + "_torch.pkl"


def test_cache_write_read_and_overwrite(wikihow_dir, tmp_path):
    data = _data_copy(wikihow_dir, tmp_path)
    plain = tcli.load_examples(tcli.parse_args("eval", _eval_argv(
        data, "out", "simple")), "wikihow", "sort", "dev")
    # no cache file without --use_cached (the loader logs the split's
    # missing step images, as the JAX package's does)
    assert (set(os.listdir(data)) - set(os.listdir(wikihow_dir))
            <= {"missing_images_dev.txt"})
    args = _cache_args(data)
    path = tcli.example_cache_path(args, "wikihow", "sort", "dev")
    first = tcli.load_examples(args, "wikihow", "sort", "dev")
    assert os.path.isfile(path) and first == plain
    # a read gives back what was written, from the file
    with open(path, "wb") as f:
        pickle.dump(plain[:1], f)
    assert tcli.load_examples(args, "wikihow", "sort", "dev") == plain[:1]
    # --overwrite_cache reads the data again and rewrites the file
    again = tcli.load_examples(_cache_args(data, "--overwrite_cache"),
                               "wikihow", "sort", "dev")
    assert again == plain
    with open(path, "rb") as f:
        assert pickle.load(f) == plain


def test_jax_named_cache_is_never_opened(wikihow_dir, tmp_path):
    data = _data_copy(wikihow_dir, tmp_path)
    args = _cache_args(data)
    port_path = tcli.example_cache_path(args, "wikihow", "sort", "dev")
    jax_path = port_path[:-len("_torch.pkl")] + ".pkl"
    with open(jax_path, "wb") as f:  # unpickling this would raise
        f.write(b"not a pickle")
    got = tcli.load_examples(args, "wikihow", "sort", "dev")
    assert got and os.path.isfile(port_path)
    with open(jax_path, "rb") as f:
        assert f.read().startswith(b"not a pickle")
    # the whole eval CLI with the cache on
    res = tcli.main_eval(_eval_argv(data, str(tmp_path / "out"), "simple",
                                    "--use_cached"))
    assert sorted(res) == ["dev"]


# ----- the multimodal CLIP path ----------------------------------------------


def _mm_flags(clip):
    return ["--multimodal", "--clip_model_name", clip,
            "--vision_image_size", "32"]


@pytest.mark.parametrize("clip", ["RN50", "ViT-B/32"])
def test_multimodal_config_matches_jax(wikihow_dir, tmp_path, clip):
    argv = _train_argv(wikihow_dir, tmp_path, *_mm_flags(clip),
                       "--clip_ref_fold_quirk", "--freeze_vision_model")
    at = argv.index("--device")  # the JAX parser has no --device
    jargs = jcli.resolve_args(jcli.build_parser("train").parse_args(
        argv[:at] + argv[at + 2:]))
    targs = tcli.parse_args("train", argv)
    jc, tc = jcli.build_config(jargs)[0], tcli.build_config(targs)[0]
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    jv, tv = jcli._vision_cfg(jc, jargs), tcli.vision_config(tc, targs)
    assert json.loads(tv.to_json()) == {k: list(v) if isinstance(v, tuple)
                                        else v for k, v in vars(jv).items()}
    assert tv.ref_fold_quirk and tv.image_resolution == 32
    assert tcli.dataset_kwargs(targs)["uint8_images"]


@pytest.mark.parametrize("clip", ["RN50", "ViT-B/32"])
def test_multimodal_train_checkpoint_eval_on_cpu(wikihow_dir, tmp_path, clip):
    out = tmp_path / "run"
    res = tcli.main_train(_train_argv(wikihow_dir, out, *_mm_flags(clip),
                                      "--max_steps", "2", "--save_steps", "0",
                                      "--overwrite_output_dir"))
    assert res.global_step == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    ckpt = out / "checkpoint-2"
    saved = json.loads((ckpt / "vision_config.json").read_text())
    assert saved["model_name"] == clip and saved["image_resolution"] == 32
    assert json.loads((ckpt / "config.json").read_text())["multimodal"]
    for decode in ([], ["--device_decode"]):  # host and device decode
        ev = tmp_path / f"eval{len(decode)}"
        res = tcli.main_eval(_eval_argv(wikihow_dir, ev, str(ckpt),
                                        *_mm_flags(clip), *decode))
        assert 0.0 <= res["dev"]["partial_match"] <= 1.0
        orders = (ev / "output_order.txt").read_text().split("\n")[:-1]
        assert len(orders) == 2  # the dev split's 2 stories
        assert all(sorted(map(int, o.split())) == list(range(5))
                   for o in orders)
    # the checkpoint's BatchNorm statistics moved from their init
    sd = torch.load(ckpt / "model.pt", weights_only=True)
    var = [v for k, v in sd.items() if k.endswith("running_var")]
    assert (clip == "RN50") == bool(var)
    assert all(not torch.equal(v, torch.ones_like(v)) for v in var)


def test_vit_wider_output_than_width_raises_in_the_cli(wikihow_dir, tmp_path):
    # ViT-B/32 at its published widths (768 wide, 512 out): the JAX encoder
    # fails on a broadcast; the port raises before building the tower
    argv = _train_argv(wikihow_dir, tmp_path, "--multimodal",
                       "--clip_model_name", "ViT-B/32", "--max_steps", "1")
    argv[argv.index("tiny")] = "base"
    with pytest.raises(ValueError, match="output_dim == vit_width"):
        tcli.main_train(argv)
