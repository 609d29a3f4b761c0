"""The port's pretraining CLI on the CPU (`main_pretrain`, `--device cpu`),
tiny: two `--data_dirs` / `--data_names` pairs with a save, a dev eval and
`--do_eval` (checkpoints, `logs/scalars.jsonl`,
`eval_results_pretrain.txt`); the flags of the reference launchers
`scripts/wikihow_pretrain.sh` and `scripts/wikihow_image_only_pretrain.sh`
(parsed as the JAX package parses them, then run with `--model_size tiny`
and the built-in tokenizer), the image-only checkpoint's tower loaded
bit-equal by a fine-tune run's `--clip_visual_model_weights`; and the
configurations of later slices, which raise."""

import json
import os
import re
import shlex
import shutil

import jax  # noqa: F401 (the JAX package's parser is held against)
import pytest
import torch

from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu_torch.models.config import (
    CLIPVisionConfig, MultimodalConfig)
from multimodal_sequencing_tpu_torch.models.convert import (
    load_pretrained_weights)
from multimodal_sequencing_tpu_torch.models.sequencer import (
    SequencingModel, init_weights)
from multimodal_sequencing_tpu_torch.train import cli as tcli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(out, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--do_train", "--max_seq_length", "60",
            "--per_seq_max_length", "12", "--per_gpu_train_batch_size", "4",
            "--per_gpu_eval_batch_size", "2", "--learning_rate", "1e-3",
            "--warmup_steps", "1", "--logging_steps", "1", "--seed", "0",
            "--output_dir", str(out), "--device", "cpu", *extra]


def _scalars(out):
    with open(os.path.join(str(out), "logs", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _results(path):
    with open(path) as f:
        return {k: float(v) for k, _, v in
                (line.strip().partition(" = ") for line in f)}


def test_pretrain_cli_two_data_pairs(wikihow_dir, tmp_path, monkeypatch):
    # the text configuration of chip_smoke's second pretraining run, over
    # the stories of two data directories: 12 train stories, checkpoints
    # at steps 2 and 4 with a dev eval each, then --do_eval
    second = str(tmp_path / "second")
    shutil.copytree(wikihow_dir, second)
    calls = []
    real = tcli.load_examples

    def load(args, data_name, task_type, split):
        out = real(args, data_name, task_type, split)
        calls.append((args.data_dir, data_name, task_type, split, len(out)))
        return out

    monkeypatch.setattr(tcli, "load_examples", load)
    out = tmp_path / "run"
    objectives = ["margin_loss", "time_contrastive", "swapping_based_nsp",
                  "sequence_based_nsp"]
    res = tcli.main_pretrain(_argv(
        out, "--data_dirs", wikihow_dir, second, "--data_names", "wikihow",
        "wikihow", "--max_steps", "4", "--save_steps", "2",
        "--evaluate_during_training", "--do_eval", "--eval_splits", "dev",
        "--multimodal_pretrain_objectives", *objectives))
    assert calls == [(wikihow_dir, "wikihow", "pretrain", "train", 6),
                     (second, "wikihow", "pretrain", "train", 6),
                     (wikihow_dir, "wikihow", "pretrain", "dev", 2)]
    assert res.global_step == 4
    for step in (2, 4):
        ckpt = out / f"checkpoint-{step}"
        for name in ("config.json", "model.pt", "optimizer.pt",
                     "simple_tokenizer.json", "training_args.json"):
            assert (ckpt / name).is_file(), (step, name)
        with open(ckpt / "config.json") as f:
            cfg = MultimodalConfig.from_json(f.read())
        assert cfg.multimodal_pretrain_objectives == objectives
    keys = set(torch.load(out / "checkpoint-4" / "model.pt",
                          weights_only=True))
    assert {"mlm_head.bias", "margin_loss_mlp.weight",
            "swapping_based_nsp_mlp.weight",
            "sequence_based_nsp_mlp.weight"} <= keys
    assert not any(k.startswith("time_contrastive") for k in keys)
    rows = _scalars(out)
    tags = {r["tag"] for r in rows}
    assert [r["step"] for r in rows if r["tag"] == "pretrain/loss"] == [
        1, 2, 3, 4]
    assert {"pretrain/mlm", "pretrain/grad_norm"} <= tags
    evals = [r for r in rows if r["tag"] == "pretrain/eval_perplexity"]
    assert [r["step"] for r in evals] == [2, 4]
    assert not (out / "checkpoint-best").exists()
    final = _results(out / "eval_results_pretrain.txt")
    assert set(final) == {"eval_loss", "eval_mlm", "eval_perplexity"}
    assert final == res.eval_results
    assert final["eval_perplexity"] == pytest.approx(evals[-1]["value"])


def _launcher_argv(script):
    """The flags the launcher passes to the JAX pretraining entry point,
    its shell variables at their defaults, the CLIP weights and "$@" left
    out."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        text = f.read()
    env = {}

    def expand(s):
        return re.sub(r"\$\{(\w+)\}", lambda m: env[m.group(1)], s)

    for name, value in re.findall(r'^(\w+)="(.*)"$', text, re.M):
        default = re.fullmatch(r"\$\{\w+:-(.*)\}", value)
        env[name] = expand(default.group(1) if default else value)
    call = text[text.index("python3 -m"):].replace("\\\n", " ")
    call = re.sub(r'"\$\{(\w+)\}"', lambda m: env[m.group(1)], call)
    argv = shlex.split(call.replace('"${CLIP_WEIGHTS_FLAG[@]}"', "")
                       .replace('"$@"', ""))
    assert argv[:3] == ["python3", "-m",
                        "multimodal_sequencing_tpu.trainers.run_pretraining"]
    return argv[3:]


@pytest.mark.parametrize("script", ["wikihow_pretrain.sh",
                                    "wikihow_image_only_pretrain.sh"])
def test_launcher_flags_parse_as_in_jax(script):
    argv = _launcher_argv(script) + ["--tokenizer_name", "simple"]
    assert "--multimodal_pretrain_objectives" in argv
    want = vars(jcli.resolve_args(jcli.build_parser("pretrain")
                                  .parse_args(argv)))
    got = vars(tcli.parse_args("pretrain", argv))
    assert got.pop("device") == "cuda"
    assert got == {k: want[k] for k in got}


def _run_launcher(script, wikihow_dir, out, *extra):
    # the launcher's flags at the tiny size: its splits (train-acl22,
    # test-acl22_human) exist in the synthetic directory; 224 px for the
    # tiny RN50 tower's 7 x 7 grid, which the patch objectives assume; at
    # most 100 tokens (the tiny encoder has 160 positions)
    argv = _launcher_argv(script)
    seq = min(100, int(argv[argv.index("--max_seq_length") + 1]))
    return tcli.main_pretrain(argv + [
        "--max_seq_length", str(seq), "--per_seq_max_length", str(seq // 5),
        "--tokenizer_name", "simple", "--model_size", "tiny",
        "--vision_image_size", "224", "--data_dirs", wikihow_dir,
        "--output_root", str(out), "--output_dir", "run", "--max_steps", "2",
        "--save_steps", "2", "--logging_steps", "1", "--max_eval_steps", "1",
        "--device", "cpu", *extra])


def test_wikihow_pretrain_launcher_runs(wikihow_dir, tmp_path):
    res = _run_launcher("wikihow_pretrain.sh", wikihow_dir, tmp_path)
    run = tmp_path / "run"
    assert res.global_step == 2
    keys = set(torch.load(run / "checkpoint-2" / "model.pt",
                          weights_only=True))
    assert {"mlm_head.bias", "image_swapping_mlp.weight",
            "patch_based_image_swapping_mlp.weight", "mrm_dense.weight",
            "encoder.visual_model.resnet.bn1.running_mean"} <= keys
    final = _results(run / "eval_results_pretrain.txt")
    assert set(final) == {"eval_loss", "eval_mlm", "eval_perplexity"}
    assert [r["step"] for r in _scalars(run)
            if r["tag"] == "pretrain/eval_loss"] == [2]


def test_image_only_pretrain_feeds_the_finetune_tower(wikihow_dir, tmp_path):
    # wikihow_image_only_pretrain.sh (no MLM head: the language is one CLS
    # token; its dev eval reports only eval_loss), then a fine-tune run
    # that takes the checkpoint's tower through --clip_visual_model_weights
    res = _run_launcher("wikihow_image_only_pretrain.sh", wikihow_dir,
                        tmp_path)
    ckpt = tmp_path / "run" / "checkpoint-2"
    saved = torch.load(ckpt / "model.pt", weights_only=True)
    assert not any(k.startswith("mlm_head.") for k in saved)
    assert "mrm_dense.weight" in saved
    assert set(res.eval_results) == {"eval_loss"}
    tower = {k[len("encoder.visual_model."):]: v for k, v in saved.items()
             if k.startswith("encoder.visual_model.")}
    assert tower
    # the load itself: weights and BatchNorm statistics, bit for bit
    with open(ckpt / "vision_config.json") as f:
        vcfg = CLIPVisionConfig.from_json(f.read())
    with open(ckpt / "config.json") as f:
        cfg = MultimodalConfig.from_json(f.read())
    cfg.multimodal_img_part = False
    cfg.hierarchical_version = "v1"
    model = init_weights(SequencingModel(cfg, vcfg), 1)
    args = tcli.parse_args("train", ["--clip_visual_model_weights",
                                     str(ckpt)])
    assert load_pretrained_weights(model, args)
    got = model.encoder.visual_model.state_dict()
    assert set(got) == set(tower)
    assert all(torch.equal(got[k], tower[k]) for k in tower)
    # through the fine-tune CLI: one step at learning rate 0 (the warmup's
    # first update) leaves the loaded tower's weights as they were
    out = tmp_path / "finetune"
    tcli.main_train(_argv(
        out, "--multimodal", "--vision_image_size", "224",
        "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
        "--data_dir", wikihow_dir, "--max_seq_length", "50",
        "--per_seq_max_length", "10", "--max_steps", "1", "--save_steps",
        "0", "--clip_visual_model_weights", str(ckpt)))
    tuned = torch.load(out / "checkpoint-1" / "model.pt", weights_only=True)
    weights = [k for k in tower if "running_" not in k]
    assert weights and all(
        torch.equal(tuned[f"encoder.visual_model.{k}"], tower[k])
        for k in weights)


@pytest.mark.parametrize("flags", [
    ["--data_dirs", "{recipeqa}", "--data_names", "recipeqa", "--multimodal",
     "--multimodal_model_type", "visualbert"],
    ["--multimodal", "--multimodal_model_type", "visualbert"],
    ["--multimodal", "--multimodal_model_type", "naive"]],
    ids=["recipeqa", "visualbert", "naive"])
def test_later_slices_raise(wikihow_dir, recipeqa_dir, tmp_path, flags):
    # RecipeQA stories pretrain (tests/test_torch_recipeqa.py); under the
    # VisualBERT encoder they raise as WikiHow's do
    flags = [f.replace("{recipeqa}", recipeqa_dir) for f in flags]
    with pytest.raises(NotImplementedError, match="A5"):
        tcli.main_pretrain(_argv(tmp_path, "--data_dir", wikihow_dir,
                                 "--max_steps", "1", *flags))


def test_no_card_no_fallback(wikihow_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [a for a in _argv(tmp_path, "--data_dir", wikihow_dir)
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main_pretrain(argv)


def _adam_moments(opt_state):
    """The (mu, nu) trees of the JAX optimizer state's Adam."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    if hasattr(opt_state, "inner_opt_state"):
        return _adam_moments(opt_state.inner_opt_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def test_fractional_epoch_takes_one_step_as_jax(monkeypatch, tmp_path):
    # --num_train_epochs 0.5 without --max_steps: 0 epochs and 0 total
    # steps by the count, yet both loops take one step (at learning rate 0:
    # the weights stay put, the Adam moments and the count move) and save
    # checkpoint-1; from the same weights, the same moments
    import numpy as np
    from multimodal_sequencing_tpu.models import pretrainer as jpre
    from multimodal_sequencing_tpu.parallel.mesh import make_mesh
    from multimodal_sequencing_tpu.train import loop as jloop
    from multimodal_sequencing_tpu_torch.models import pretrainer as tpre
    from multimodal_sequencing_tpu_torch.models.convert import (
        params_from_jax, tree_to_state_dict)
    from multimodal_sequencing_tpu_torch.train import loop as tloop
    import test_torch_pretrain as tp

    objectives = ["margin_loss"]
    jc, tc = tp._cfgs("text", multimodal_pretrain_objectives=objectives)
    ds = tp._dataset("text", 4, 40)  # 4 stories at batch 2: 2 steps a pass
    given = tp._random_tree(tp._jax_shapes(jpre.SequencingPretrainer(jc),
                                           "text", objectives), 5)

    class GivenInit(jpre.SequencingPretrainer):
        def init(self, *args, **kwargs):
            return given

    kw = dict(num_train_epochs=0.5, max_steps=-1, save_steps=0)
    jstate, jsteps = jloop.run_pretraining(
        jc, GivenInit(jc), ds, tp._loop_args(tmp_path / "jax", **kw),
        tokenizer=None, mesh=make_mesh(n_data=1, devices=jax.devices()[:1]))
    sd = params_from_jax(given["params"], tc)
    monkeypatch.setattr(tloop, "init_weights",
                        lambda m, seed: (m.load_state_dict(sd), m)[1])
    res = tloop.run_pretraining(tc, tpre.SequencingPretrainer(tc), ds,
                                tp._loop_args(tmp_path / "port", **kw), "cpu")
    assert jsteps == res.global_step == 1
    assert int(jstate.step) == res.optimizer.count == 1
    for out in ("jax", "port"):
        names = [n for n in os.listdir(tmp_path / out)
                 if n.startswith("checkpoint-")]
        assert names == ["checkpoint-1"], out
    # the learning rate of the first update is 0: the weights stay put
    got = res.model.state_dict()
    for key, val in sd.items():
        assert torch.equal(got[key], val), key
    state = res.optimizer.state_dict()
    mu, nu = _adam_moments(jstate.opt_state)
    for name, want in (("mu", tree_to_state_dict(jax.tree.map(np.asarray,
                                                              mu))),
                       ("nu", tree_to_state_dict(jax.tree.map(np.asarray,
                                                              nu)))):
        assert set(state[name]) == set(want)
        norm = max(float(w.abs().max()) for w in want.values())
        for key, w in want.items():
            # f32 gradients summed in another order; mu is stored in bf16
            # (2^-8 relative a rounding), nu in f32
            np.testing.assert_allclose(
                state[name][key].float().numpy(), w.numpy(),
                rtol=1e-2 if name == "mu" else 1e-4, atol=1e-5 * norm,
                err_msg=f"{name} {key}")
