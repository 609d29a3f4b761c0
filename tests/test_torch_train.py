"""The port's training slice against the JAX package's: heat-map targets and
losses, the train step (5 steps of the tiny sequencer at dropout 0 from
weights moved by `params_from_jax`, with clipping, with accumulation 2), the
training data and its loader order, checkpoints and resume, the train CLI on
the CPU whose checkpoint the eval CLI loads, and the train parser."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import get_processor as j_get_processor
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.heads import HeatmapHead as JHeatmapHead
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel,
    render_heatmap_targets as j_render_targets)
from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu.train.state import (
    make_optimizer as j_make_optimizer, make_train_state)
from multimodal_sequencing_tpu.train.steps import (
    compute_loss as j_compute_loss, device_batch as j_device_batch,
    make_train_step)
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.registry import get_processor as t_get_processor
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
from multimodal_sequencing_tpu_torch.models.heads import HeatmapHead
from multimodal_sequencing_tpu_torch.models.sequencer import (
    SequencingModel, render_heatmap_targets)
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train.checkpoint import (
    find_checkpoints, parse_step_from_name, restore_checkpoint,
    save_checkpoint)
from multimodal_sequencing_tpu_torch.train.state import AdamW
from multimodal_sequencing_tpu_torch.train.steps import compute_loss, train_step

torch.set_num_threads(1)

MAX_LEN, PER_SEQ, BATCH = 96, 12, 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_heatmap_targets_match_jax(seed):
    rng = np.random.RandomState(seed)
    labels = np.stack([rng.permutation(5) for _ in range(6)]).astype(np.int32)
    want = np.asarray(j_render_targets(jnp.asarray(labels), 5))
    got = render_heatmap_targets(torch.from_numpy(labels).long(), 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("version", ["v1", "v3"])
@pytest.mark.parametrize("ranking", [False, True])
def test_compute_loss_and_its_gradient_match_jax(version, ranking):
    rng = np.random.RandomState(7)
    b, n = 4, 5
    hm = rng.rand(b, n, n).astype(np.float32)
    if version == "v3":
        hm = hm * 2 - 1
    hm[0, 0, 1] = 1.0  # clipped at 1 - 1e-6
    labels = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)
    present = np.ones((b, n), bool)
    present[1, 3:] = False
    valid = np.array([True, True, True, False])
    objs = ["heatmap_pairwise_ranking"] if ranking else []
    jc = jcfg.MultimodalConfig(hierarchical_version=version,
                               hl_include_objectives=objs)
    tc = tcfg.MultimodalConfig(hierarchical_version=version,
                               hl_include_objectives=objs)

    def jloss(h):
        return j_compute_loss(jc, {"heatmap": h, "present": jnp.asarray(present)},
                              {"labels": jnp.asarray(labels),
                               "valid": jnp.asarray(valid)})[0]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(hm))
    th = torch.from_numpy(hm).requires_grad_()
    got, _ = compute_loss(tc, {"heatmap": th, "present": torch.from_numpy(present)},
                          {"labels": torch.from_numpy(labels).long(),
                           "valid": torch.from_numpy(valid)})
    got.backward()
    # f32 on both sides
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_g), atol=1e-6)
    assert isinstance(HeatmapHead.loss, type(JHeatmapHead.loss))


def _datasets(wikihow_dir, seed=0):
    kw = dict(data_dir=wikihow_dir, min_story_length=5, max_story_length=5)
    common = dict(max_length=MAX_LEN, per_seq_max_length=PER_SEQ,
                  max_story_length=5, seed=seed)
    jex = j_get_processor("wikihow_hl_v1", paired_with_image=False,
                          **kw).get_train_examples()
    tex = t_get_processor("wikihow_sort", **kw).get_train_examples()
    return (jds.PureClassDataset(jex, jtok.load_tokenizer("simple"),
                                 decode=True, min_story_length=5, **common),
            tds.PureClassDataset(tex, ttok.load_tokenizer("simple"),
                                 **common))


@pytest.mark.parametrize("shuffle,epoch,drop_last,pad_final", [
    (False, 0, False, True), (True, 0, False, True), (True, 3, True, True),
    (True, 1, False, False)])
def test_train_data_and_loader_order_match_jax(wikihow_dir, shuffle, epoch,
                                               drop_last, pad_final):
    jset, tset = _datasets(wikihow_dir, seed=5)
    kw = dict(shuffle=shuffle, seed=5, epoch=epoch, drop_last=drop_last,
              pad_final=pad_final)
    jb = list(jds.data_loader(jset, 4, **kw))
    tb = list(tds.data_loader(tset, 4, **kw))
    assert len(jb) == len(tb) > 0
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        for key in ("input_ids", "attention_mask", "token_type_ids", "labels",
                    "valid"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["guid"] == b["guid"]


def _tiny_cfgs():
    # dropout 0 on both sides (JAX's dropout bits cannot be reproduced);
    # the default logit_erf GELU; the simple tokenizer's 50265 ids
    enc = dict(vocab_size=50265, type_vocab_size=5, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    kw = dict(hierarchical_version="v1", max_story_length=5,
              max_seq_length=MAX_LEN, per_seq_max_length=PER_SEQ)
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc), **kw),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc), **kw))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_follow_jax(wikihow_dir, accum):
    # 5 steps of the tiny sequencer from the same weights on the same
    # batches: the loss and gradient-norm trajectories of the JAX
    # make_train_step. f32 throughout; sums in another order and the GELU's
    # ulp-level differences grow over 5 Adam steps to ~1e-5 relative.
    jc, tc = _tiny_cfgs()
    jset, _ = _datasets(wikihow_dir)
    batches = [b for epoch in range(3) for b in jds.data_loader(
        jset, BATCH, shuffle=True, seed=0, epoch=epoch)][:5]
    kw = dict(learning_rate=2e-3, warmup_steps=1, total_steps=5,
              weight_decay=0.01, adam_epsilon=1e-8, max_grad_norm=1.0,
              grad_accum_steps=accum)
    state = make_train_state(JSequencingModel(jc), jax.random.PRNGKey(0),
                             j_device_batch(batches[0]),
                             tx=j_make_optimizer(**kw))
    model = SequencingModel(tc)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, state.params), tc))
    opt = AdamW(model, **kw)
    step_fn = make_train_step(jc, donate=False)
    rng = jax.random.PRNGKey(1)
    want, got = [], []
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, j_device_batch(batch), rng)
        want.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        out = train_step(model, opt, batch, i, 0)
        got.append((out["loss"].item(), out["grad_norm"].item()))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    assert max(g for _, g in want) > kw["max_grad_norm"]  # clipping acted
    assert len({round(x, 4) for x, _ in want}) > 2  # the weights moved
    # the weights after 5 steps; the attention key biases get a gradient
    # that is zero but for rounding (softmax is invariant to a shift of a
    # row's scores), which Adam turns into steps of up to lr on either side
    final = params_from_jax(jax.tree.map(np.asarray, state.params), tc)
    for key, val in model.state_dict().items():
        atol = 2 * 5 * kw["learning_rate"] if key.endswith("key.bias") else 2e-5
        np.testing.assert_allclose(val.numpy(), final[key].numpy(),
                                   atol=atol, rtol=0, err_msg=key)


def _train_argv(wikihow_dir, out, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", wikihow_dir, "--max_seq_length", str(MAX_LEN),
            "--per_seq_max_length", str(PER_SEQ),
            "--per_gpu_train_batch_size", str(BATCH),
            "--per_gpu_eval_batch_size", "2", "--learning_rate", "1e-3",
            "--warmup_steps", "1", "--logging_steps", "1", "--seed", "0",
            "--output_dir", str(out), "--device", "cpu", *extra]


def test_train_cli_on_cpu_and_its_checkpoint_evaluates(wikihow_dir, tmp_path):
    out = tmp_path / "run"
    res = tcli.main_train(_train_argv(
        wikihow_dir, out, "--max_steps", "4", "--save_steps", "2",
        "--evaluate_during_training", "--do_eval", "--eval_splits", "dev"))
    assert res.global_step == 4
    assert [h["step"] for h in res.history] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in res.history)
    names = sorted(os.path.basename(p) for p in find_checkpoints(str(out)))
    assert names == ["checkpoint-2", "checkpoint-4", "checkpoint-best"]
    for name in names:
        assert sorted(os.listdir(out / name)) == [
            "config.json", "model.pt", "optimizer.pt", "simple_tokenizer.json",
            "training_args.json"]
    assert json.loads((out / "checkpoint-4" / "training_args.json").read_text()
                      )["max_steps"] == 4
    scalars = [json.loads(line) for line in
               (out / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert {s["tag"] for s in scalars} >= {"train/loss", "train/grad_norm",
                                           "eval/partial_match"}
    # the eval CLI loads the checkpoint and gives what --do_eval gave
    ev = tcli.main_eval([
        "--model_name_or_path", "simple", "--model_size", "tiny",
        "--task_name", "wikihow_sort", "--sort_method", "heat_map",
        "--model_name_or_path_1", str(out / "checkpoint-4"),
        "--data_dir", wikihow_dir, "--eval_splits", "dev",
        "--max_seq_length", str(MAX_LEN), "--per_seq_max_length",
        str(PER_SEQ), "--per_gpu_eval_batch_size", "2", "--seed", "0",
        "--output_dir", str(tmp_path / "eval"), "--device", "cpu"])
    assert ev["dev"] == res.eval_results["checkpoint-4"]


@pytest.mark.parametrize("load_optimizer", [True, False])
def test_resume_from_the_latest_checkpoint(wikihow_dir, tmp_path,
                                           load_optimizer):
    out = tmp_path / "run"
    tcli.main_train(_train_argv(wikihow_dir, out, "--max_steps", "2",
                                "--save_steps", "2", "--overwrite_output_dir"))
    extra = [] if load_optimizer else ["--do_not_load_optimizer"]
    res = tcli.main_train(_train_argv(wikihow_dir, out, "--max_steps", "4",
                                      "--save_steps", "0", *extra))
    # with the optimizer: steps 3 and 4 from the saved step and counts;
    # without: weights only, the step count starts again at 0
    steps = [3, 4] if load_optimizer else [1, 2, 3, 4]
    assert [h["step"] for h in res.history] == steps
    assert res.optimizer.count == 4
    assert parse_step_from_name(str(out / "checkpoint-4")) == 4


def test_checkpoint_round_trip(tmp_path):
    _, tc = _tiny_cfgs()
    model = SequencingModel(tc)
    opt = AdamW(model, learning_rate=1e-2, warmup_steps=1, total_steps=9,
                grad_accum_steps=2)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        opt.step([torch.randn(p.shape, generator=gen) for p in opt.params])
    path = save_checkpoint(str(tmp_path), 3, model, opt, tc, {"seed": 0})
    model2 = SequencingModel(tc)
    opt2 = AdamW(model2, learning_rate=1e-2, warmup_steps=1, total_steps=9,
                 grad_accum_steps=2)
    assert restore_checkpoint(path, model2, opt2) == 3
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    assert (opt2.count, opt2.mini_step) == (opt.count, opt.mini_step)
    for a, b in zip(opt.mu + opt.nu + opt.acc, opt2.mu + opt2.nu + opt2.acc):
        assert torch.equal(a, b)
    assert tcfg.MultimodalConfig.from_json((
        tmp_path / "checkpoint-3" / "config.json").read_text()).to_json() == \
        tc.to_json()
    dirs = [tmp_path / f"checkpoint-{t}" for t in ("10", "best", "9")]
    for d in dirs:
        d.mkdir()
    assert [os.path.basename(p) for p in find_checkpoints(str(tmp_path))] == [
        "checkpoint-best", "checkpoint-3", "checkpoint-9", "checkpoint-10"]
    assert [os.path.basename(p) for p in find_checkpoints(
        str(tmp_path), ["best", "9"])] == ["checkpoint-best", "checkpoint-9"]


def _options(parser):
    out = {}
    for action in parser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        out[tuple(action.option_strings)] = (
            action.dest, action.default, action.choices, action.nargs,
            action.type, action.const, type(action).__name__)
    return out


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_parser_options_match_jax(kind):
    want = _options(jcli.build_parser(kind))
    got = _options(tcli.build_parser(kind))
    assert got.pop(("--device",))[1] == "cuda"
    assert got == want


@pytest.mark.parametrize("flag", [["--include_num_img_regional_features",
                                   "4"], ["--fsdp"],
                                  ["--profile_dir", "profile"],
                                  ["--pipeline_parallel_size", "2"],
                                  ["--sequence_parallel"],
                                  ["--model_parallel_size", "2"]])
def test_options_of_later_slices_raise(wikihow_dir, tmp_path, flag):
    if flag[0] == "--include_num_img_regional_features":
        # ported (ROADMAP A5e): accepted, into the config and the VisualBERT
        # encoder's regional projection (no sidecars on disk: the sentinel)
        res = tcli.main_train(_train_argv(
            wikihow_dir, tmp_path, "--max_steps", "1", "--multimodal",
            "--multimodal_model_type", "visualbert", "--vision_model",
            "resnet18", "--vision_image_size", "32", *flag))
        assert res.global_step == 1
        assert res.model.cfg.num_img_regional_features == int(flag[1])
        assert hasattr(res.model.encoder, "regional_proj")
        return
    # ported (ROADMAP A6, A7a, A7b): accepted; tensor parallelism and the
    # pipeline across two gloo ranks of the CLI's own (one process cannot
    # hold a model dim of 2), the rest in this process, where they change
    # nothing in a run of one step (the profiling window opens at step 2)
    if flag[0] in ("--model_parallel_size", "--pipeline_parallel_size"):
        flag = [*flag, "--num_cpu_devices", "2"]
    res = tcli.main_train(_train_argv(wikihow_dir, tmp_path,
                                      "--max_steps", "1", *flag))
    assert res.global_step == 1
    assert (tmp_path / "checkpoint-1" / "model.pt").exists()


def test_no_cuda_asks_for_the_cpu(wikihow_dir, tmp_path):
    # the JAX package accepts --no_cuda and ignores it; in the port it is
    # the caller's request for the CPU, over any --device
    argv = _train_argv(wikihow_dir, tmp_path, "--max_steps", "1")
    argv[argv.index("--device") + 1] = "cuda"
    assert tcli.parse_args("train", argv).device == "cuda"
    assert tcli.parse_args("train", argv + ["--no_cuda"]).device == "cpu"
    assert tcli.parse_args("eval", ["--no_cuda"]).device == "cpu"
    res = tcli.main_train(argv + ["--no_cuda"])
    assert res.global_step == 1
    assert next(res.model.parameters()).device.type == "cpu"


def _eval_argv(wikihow_dir, out, model_path, *extra):
    return ["--model_name_or_path", model_path, "--model_size", "tiny",
            "--task_name", "wikihow_sort", "--sort_method", "heat_map",
            "--data_dir", wikihow_dir, "--eval_splits", "dev",
            "--max_seq_length", str(MAX_LEN), "--per_seq_max_length",
            str(PER_SEQ), "--per_gpu_eval_batch_size", "2", "--seed", "0",
            "--output_dir", str(out), "--device", "cpu", *extra]


# What makes a directory a local HF model to the JAX package: a config.json
# with a top-level hidden_size (it builds the encoder from it), or a weights
# file it looks for (it reads pytorch_model.bin and finds but does not read
# model.safetensors, which may be a placeholder here)
HF_DIRS = {"config": ["config.json"], "bin": ["pytorch_model.bin"],
           "safetensors": ["model.safetensors"]}
HF_CONFIG = {"model_type": "roberta", "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "intermediate_size": 128, "max_position_embeddings": 160,
             "vocab_size": 50265}


def _hf_state_dict(prefix, type_vocab_size=1):
    """The state dict of a tiny HF RobertaModel with random weights, at the
    tiny encoder's shapes, its keys under `prefix`."""
    from transformers import RobertaConfig, RobertaModel
    torch.manual_seed(0)
    hf = RobertaModel(RobertaConfig(
        **{k: v for k, v in HF_CONFIG.items() if k != "model_type"},
        type_vocab_size=type_vocab_size, layer_norm_eps=1e-5,
        pad_token_id=1))
    return {prefix + k: v for k, v in hf.state_dict().items()}


def _write_hf_dir(path, kind):
    path.mkdir()
    if kind == "config":
        (path / "config.json").write_text(json.dumps(HF_CONFIG))
    elif kind == "bin":
        torch.save(_hf_state_dict("roberta."), path / "pytorch_model.bin")
    else:
        (path / "model.safetensors").write_text("")


@pytest.mark.parametrize("entry", ["train", "eval"])
@pytest.mark.parametrize("kind", sorted(HF_DIRS))
def test_local_hf_model_dir_follows_jax(wikihow_dir, tmp_path, kind, entry):
    from multimodal_sequencing_tpu.models import convert as jconvert
    from multimodal_sequencing_tpu_torch.models import convert as tconvert
    from multimodal_sequencing_tpu_torch.models.sequencer import init_weights
    hf = tmp_path / "hf"
    _write_hf_dir(hf, kind)
    assert tcli.local_hf_model_files(str(hf)) == HF_DIRS[kind]
    if entry == "eval":
        # the JAX eval hands the directory to its checkpoint restore, which
        # fails; the port says why
        argv = _eval_argv(wikihow_dir, tmp_path / "out", str(hf),
                          "--tokenizer_name", "simple")
        with pytest.raises(ValueError, match="not a checkpoint of this "
                                             "package.*local HF model"):
            tcli.main_eval(argv)
        return
    argv = _train_argv(wikihow_dir, tmp_path / "out", "--max_steps", "1",
                       "--tokenizer_name", "simple")
    argv[argv.index("--model_name_or_path") + 1] = str(hf)
    # the JAX parser has no --device
    at = argv.index("--device")
    jargs = jcli.build_parser("train").parse_args(argv[:at] + argv[at + 2:])
    targs = tcli.parse_args("train", argv)
    jc, tc = jcli.build_config(jargs)[0], tcli.build_config(targs)[0]
    assert json.loads(tc.encoder.to_json()) == json.loads(jc.encoder.to_json())
    assert tc.encoder.hidden_size == 64 and tc.encoder.type_vocab_size == 5
    # the initial weights: each package's init, then the HF weights
    ids = np.full((1, MAX_LEN), jc.pad_id, np.int32)
    ids[0, 0] = jc.cls_id
    jparams = jax.tree.map(np.asarray, JSequencingModel(jc).init(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    jloaded = jconvert.load_pretrained_weights(dict(jparams), jargs, jc)
    model = init_weights(SequencingModel(tc), 0)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    assert tconvert.load_pretrained_weights(model, targs) == (kind == "bin")
    got = model.state_dict()
    if kind == "bin":
        want = params_from_jax(jloaded, tc)
        enc = [k for k in got if k.startswith("encoder.")]
        assert len(enc) == 3 + 2 + 2 * 16 + 2  # tables, LN, layers, pooler
        for key in enc:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                       msg=key)
        hf_sd = _hf_state_dict("")
        assert torch.equal(got["encoder.layer_1.attention.query.weight"],
                           hf_sd["encoder.layer.1.attention.self.query.weight"])
        table = got["encoder.embeddings.token_type_embeddings.weight"]
        assert table.shape == (5, 64)
        assert torch.equal(table, hf_sd[
            "embeddings.token_type_embeddings.weight"].repeat(5, 1))
    else:  # neither package loads weights
        assert jax.tree.all(jax.tree.map(np.array_equal, jloaded, jparams))
        for key, val in got.items():
            assert torch.equal(val, fresh[key]), key
    res = tcli.main_train(argv)
    assert res.global_step == 1
    assert np.isfinite(res.history[0]["loss"])


def test_port_checkpoints_and_other_dirs_are_not_hf_models(tmp_path):
    _, tc = _tiny_cfgs()
    model = SequencingModel(tc)
    opt = AdamW(model, learning_rate=1e-2, warmup_steps=1, total_steps=9)
    ckpt = save_checkpoint(str(tmp_path), 1, model, opt, tc,
                           tokenizer=ttok.SimpleWordTokenizer(1000))
    # the port's config.json keeps hidden_size under "encoder"
    assert "hidden_size" in json.loads(
        (tmp_path / "checkpoint-1" / "config.json").read_text())["encoder"]
    assert tcli.local_hf_model_files(ckpt) == []
    other = tmp_path / "other"
    other.mkdir()
    (other / "config.json").write_text(json.dumps({"vocab_size": 5}))
    for path in (str(other), str(tmp_path / "missing"), "simple",
                 str(tmp_path / "checkpoint-1" / "model.pt"), None):
        assert tcli.local_hf_model_files(path) == []
    assert ttok.load_tokenizer(ckpt).vocab_size == 1000


def test_port_checkpoint_evaluates_as_model_name_or_path(wikihow_dir,
                                                          tmp_path):
    out = tmp_path / "run"
    tcli.main_train(_train_argv(wikihow_dir, out, "--max_steps", "2",
                                "--save_steps", "0", "--overwrite_output_dir"))
    ckpt = out / "checkpoint-2"
    assert (ckpt / "simple_tokenizer.json").is_file()
    # the checkpoint gives the eval both its tokenizer and its weights, as
    # in the JAX package: no --model_name_or_path_1, no --tokenizer_name
    ev_dir = tmp_path / "eval"
    got = tcli.main_eval(_eval_argv(wikihow_dir, ev_dir, str(ckpt)))
    orders = [[int(i) for i in line.split()] for line in
              (ev_dir / "output_order.txt").read_text().splitlines()]
    assert orders and all(sorted(o) == list(range(len(o))) for o in orders)
    want = tcli.main_eval(_eval_argv(
        wikihow_dir, tmp_path / "eval_1", "simple",
        "--model_name_or_path_1", str(ckpt)))
    assert got == want


@pytest.mark.parametrize("vocab_size", [50265, 1000, 6])
def test_simple_tokenizer_files_match_jax(tmp_path, vocab_size):
    jtok.SimpleWordTokenizer(vocab_size).save_pretrained(str(tmp_path / "jax"))
    ttok.SimpleWordTokenizer(vocab_size).save_pretrained(str(tmp_path / "port"))
    name = "simple_tokenizer.json"
    assert os.listdir(tmp_path / "port") == [name]
    assert (tmp_path / "port" / name).read_bytes() == (
        tmp_path / "jax" / name).read_bytes()
    # each package reads the other's file
    assert jtok.load_tokenizer(str(tmp_path / "port")).vocab_size == vocab_size
    assert ttok.load_tokenizer(str(tmp_path / "jax")).vocab_size == vocab_size


def test_train_needs_a_heatmap_task(wikihow_dir, tmp_path):
    # the heat-map head trains on whole stories (hl_v1, pure_class); step
    # pairs train the v0 head (tests/test_torch_baselines.py)
    argv = _train_argv(wikihow_dir, tmp_path, "--max_steps", "1")
    argv[argv.index("wikihow_hl_v1")] = "wikihow_pairwise"
    with pytest.raises(ValueError, match="does not train the v1 head"):
        tcli.main_train(argv)
    assert isinstance(tcli.build_parser(), argparse.ArgumentParser)
