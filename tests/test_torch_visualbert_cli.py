"""The port's VisualBERT and naive paths through its data and CLIs, against
the JAX package's, on the CPU: the ROI sidecar loader and the datasets'
sidecar batches with the `zeros(1)` sentinel; `main_train` of VisualBERT
with sidecars against the JAX package's own 2-step run, then the eval of
its checkpoint; `--vision_model_checkpoint` from a torchvision file (the
naive and VisualBERT encoders) and from detectron2 files (`.pkl` into the
sequencer's FPN tower, `.pth` into the pretrainer's inline-ROI tower),
train -> checkpoint -> eval; and `main_pretrain` over both encoders. Tiny
configs; every comparison states its tolerance."""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import images as jimages
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import get_processor as j_get_processor
from multimodal_sequencing_tpu.parallel.mesh import make_mesh
from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu.train import loop as jloop
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import images as timages
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.registry import get_processor as t_get_processor
from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
from multimodal_sequencing_tpu_torch.models.sequencer import init_weights
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train import loop as tloop

from test_torch_baselines import _no_dropout_tiny  # noqa: E402
from test_torch_vision_towers import _d2_state_dict  # noqa: E402

torch.set_num_threads(1)

K, SIDE = 2, 16
D2 = "detectron2_R_18_FPN"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ----- data ------------------------------------------------------------------


def _with_sidecars(wikihow_dir, tmp_path, width=SIDE, missing=()):
    """A copy of the fixture's data with a `{img}_maskrcnn.npy` sidecar of
    4 (R, width) features beside every step image but those of
    `missing` ((split, article, step))."""
    data = str(tmp_path / "wh_roi")
    shutil.copytree(wikihow_dir, data)
    img_dir = os.path.join(data, "www.wikihow.com", "images")
    rng = np.random.default_rng(0)
    for name in sorted(os.listdir(img_dir)):
        split, a, s = name[:-4].rsplit("_", 2)
        if (split, int(a), int(s)) in missing:
            continue
        np.save(os.path.join(img_dir, name[:-4] + "_maskrcnn.npy"),
                {"features": rng.standard_normal((4, width)).astype(
                    np.float64), "boxes": np.zeros((4, 4))})
    return data


def test_sidecar_loader_matches_jax(wikihow_dir, tmp_path):
    data = _with_sidecars(wikihow_dir, tmp_path, missing={("train", 0, 1)})
    img_dir = os.path.join(data, "www.wikihow.com", "images")
    for name, n in (("train_0_0.png", 2), ("train_0_0.png", 9),
                    ("train_0_1.png", 2)):
        path = os.path.join(img_dir, name)
        got = timages.load_maskrcnn_sidecar(path, n)
        want = jimages.load_maskrcnn_sidecar(path, n)
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["sort", "pure_class", "pairwise"])
def test_dataset_sidecar_batches_match_jax(wikihow_dir, tmp_path, kind):
    # train article 0 misses one sidecar: its stories (and its pairs that
    # hold that step) carry the zeros(1) sentinel, the others (N, K, C);
    # the batches of the port's datasets equal JAX's
    data = _with_sidecars(wikihow_dir, tmp_path, missing={("train", 0, 1)})
    kw = dict(data_dir=data, min_story_length=5, max_story_length=5)
    task = "wikihow_pairwise" if kind == "pairwise" else "wikihow_sort"
    jex = j_get_processor(task, **kw).get_train_examples()
    tex = t_get_processor(task, **kw).get_train_examples()
    common = dict(max_length=96, per_seq_max_length=12, max_story_length=5,
                  seed=3, multimodal=True, image_size=(24, 24),
                  uint8_images=True, num_img_regional_features=K)
    jt, tt = jtok.load_tokenizer("simple"), ttok.load_tokenizer("simple")
    if kind == "sort":
        pairs = (jds.SortDataset(jex, jt, min_story_length=5, **common),
                 tds.SortDataset(tex, tt, **common))
    elif kind == "pure_class":
        pairs = (jds.PureClassDataset(jex, jt, decode=True,
                                      min_story_length=5, **common),
                 tds.PureClassDataset(tex, tt, **common))
    else:
        pairs = (jds.PairwiseDataset(jex, jt, **common),
                 tds.PairwiseDataset(tex, tt, **common))
    jset, tset = pairs
    shapes = set()
    for i in range(len(tset)):
        a, b = tset[i], jset[i]
        np.testing.assert_array_equal(a["img_regional_features"],
                                      b["img_regional_features"])
        assert a["img_regional_features"].dtype == np.float32
        shapes.add(a["img_regional_features"].shape)
    want = {(1,), (2 if kind == "pairwise" else 5, K, SIDE)}
    assert shapes == want
    # a batch of full stories stacks; a batch with a sentinel stays a list
    for a, b in zip(tds.data_loader(tset, 2), jds.data_loader(jset, 2)):
        x, y = a["img_regional_features"], b["img_regional_features"]
        assert type(x) is type(y)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
    # and without the flag none is loaded
    plain = type(tset)(tex, tt, **{**common,
                                   "num_img_regional_features": None})
    assert "img_regional_features" not in plain[0]


# ----- the CLIs --------------------------------------------------------------


def _train_argv(data, out, *extra, res=32):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", data, "--max_seq_length", "64",
            "--per_seq_max_length", "8", "--per_gpu_train_batch_size", "2",
            "--learning_rate", "1e-3", "--max_steps", "2", "--warmup_steps",
            "1", "--logging_steps", "1", "--save_steps", "2",
            "--eval_splits", "dev", "--per_gpu_eval_batch_size", "2",
            "--seed", "0", "--multimodal", "--vision_image_size", str(res),
            "--output_dir", str(out), "--overwrite_output_dir",
            "--device", "cpu", *extra]


def _eval_argv(data, out, ckpt, *extra, res=32):
    return ["--model_name_or_path", str(ckpt), "--model_size", "tiny",
            "--task_name", "wikihow_sort", "--sort_method", "heat_map",
            "--data_dir", data, "--eval_splits", "dev",
            "--max_seq_length", "64", "--per_seq_max_length", "8",
            "--per_gpu_eval_batch_size", "2", "--seed", "0", "--multimodal",
            "--vision_image_size", str(res), "--output_dir", str(out),
            "--device", "cpu", *extra]


def _losses(out):
    with open(os.path.join(str(out), "logs", "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f)
                if r["tag"] == "train/loss"]


def test_main_train_with_sidecars_matches_jax(wikihow_dir, tmp_path,
                                              monkeypatch):
    # VisualBERT over resnet18 with 2 regional sidecar tokens a step (the
    # sidecars 2048 wide: the CLI's visual_feat_dim; 64 px, a frozen tower
    # whose BatchNorms see 40 values a channel): the JAX package's
    # main_train, then the port's from the JAX init's weights, 2 steps at
    # dropout 0 (the first at learning rate 0) on the same batches: both
    # losses within 1e-5 relative, then the port's checkpoint evaluates
    # with the sidecars (its config.json keeps the tower's fields)
    data = _with_sidecars(wikihow_dir, tmp_path, width=2048)
    flags = ("--multimodal_model_type", "visualbert", "--vision_model",
             "resnet18", "--include_num_img_regional_features", "2",
             "--freeze_vision_model", "--gelu_impl", "erf")
    _no_dropout_tiny(monkeypatch)
    captured = {}
    real = jloop.make_train_state

    def capture(*a, **kw):
        captured["state"] = real(*a, **kw)
        return captured["state"]

    monkeypatch.setattr(jloop, "make_train_state", capture)
    monkeypatch.setattr(jloop, "make_mesh", lambda n_model=1: make_mesh(
        n_data=1, devices=jax.devices()[:1]))
    argv = _train_argv(data, tmp_path / "jax", *flags, res=64)
    at = argv.index("--device")
    jcli.main_train(argv[:at] + argv[at + 2:])
    targv = _train_argv(data, tmp_path / "port", *flags, res=64)
    tc = tcli.build_config(tcli.parse_args("train", targv))[0]
    state = captured["state"]
    sd = params_from_jax(_np(state.params), tc,
                         _np(state.model_state.get("batch_stats")))
    assert sd["encoder.regional_proj.weight"].shape == (512, 2048)
    monkeypatch.setattr(tloop, "init_weights",
                        lambda m, seed: (m.load_state_dict(sd), m)[1])
    res = tcli.main_train(targv)
    want = _losses(tmp_path / "jax")
    assert len(want) == 2
    np.testing.assert_allclose(_losses(tmp_path / "port"), want, rtol=1e-5)
    ckpt = tmp_path / "port" / "checkpoint-2"
    saved = json.loads((ckpt / "config.json").read_text())
    assert (saved["multimodal_model_type"], saved["vision_model"],
            saved["num_img_regional_features"]) == ("visualbert", "resnet18",
                                                    2)
    assert not (ckpt / "vision_config.json").exists()
    out = tmp_path / "eval"
    results = tcli.main_eval(_eval_argv(
        data, out, ckpt, "--multimodal_model_type", "visualbert",
        "--vision_model", "resnet18", "--include_num_img_regional_features",
        "2", res=64))
    assert 0.0 <= results["dev"]["partial_match"] <= 1.0
    assert (out / "output_order.txt").exists()
    del res


def _torchvision_file(path, seed):
    """A torchvision-layout resnet18 state dict of random weights (fc and
    num_batches_tracked included), as torch.save writes one."""
    from multimodal_sequencing_tpu_torch.models.resnet import ResNetBackbone
    tower = init_weights(ResNetBackbone("resnet18"), seed)
    sd = {}
    for key, val in tower.state_dict().items():
        key = key.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1")
        key = key.replace("layer1_", "layer1.").replace(
            "layer2_", "layer2.").replace("layer3_", "layer3.").replace(
            "layer4_", "layer4.")
        sd[key] = val + (0.5 if "running_var" in key else 0.0)
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["bn1.num_batches_tracked"] = torch.tensor(3)
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("mt", ["naive", "visualbert"])
def test_cli_torchvision_checkpoint_train_and_eval(wikihow_dir, tmp_path, mt):
    # --vision_model_checkpoint with a torchvision resnet18 file: the tower
    # starts from its weights and BatchNorm statistics (learning rate 0
    # keeps the weights; the statistics move in training), the checkpoint
    # evaluates with the heat-map sort; a missing path is ignored
    ckpt_file = str(tmp_path / "resnet18.pth")
    sd = _torchvision_file(ckpt_file, 7)
    import unittest.mock as mock
    out = tmp_path / "train"
    seen = {}
    with mock.patch.object(tloop, "load_pretrained_weights",
                           _recording_loads(seen)):
        tcli.main_train(_train_argv(
            wikihow_dir, out, "--multimodal_model_type", mt,
            "--vision_model", "resnet18", "--learning_rate", "0",
            "--vision_model_checkpoint", ckpt_file))
    assert torch.equal(seen["conv1.weight"], sd["conv1.weight"])
    assert torch.equal(seen["layer2_0.downsample_bn.running_var"],
                       sd["layer2.0.downsample.1.running_var"])
    trained = torch.load(out / "checkpoint-2" / "model.pt",
                         weights_only=True)
    assert torch.equal(trained["encoder.vision_model.conv1.weight"],
                       sd["conv1.weight"])
    assert not torch.equal(trained["encoder.vision_model.bn1.running_mean"],
                           sd["bn1.running_mean"])
    results = tcli.main_eval(_eval_argv(
        wikihow_dir, tmp_path / "eval", out / "checkpoint-2",
        "--multimodal_model_type", mt, "--vision_model", "resnet18"))
    assert 0.0 <= results["dev"]["partial_match"] <= 1.0
    tcli.main_train(_train_argv(
        wikihow_dir, tmp_path / "missing", "--multimodal_model_type", mt,
        "--vision_model", "resnet18", "--max_steps", "1",
        "--vision_model_checkpoint", str(tmp_path / "no_such_file.pth")))


def _d2_file(tmp_path, suffix, seed=1):
    """A synthetic detectron2 R-18 FPN file (box head 16 wide): a pickle
    of numpy arrays under "model", or a flat torch state dict."""
    d2 = _d2_state_dict(np.random.default_rng(seed), "resnet18",
                        feature_dim=16)
    path = str(tmp_path / f"model_final{suffix}")
    if suffix == ".pkl":
        with open(path, "wb") as f:
            pickle.dump({"model": d2}, f)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in d2.items()}, path)
    return d2, path


def _recording_loads(seen, encoder="encoder"):
    """`load_pretrained_weights` that also records the tower it loaded."""
    real = tloop.load_pretrained_weights

    def recorded(model, args):
        loaded = real(model, args)
        tower = getattr(model, encoder).vision_model
        seen.update({k: v.clone() for k, v in tower.state_dict().items()})
        return loaded

    return recorded


def test_cli_detectron2_checkpoint_sequencer(wikihow_dir, tmp_path):
    # the sequencer's FPN tower with 2 regional features and no sidecars
    # on disk (the sentinel: no inline ROI, as in the JAX package): the
    # detectron2 .pkl's backbone and FPN are grafted, its objectness and box
    # heads skipped (the tower has none); the run trains and its checkpoint
    # evaluates, the tower rebuilt from config.json
    import unittest.mock as mock
    d2, path = _d2_file(tmp_path, ".pkl")
    flags = ["--multimodal_model_type", "visualbert", "--vision_model", D2,
             "--include_num_img_regional_features", "2",
             "--vision_feature_dim", "16"]
    out = tmp_path / "train"
    seen = {}
    with mock.patch.object(tloop, "load_pretrained_weights",
                           _recording_loads(seen)):
        tcli.main_train(_train_argv(wikihow_dir, out, *flags,
                                    "--vision_model_checkpoint", path))
    assert torch.equal(seen["fpn.output_p3.bias"],
                       torch.from_numpy(d2["backbone.fpn_output3.bias"]))
    assert torch.equal(seen["bottom_up.layer2_0.downsample_bn.running_var"],
                       torch.from_numpy(d2[
                           "backbone.bottom_up.res3.0.shortcut.norm."
                           "running_var"]))
    assert not any(k.startswith(("box_fc", "obj_")) for k in seen)
    saved = json.loads((out / "checkpoint-2" / "config.json").read_text())
    assert (saved["vision_model"], saved["vision_feature_dim"],
            saved["num_img_regional_features"]) == (D2, 16, 2)
    results = tcli.main_eval(_eval_argv(
        wikihow_dir, tmp_path / "eval", out / "checkpoint-2",
        "--multimodal_model_type", "visualbert", "--vision_model", D2,
        "--include_num_img_regional_features", "2"))
    assert 0.0 <= results["dev"]["partial_match"] <= 1.0


def _pretrain_argv(data, out, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--do_train", "--data_dir", data, "--max_seq_length", "64",
            "--per_seq_max_length", "8", "--per_gpu_train_batch_size", "2",
            "--max_steps", "1", "--logging_steps", "1", "--save_steps", "0",
            "--multimodal", "--vision_image_size", "32",
            "--multimodal_pretrain_objectives", "swapping_based_nsp",
            "--output_dir", str(out), "--overwrite_output_dir",
            "--device", "cpu", *extra]


def test_cli_pretrain_inline_roi_and_naive(wikihow_dir, tmp_path):
    # main_pretrain over VisualBERT with an R-18 FPN tower and inline ROI
    # (the pretrainer passes no sidecars) from a detectron2 .pth: every
    # part grafted, the box head's fc1 columns permuted to (s, s, C); a
    # step with finite losses; a file of another box-head width raises
    # ValueError; and a step over the naive model
    import unittest.mock as mock
    d2, path = _d2_file(tmp_path, ".pth")
    flags = ["--multimodal_model_type", "visualbert", "--vision_model", D2,
             "--include_num_img_regional_features", "2"]
    seen = {}
    with mock.patch.object(tloop, "load_pretrained_weights",
                           _recording_loads(seen)):
        res = tcli.main_pretrain(_pretrain_argv(
            wikihow_dir, tmp_path / "vb", *flags, "--vision_feature_dim",
            "16", "--vision_model_checkpoint", path))
    w1 = torch.from_numpy(d2["roi_heads.box_head.fc1.weight"])
    assert torch.equal(seen["box_fc1.weight"],
                       w1.reshape(16, 256, 7, 7).permute(0, 2, 3, 1)
                       .reshape(16, -1))
    assert torch.equal(seen["obj_logit.weight"], torch.from_numpy(
        d2["proposal_generator.rpn_head.objectness_logits.weight"][1:2]))
    assert res.global_step == 1
    assert all(np.isfinite(h["loss"]) for h in res.history)
    with pytest.raises(ValueError, match="box_fc1"):
        tcli.main_pretrain(_pretrain_argv(
            wikihow_dir, tmp_path / "wide", *flags, "--vision_feature_dim",
            "24", "--vision_model_checkpoint", path))
    res = tcli.main_pretrain(_pretrain_argv(
        wikihow_dir, tmp_path / "naive", "--multimodal_model_type", "naive",
        "--vision_model", "resnet18"))
    assert res.global_step == 1
    assert all(np.isfinite(h["loss"]) for h in res.history)
