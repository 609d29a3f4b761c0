"""The port's tools against the JAX package's: image features
(`extract_img_features`), ROI sidecars (`extract_roi_features`) and the
story printout (`demo_data`), on the CPU at small sizes, as
`tests/test_fpn.py` drives the JAX tools. The port's towers take the JAX
tools' random weights (`models/convert.py::tree_to_state_dict`); features,
scores and boxes agree within 1e-5 of their largest, and each package's
sidecar loader reads the other's files."""

import contextlib
import inspect
import io
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data.images import (
    load_maskrcnn_sidecar as j_load_sidecar)
from multimodal_sequencing_tpu.models.resnet import (
    ResNetBackbone as JResNetBackbone)
from multimodal_sequencing_tpu.tools import demo_data as j_demo
from multimodal_sequencing_tpu.tools import extract_img_features as j_img
from multimodal_sequencing_tpu.tools import extract_roi_features as j_roi
from multimodal_sequencing_tpu_torch.data.images import (
    load_maskrcnn_sidecar as t_load_sidecar)
from multimodal_sequencing_tpu_torch.models.convert import tree_to_state_dict
from multimodal_sequencing_tpu_torch.tools import demo_data as t_demo
from multimodal_sequencing_tpu_torch.tools import extract_img_features as t_img
from multimodal_sequencing_tpu_torch.tools import extract_roi_features as t_roi

torch.set_num_threads(1)


def _close(got, want, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


def _weights(variables):
    return tree_to_state_dict(variables["params"],
                              variables.get("batch_stats"))


def test_story_image_paths_match_jax(wikihow_dir):
    for split in ("train", "dev", "test"):
        got = t_img.collect_story_image_paths(wikihow_dir, "wikihow", split)
        assert got and got == j_img.collect_story_image_paths(
            wikihow_dir, "wikihow", split)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_image_features_match_jax(wikihow_dir, backbone):
    paths = t_img.collect_story_image_paths(wikihow_dir, "wikihow", "dev")[:3]
    size = (64, 64)
    want = j_img.extract_features(paths, backbone, size, batch_size=2)
    # the JAX tool's weights: its init from PRNGKey(0)
    variables = JResNetBackbone(backbone).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    model = t_img.build_feature_extractor(backbone, size, device="cpu")
    model.load_state_dict(_weights(variables))
    got = t_img.extract_features(paths, backbone, size, batch_size=2,
                                 device="cpu", model=model)
    assert list(got) == list(want)
    for p in paths:
        assert got[p].shape == want[p].shape
        _close(got[p], want[p], p)


def test_image_features_of_a_clip_tower_have_its_width(wikihow_dir):
    paths = t_img.collect_story_image_paths(wikihow_dir, "wikihow", "dev")[:2]
    got = t_img.extract_features(paths, "RN50", (224, 224), batch_size=2,
                                 device="cpu")
    assert [f.shape for f in got.values()] == [(1024,)] * 2
    assert all(np.isfinite(f).all() for f in got.values())


def _image_copy(wikihow_dir, dst):
    shutil.copytree(wikihow_dir, dst)
    return t_img.collect_story_image_paths(str(dst), "wikihow", "dev")[:4]


def test_roi_sidecars_match_jax(wikihow_dir, tmp_path):
    k, size = 3, (64, 64)
    jpaths = _image_copy(wikihow_dir, tmp_path / "jax")
    tpaths = _image_copy(wikihow_dir, tmp_path / "torch")
    assert j_roi.extract_roi_sidecars(jpaths, num_regional_features=k,
                                      backbone="resnet18", image_size=size,
                                      batch_size=2, seed=0) == len(jpaths)
    _, variables = j_roi.build_roi_extractor(k, "resnet18", size, seed=0)
    tower = t_roi.build_roi_extractor(k, "resnet18", size, device="cpu")
    tower.load_state_dict(_weights(variables))
    assert t_roi.extract_roi_sidecars(tpaths, num_regional_features=k,
                                      backbone="resnet18", image_size=size,
                                      batch_size=2, device="cpu",
                                      tower=tower) == len(tpaths)
    for jp, tp in zip(jpaths, tpaths):
        want = np.load(jp[:-4] + "_maskrcnn.npy", allow_pickle=True).item()
        got = np.load(tp[:-4] + "_maskrcnn.npy", allow_pickle=True).item()
        assert set(got) == set(want) == {"features", "scores", "boxes"}
        for key in want:
            assert got[key].dtype == want[key].dtype == np.float32
            _close(got[key], want[key], key)
        # each package's loader reads the other's file
        _close(j_load_sidecar(tp, k), t_load_sidecar(jp, k))
        assert t_load_sidecar(tp, k).shape == (k, 2048)


@pytest.mark.parametrize("fn", [
    t_img.build_feature_extractor, t_img.extract_features,
    t_roi.build_roi_extractor, t_roi.extract_roi_sidecars])
def test_tool_entry_points_run_on_the_card_by_default(fn, monkeypatch):
    # the package's rule: the card unless the caller asks for the CPU, and
    # without a card a raise, never a fallback
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {t_img.extract_features: (["x.png"],),
            t_roi.extract_roi_sidecars: (["x.png"],),
            t_roi.build_roi_extractor: (2,)}.get(fn, ())
    with pytest.raises(RuntimeError, match="--device cpu"):
        fn(*args)


def test_regional_sidecar_writer_matches_jax(tmp_path):
    feats = np.random.RandomState(0).rand(5, 7).astype(np.float64)
    j_img.write_regional_sidecar(str(tmp_path / "a.png"), feats,
                                 {"scores": np.ones(5, np.float32)})
    t_img.write_regional_sidecar(str(tmp_path / "b.png"), feats,
                                 {"scores": np.ones(5, np.float32)})
    want = np.load(tmp_path / "a_maskrcnn.npy", allow_pickle=True).item()
    got = np.load(tmp_path / "b_maskrcnn.npy", allow_pickle=True).item()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


def test_main_writes_the_feature_file(wikihow_dir, tmp_path):
    out = tmp_path / "feats.npy"
    feats = t_img.main(["--data_dir", wikihow_dir, "--split", "dev",
                        "--vision_model", "resnet18", "--image_size", "32",
                        "--out", str(out), "--device", "cpu"])
    saved = np.load(out, allow_pickle=True).item()
    assert sorted(saved) == t_img.collect_story_image_paths(
        wikihow_dir, "wikihow", "dev")
    for p, f in feats.items():
        np.testing.assert_array_equal(saved[p], f)
        assert f.shape == (512,)


@pytest.mark.parametrize("extra", [[], ["--scramble", "-n", "2"],
                                   ["--split", "train", "-n", "3"]])
def test_demo_data_prints_what_jax_prints(wikihow_dir, extra):
    argv = ["--data_dir", wikihow_dir, "--seed", "3", *extra]
    outs = []
    for main in (j_demo.main, t_demo.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "stories in split" in outs[1]
