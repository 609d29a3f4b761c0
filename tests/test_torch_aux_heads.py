"""The port's auxiliary objective heads (`--hl_include_objectives`) against
the JAX package's, on the CPU: each objective set's aux logits and loss
terms under the heat-map and pointer heads, with the gradients; the
parameter trees against the JAX init's (v0 has none of the aux heads; a
text-only model with `itm` has `seq_relationship`); `plan_itm_swap` draw
for draw; the fine-tune loop's host surgery (`mlm`, `mlm_wo_loss`, `itm`)
against the JAX loop's draws; and `main_train` with the objectives, two
steps of the heat-map head with `mlm` from the JAX init's weights against
the JAX package's own run. Tiny configs, f32, dropout 0 (the aux heads'
own dropout 0.5 is off in the deterministic forwards); logits, losses and
gradients within 1e-5 of their largest |value|, integer outputs
exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.parallel.mesh import make_mesh
from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu.train import loop as jloop
from multimodal_sequencing_tpu.train.mlm import (
    mask_tokens_sentence as j_mask_tokens_sentence)
from multimodal_sequencing_tpu.train.objectives import (
    plan_itm_swap as j_plan_itm_swap)
from multimodal_sequencing_tpu.train.steps import (
    compute_loss as j_compute_loss)
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.models.sequencer import SequencingModel
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train import loop as tloop
from multimodal_sequencing_tpu_torch.train.objectives import plan_itm_swap
from multimodal_sequencing_tpu_torch.train.steps import compute_loss
from test_torch_baselines import _no_dropout_tiny
from test_torch_pointer import (N, assert_close, cfgs, grads_match,
                                jax_forward, make_batch, models,
                                port_batch, port_forward, train_argv)

torch.set_num_threads(1)

AUX_CASES = [("p0", ("head", "binary", "itm", "mlm")),
             ("p1", ("head", "pairwise", "mlm", "mlm_wo_loss")),
             ("v1", ("head", "binary", "itm", "heatmap_pairwise_ranking")),
             ("v2", ("itm", "mlm")),
             ("v2", ("pairwise",))]
AUX_OUTPUTS = ("head_logits", "bin_logits", "itm_logits", "mlm_logits")


# (v3's BCE of |tanh| amplifies f32 rounding in the heat-map head's own
# gradient beyond 1e-5 of the largest: test_torch_train.py holds its loss
# gradient on given heat maps; v3 is in the tree cases below)
@pytest.mark.parametrize("version,objectives", AUX_CASES)
def test_aux_heads_match_jax(version, objectives):
    jc, tc, jm, variables, tm = models(version, objectives, seed=1)
    batch = make_batch(2)
    jout = jax_forward(jm, variables, batch)
    with torch.no_grad():
        tout = port_forward(tm, batch)
    outs = [k for k in AUX_OUTPUTS if k in jout]
    assert outs and set(outs) == {k for k in AUX_OUTPUTS if k in tout}
    for k in outs:
        assert tout[k].dtype == torch.float32
        assert_close(tout[k], jout[k], k)
    # the dead fifth step of story 2: -1e9 in the head logits
    if "head_logits" in outs:
        assert tout["head_logits"][2, 4] == -1e9
    want_loss, want = j_compute_loss(jc, jout, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
    got_loss, got = compute_loss(tc, tout, port_batch(batch))
    assert set(got) == set(want)
    assert {k for k in got if k.startswith("aux_")} == {
        f"aux_{o}" for o in ("head", "binary", "itm", "mlm")
        if f"{'bin' if o == 'binary' else o}_logits" in outs}
    for k in want:
        assert_close(got[k], want[k], k)
    assert_close(got_loss, want_loss, "loss")
    grads_match(jc, tc, jm, variables, tm, batch)


def test_aux_terms_without_their_batch_entries():
    # itm and mlm add no term when the batch has no targets or labels (a
    # text batch under `itm`, a step without the loop's masking)
    jc, tc, jm, variables, tm = models("p0", ("itm", "mlm"), seed=3)
    batch = {k: v for k, v in make_batch(4).items()
             if k not in ("itm_targets", "mlm_labels")}
    jout = jax_forward(jm, variables, batch)
    want_loss, want = j_compute_loss(jc, jout, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
    got_loss, got = compute_loss(tc, port_forward(tm, batch),
                                 port_batch(batch))
    assert set(got) == set(want) == {"loss"}
    assert_close(got_loss, want_loss)


TREE_CASES = {
    # v0: the aux heads are never called, so the JAX init makes none
    "v0_head_mlm": ("v0", ("head", "mlm"), set()),
    "v1_itm": ("v1", ("itm",), {"aux_heads"}),
    "p0_mlm": ("p0", ("mlm",), {"aux_mlm_head"}),
    "p1_binary_pairwise": ("p1", ("binary", "pairwise"), {"aux_heads"}),
    "v2_no_params": ("v2", ("mlm_wo_loss", "heatmap_pairwise_ranking"),
                     set()),
    "v3_all": ("v3", ("head", "binary", "itm", "mlm"),
               {"aux_heads", "aux_mlm_head"}),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_aux_tree_matches_jax_init(case):
    version, objectives, aux = TREE_CASES[case]
    jc, tc = cfgs(version, objectives, num_labels=2)
    jm = JSequencingModel(jc)
    ids = jnp.asarray(make_batch(0)["input_ids"][:1])
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              ids))["params"]
    assert set(params) - {"encoder", "cls_head", "heatmap_head",
                          "pointer_head"} == aux
    tm = SequencingModel(tc)
    assert sorted(tm.state_dict()) == sorted(tree_to_state_dict(params))
    if "aux_heads" in aux:
        want = {"hl_head_pred_layer": "head", "hl_bin_pred_layer": "binary",
                "seq_relationship": "itm"}
        assert set(params["aux_heads"]) == {
            k for k, o in want.items()
            if o in objectives or (o == "binary" and "pairwise" in objectives)}
    tm.load_state_dict(params_from_jax(params, tc))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("b", [1, 3, 8])
def test_plan_itm_swap_matches_jax(seed, b):
    images = np.random.default_rng(100 + seed).integers(
        0, 256, (b, N, 4, 4, 3)).astype(np.uint8)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want_img, want_t = j_plan_itm_swap(images, rj)
    got_img, got_t = plan_itm_swap(images, rt)
    assert np.array_equal(got_img, want_img)
    assert got_t.dtype == want_t.dtype and np.array_equal(got_t, want_t)
    assert rt.random() == rj.random()  # the same draws taken
    swapped = (got_img != images).reshape(b, -1).any(-1)
    assert np.array_equal(swapped, got_t == 0)


@pytest.mark.parametrize("objectives", [("mlm",), ("mlm_wo_loss", "itm"),
                                        ("itm",), ("head", "binary")])
@pytest.mark.parametrize("with_images", [True, False])
def test_loop_surgery_matches_jax_draws(objectives, with_images):
    # three batches through the port's `prepare` and through the JAX
    # loop's surgery (its code, in its order, from default_rng(seed + 7))
    _, tc = cfgs("v1", objectives)
    seed = 5
    prepare = tloop.aux_surgery(tc, seed)
    if not set(objectives) & {"mlm", "mlm_wo_loss", "itm"}:
        assert prepare is None
        return
    rng = np.random.default_rng(seed + 7)
    data = np.random.default_rng(0)
    for _ in range(3):
        batch = make_batch(int(data.integers(100)))
        batch = {k: batch[k] for k in ("input_ids", "attention_mask")}
        if with_images:
            batch["images"] = data.integers(0, 256, (4, N, 4, 4, 3)).astype(
                np.uint8)
        want = dict(batch)
        if set(objectives) & {"mlm", "mlm_wo_loss"}:
            want["input_ids"], want["mlm_labels"] = j_mask_tokens_sentence(
                np.asarray(batch["input_ids"]),
                mlm_probability=tc.mlm_probability, pad_id=tc.pad_id,
                cls_id=tc.cls_id, mask_id=tc.mask_id,
                vocab_size=tc.encoder.vocab_size,
                ignore_index=tc.mlm_ignore_index, rng=rng)
        if "itm" in objectives and "images" in batch:
            want["images"], want["itm_targets"] = j_plan_itm_swap(
                np.asarray(batch["images"]), rng)
        got = prepare(dict(batch))
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


# ----- the train CLI ----------------------------------------------------------


def _losses(out, tag="train/loss"):
    with open(os.path.join(str(out), "logs", "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == tag]


def main_train_both(monkeypatch, data_dir, tmp_path, task, version, *extra):
    """The JAX package's `main_train` on one device, then the port's from
    the same initial weights (the JAX init's, moved by
    `params_from_jax`), both at dropout 0."""
    _no_dropout_tiny(monkeypatch)
    captured = {}
    real = jloop.make_train_state

    def capture(*a, **kw):
        captured["state"] = real(*a, **kw)
        return captured["state"]

    monkeypatch.setattr(jloop, "make_train_state", capture)
    monkeypatch.setattr(jloop, "make_mesh", lambda n_model=1: make_mesh(
        n_data=1, devices=jax.devices()[:1]))
    argv = train_argv(data_dir, tmp_path / "jax", task, version, "--gelu_impl",
                      "erf", *extra)
    at = argv.index("--device")
    jstate = jcli.main_train(argv[:at] + argv[at + 2:])
    targv = train_argv(data_dir, tmp_path / "port", task, version,
                       "--gelu_impl", "erf", *extra)
    tc = tcli.build_config(tcli.parse_args("train", targv))[0]
    if task.endswith("pure_decode"):
        tc.hierarchical_version = "decode"
    sd = params_from_jax(jax.tree.map(np.asarray, captured["state"].params),
                         tc)
    monkeypatch.setattr(tloop, "init_weights",
                        lambda m, seed: (m.load_state_dict(sd), m)[1])
    return jstate, tcli.main_train(targv), tc


def test_main_train_with_mlm_matches_jax(wikihow_dir, tmp_path, monkeypatch):
    # v1 with mlm: the loop masks each batch from default_rng(seed + 7) in
    # both packages, so the two steps' losses agree only if the masks do
    jstate, res, tc = main_train_both(
        monkeypatch, wikihow_dir, tmp_path, "wikihow_hl_v1", "v1",
        "--hl_include_objectives", "mlm", "heatmap_pairwise_ranking")
    want = _losses(tmp_path / "jax")
    assert len(want) == 2
    np.testing.assert_allclose(_losses(tmp_path / "port"), want, rtol=1e-5)
    assert all(np.isfinite(h["aux_mlm"]) and h["aux_mlm"] > 0
               for h in res.history)
    final = params_from_jax(jax.tree.map(np.asarray, jstate.params), tc)
    for key, val in res.model.state_dict().items():
        atol = 2 * 1e-3 if key.endswith("key.bias") else 1e-5
        np.testing.assert_allclose(val.numpy(), final[key].numpy(), rtol=0,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("version,objectives,multimodal", [
    ("p0", ("head", "binary", "itm", "mlm"), False),
    ("v1", ("itm", "mlm_wo_loss"), True)])
def test_train_cli_with_aux_objectives(wikihow_dir, tmp_path, version,
                                       objectives, multimodal):
    # the objectives' terms in the logged metrics; with images, itm swaps
    # them (its term is logged), without, it adds nothing
    extra = ["--hl_include_objectives", *objectives]
    if multimodal:
        extra += ["--multimodal", "--vision_image_size", "32"]
    res = tcli.main_train(train_argv(wikihow_dir, tmp_path, "wikihow_hl_v1",
                                     version, *extra))
    terms = {k for h in res.history for k in h if k.startswith("aux_")}
    want = {"aux_head", "aux_binary", "aux_mlm"} if not multimodal else {
        "aux_itm"}
    assert terms == want
    assert all(np.isfinite(h[k]) for h in res.history for k in terms)
    saved = tcfg.MultimodalConfig.from_json(
        (tmp_path / "checkpoint-2" / "config.json").read_text())
    assert saved.hl_include_objectives == list(objectives)
