"""The port's pretraining against the JAX package's, on the CPU: MLM masking
and every objective planner (outputs identical from the same
`default_rng` state), `SequencingPretrainer` for each objective over the
text encoder and the CLIP encoder (`tiny_vit`; `tiny_rn` for the BatchNorm
statistics) on weights moved by `params_from_jax` (the loss dict, every
gradient and the statistics at dropout 0), the parameter tree of the
heads a configuration builds, `run_pretraining`'s objectives and plans
(init-time draws included) and losses over a few steps, and
`evaluate_pretraining`. Tiny f32 configs. Tolerances: losses and
statistics rtol 1e-5, atol 1e-6; gradients 1e-4 of each entry plus 1e-5 of
the gradient's largest entry (f32 sums in another order); behind the
tiny_rn tower's train-mode BatchNorms, where f32 gradients are
ill-conditioned, each gradient's distance within 1e-5 of the global norm
of JAX's f64 step, as test_torch_multimodal.py holds its tower's."""

import argparse
import copy
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sequencing_tpu.ops.preprocess  # noqa: F401 (imported
# before any trace: its module constants must not be built under jit)
from multimodal_sequencing_tpu.data import packing as jpacking
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.models import clip_visual as jclip
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models import multimodal_encoder as jmm
from multimodal_sequencing_tpu.models import pretrainer as jpre
from multimodal_sequencing_tpu.parallel.mesh import make_mesh
from multimodal_sequencing_tpu.train import loop as jloop
from multimodal_sequencing_tpu.train import mlm as jmlm
from multimodal_sequencing_tpu.train import objectives as jobj
from multimodal_sequencing_tpu.train.state import TrainState, make_optimizer
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models import multimodal_encoder as tmm
from multimodal_sequencing_tpu_torch.models import pretrainer as tpre
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
from multimodal_sequencing_tpu_torch.train import loop as tloop
from multimodal_sequencing_tpu_torch.train import mlm as tmlm
from multimodal_sequencing_tpu_torch.train import objectives as tobj
from multimodal_sequencing_tpu_torch.train import steps as tsteps
from multimodal_sequencing_tpu_torch.train.state import AdamW
from multimodal_sequencing_tpu_torch.train.steps import (device_batch,
                                                        pretrain_step)

torch.set_num_threads(1)

OBJECTIVES = (
    "image_swapping", "image_sequence_predictions",
    "whole_image_sequence_swapping", "multimodal_swapping", "margin_loss",
    "multimodal_margin_loss", "time_contrastive",
    "patch_based_image_swapping", "patch_based_image_sequence_predictions",
    "patch_based_mrm_classification", "swapping_based_nsp",
    "sequence_based_nsp")
PATCH = tuple(o for o in OBJECTIVES if o.startswith("patch_based"))
TOK = jtok.SimpleWordTokenizer(vocab_size=1000)
IDS = dict(cls_id=TOK.cls_token_id, pad_id=TOK.pad_token_id,
           mask_id=TOK.mask_token_id)
ENC = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _mask_kw(cfg):
    return dict(mlm_probability=0.15, pad_id=cfg.pad_id, cls_id=cfg.cls_id,
                mask_id=cfg.mask_id, vocab_size=cfg.encoder.vocab_size,
                ignore_index=cfg.mlm_ignore_index)


def _stories(lens, seed, n, seq, per_seq, res=None, pad_rows=0):
    """A packed batch of stories of `lens` steps (of `n`) with random words,
    the last row repeated `pad_rows` times as the loader pads a final
    batch, and (B, n, res, res, 3) uint8 step images (zeros past a story's
    length) when `res` is given."""
    rng = np.random.RandomState(seed)
    packer = jpacking.StoryPacker(TOK, seq, per_seq)
    rows = [packer.pack_story([" ".join(f"w{rng.randint(300)}" for _ in range(
        rng.randint(3, per_seq + 4))) for _ in range(m)]) for m in lens]
    rows += rows[-1:] * pad_rows
    batch = {k: np.stack([r[i] for r in rows]) for i, k in enumerate(
        ("input_ids", "attention_mask", "token_type_ids"))}
    if res:
        img = rng.randint(0, 256, (len(rows), n, res, res, 3)).astype(np.uint8)
        for i, m in enumerate(list(lens) + [lens[-1]] * pad_rows):
            img[i, m:] = 0
        batch["images"] = img
    return batch


def _assert_same(got, want, what=""):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
            assert np.asarray(g).dtype == w.dtype, (what, k)
        else:
            assert g == w and type(g) is type(w), (what, k, g, w)


# ----- host: masking and planners -------------------------------------------


@pytest.mark.parametrize("lens", [(5,), (5, 3, 4), (5, 2)])
def test_mask_tokens_sentence_matches_jax(lens):
    cfg = tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(), **IDS)
    batch = _stories(lens, 0, 5, 60, 12, pad_rows=1)
    for seed in (0, 1, 7):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):  # the generator's state carries over batches
            want = jmlm.mask_tokens_sentence(batch["input_ids"], rng=jr,
                                             **_mask_kw(cfg))
            got = tmlm.mask_tokens_sentence(batch["input_ids"], rng=tr,
                                            **_mask_kw(cfg))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
        assert tr.random() == jr.random()  # the same draws were taken
    assert (want[1] != cfg.mlm_ignore_index).any()


PLAN_CASES = {"b1": ((5,), 0), "short": ((5, 3, 5), 0),
              "padded": ((5, 4, 2), 2)}


@pytest.mark.parametrize("images", [True, False], ids=["images", "text"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("objective", OBJECTIVES + (
    "mlm_only", "no_mlm", "visual_mlm"))
def test_plan_objective_matches_jax(objective, case, images):
    # every output array of the mask + plan, for three seeds in a row of
    # one generator (its state carries over), on one story, a batch with a
    # short story (3 of 5 steps), and one padded by repeating its last row
    lens, pad = PLAN_CASES[case]
    kw = dict(max_story_length=5, patch_grid=3, **IDS)
    jc = jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(), **kw)
    tc = tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(), **kw)
    for seed in (0, 1, 2):
        batch = _stories(lens, seed, 5, 60, 12, res=4 if images else None,
                         pad_rows=pad)
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            out = []
            for mod, cfg, rng in ((jmlm, jc, jr), (tmlm, tc, tr)):
                b = dict(batch)
                b["input_ids"], b["mlm_labels"] = mod.mask_tokens_sentence(
                    batch["input_ids"], rng=rng, **_mask_kw(cfg))
                planner = jobj if mod is jmlm else tobj
                out.append(planner.plan_objective(objective, b, cfg, rng))
            (jb, ja), (tb, ta) = out
            _assert_same(tb, jb, f"{objective} batch")
            _assert_same(ta, ja, f"{objective} aux")
        assert tr.random() == jr.random()


def test_choose_objective_matches_jax():
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    picks = [tobj.choose_objective(OBJECTIVES, tr) for _ in range(40)]
    assert picks == [jobj.choose_objective(OBJECTIVES, jr) for _ in range(40)]
    assert set(picks) > {"margin_loss"}
    with pytest.raises(NotImplementedError):
        tobj.plan_objective("itm", {"input_ids": np.zeros((1, 4))},
                            tcfg.MultimodalConfig(), tr)


# ----- the model -------------------------------------------------------------

N, SEQ, PER_SEQ = 3, 36, 12
KINDS = {
    # text encoder: the objectives that need no folded visual stream
    "text": dict(objectives=tuple(o for o in OBJECTIVES if o not in PATCH)
                 + ("mlm_only",)),
    # tiny ViT (32 px, grid 4): every objective
    "vit": dict(objectives=OBJECTIVES + ("mlm_only",), res=32, grid=4),
    # tiny RN (96 px, grid 3): BatchNorm in train mode, statistics updated;
    # the tower frozen, as its train-mode f32 gradients are ill-conditioned
    # (test_torch_multimodal.py holds them to JAX's f64 run)
    "rn": dict(objectives=("image_swapping", "margin_loss",
                           "multimodal_margin_loss",
                           "patch_based_mrm_classification"),
               res=96, grid=3, freeze_vision_model=True),
}


def _cfgs(kind, **kw):
    spec = KINDS[kind]
    kw = dict(max_story_length=N, max_seq_length=SEQ,
              per_seq_max_length=PER_SEQ, **IDS, **kw)
    if kind != "text":
        kw.setdefault("freeze_vision_model",
                      spec.get("freeze_vision_model", False))
        kw.update(multimodal=True, patch_grid=spec["grid"],
                  image_size=(spec["res"],) * 2,
                  clip_model_name="RN50" if kind == "rn" else "ViT-B/32")
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**ENC),
                                  **kw),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**ENC),
                                  **kw))


def _vcfgs(kind):
    if kind == "text":
        return None, None
    if kind == "rn":
        res = KINDS["rn"]["res"]
        return (jclip.CLIPVisionConfig.tiny_rn(image_resolution=res),
                tcfg.CLIPVisionConfig.tiny_rn(image_resolution=res))
    return jclip.CLIPVisionConfig.tiny_vit(), tcfg.CLIPVisionConfig.tiny_vit()


def _planned(kind, objective, seed=0, lens=(3, 3, 3), pad=1):
    """A masked batch planned for `objective` (a full-story batch with a
    padded row: time_contrastive's JAX gradient is NaN where a missing
    step's CLS position repeats another's)."""
    jc, _ = _cfgs(kind)
    batch = _stories(lens, seed, N, SEQ, PER_SEQ, res=KINDS[kind].get("res"),
                     pad_rows=pad)
    rng = np.random.default_rng(seed)
    batch["input_ids"], batch["mlm_labels"] = jmlm.mask_tokens_sentence(
        batch["input_ids"], rng=rng, **_mask_kw(jc))
    nb, aux = jobj.plan_objective(objective, batch, jc, rng)
    return nb, {k: v for k, v in aux.items()
                if isinstance(v, np.ndarray) and v.ndim > 0}


def _modality_seed(modality):
    """The first seed whose multimodal_margin_loss plan draws `modality`."""
    for seed in range(50):
        jc, _ = _cfgs("text")
        batch = _stories((3, 3, 3), seed, N, SEQ, PER_SEQ, pad_rows=1)
        rng = np.random.default_rng(seed)
        batch["input_ids"], batch["mlm_labels"] = jmlm.mask_tokens_sentence(
            batch["input_ids"], rng=rng, **_mask_kw(jc))
        _, aux = jobj.plan_objective("multimodal_margin_loss", batch, jc, rng)
        if aux["modality"] == modality:
            return seed
    raise AssertionError(modality)


def _jb(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_shapes(model, kind, objectives):
    """The shapes of the JAX package's init tree: one trace of each
    objective, the trees merged (`train/loop.py::run_pretraining`),
    traced abstractly (no compute)."""
    shapes = {}
    for obj in objectives:
        nb, aux = _planned(kind, obj)
        v = jax.eval_shape(functools.partial(model.init, objective=obj),
                           jax.random.PRNGKey(0), _jb(nb), aux=_jb(aux))
        shapes = jloop._merge_variable_trees(shapes, dict(v))
    return shapes


def _random_tree(shapes, seed):
    """f32 values for a variable tree of `shapes`, on the scales of an
    init: kernels of std 1/sqrt(fan in), tables of std 1/sqrt(features),
    scales near 1 and biases near 0 (random, so each has a gradient of its
    own), BatchNorm variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
        elif name == "embedding":
            std = shape[-1] ** -0.5
        elif name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:  # biases, BatchNorm means, the CLIP towers' raw parameters
            std = 0.1
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


class Pair:
    """One JAX `SequencingPretrainer` with every head of `kind`, on random
    weights, and the port's on the same weights."""

    def __init__(self, kind):
        self.kind = kind
        self.jc, self.tc = _cfgs(kind)
        self.jv, self.tv = _vcfgs(kind)
        objectives = KINDS[kind]["objectives"]
        self.jm = jpre.SequencingPretrainer(self.jc, self.jv)
        self.vars = _random_tree(_jax_shapes(self.jm, kind, objectives), 0)
        self.sd = params_from_jax(self.vars["params"], self.tc,
                                  self.vars.get("batch_stats"), self.tv)
        self.tm = tpre.SequencingPretrainer(dataclasses.replace(
            self.tc, multimodal_pretrain_objectives=list(objectives)),
            self.tv)
        self.tm.load_state_dict(self.sd)
        bs = {k: v for k, v in self.vars.items() if k != "params"}

        def run(objective, params, nb, aux):
            def f(p):
                losses, ms = self.jm.apply(
                    {"params": p, **bs}, nb, objective, aux,
                    deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(1)},
                    mutable=list(bs))
                return losses["loss"], (losses, ms)
            (_, (losses, ms)), g = jax.value_and_grad(f, has_aux=True)(params)
            return losses, g, ms

        self._jax_train = jax.jit(run, static_argnums=0)
        if kind == "rn":  # the same step in f64
            with jax.enable_x64():
                jm64 = jpre.SequencingPretrainer(
                    dataclasses.replace(self.jc, encoder=dataclasses.replace(
                        self.jc.encoder, dtype="float64")),
                    dataclasses.replace(self.jv, dtype="float64"))

                def grad64(objective, params, nb, aux):
                    def f(p):
                        losses, _ = jm64.apply(
                            {"params": p, **bs}, nb, objective, aux,
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)},
                            mutable=list(bs))
                        return losses["loss"]
                    return jax.grad(f)(params)

                self._jax_grad64 = jax.jit(grad64, static_argnums=0)

    def jax_grad64(self, nb, aux, objective):
        """The gradients of JAX's train-mode step in f64 (tiny_rn)."""
        with jax.enable_x64():
            f64 = jax.tree.map(lambda x: np.asarray(x, np.float64),
                               self.vars["params"])
            g = self._jax_grad64(objective, f64, _jb(nb), _jb(aux))
            return tree_to_state_dict(_np(g))

    def jax_train(self, nb, aux, objective):
        """JAX's train-mode loss dict, gradients and batch statistics."""
        losses, g, ms = self._jax_train(objective, self.vars["params"],
                                        _jb(nb), _jb(aux))
        return _np(losses), tree_to_state_dict(_np(g)), _np(ms)

    def port_train(self, nb, aux, objective):
        self.tm.load_state_dict(self.sd)
        self.tm.train()
        self.tm.zero_grad()
        losses = self.tm(device_batch(nb, "cpu"), objective,
                         device_batch(aux, "cpu"), deterministic=False,
                         rng=DropoutRng(1, 0, "cpu"))
        losses["loss"].backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.tm.named_parameters()}
        return losses, grads


_PAIRS = {}


def _pair(kind) -> Pair:
    if kind not in _PAIRS:
        _PAIRS[kind] = Pair(kind)
    return _PAIRS[kind]


# a gradient whose largest entry is below this is f32 rounding of a zero
# gradient
GRAD_NOISE = 1e-6


def _model_cases():
    for kind, spec in KINDS.items():
        for obj in spec["objectives"]:
            if obj == "multimodal_margin_loss":
                for modality in ("multimodal", "text_only", "image_only"):
                    yield kind, obj, modality
            else:
                yield kind, obj, None


@pytest.mark.parametrize("kind,objective,modality", list(_model_cases()))
def test_pretrainer_matches_jax(kind, objective, modality):
    # the loss dict, every gradient and (tiny_rn) the BatchNorm statistics
    # of one train-mode step at dropout 0
    p = _pair(kind)
    seed = _modality_seed(modality) if modality else 0
    nb, aux = _planned(kind, objective, seed)
    want, want_g, want_ms = p.jax_train(nb, aux, objective)
    got, got_g = p.port_train(nb, aux, objective)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert set(got_g) == set(want_g)
    top = max(float(np.abs(w.numpy()).max()) for w in want_g.values())
    if top <= GRAD_NOISE:
        # a loss that no parameter moves (the text encoder's image_only
        # margin: both halves are the same lone CLS token): rounding noise
        assert max(float(g.abs().max()) for g in got_g.values()) <= GRAD_NOISE
    if kind == "rn":
        # behind the train-mode BatchNorms the f32 gradients are
        # ill-conditioned: each gradient's distance over the global norm of
        # JAX's f64 step, as test_torch_multimodal.py holds its tower's
        exact = p.jax_grad64(nb, aux, objective)
        total = sum(float((w.double() ** 2).sum())
                    for w in exact.values()) ** 0.5
        for name, w in exact.items():
            err = (got_g[name].double() - w.double()).norm().item() / total
            assert err <= 1e-5, (name, err)
    for name, w in want_g.items():
        if kind == "rn":
            continue
        w = w.numpy()
        err = np.abs(got_g[name].numpy() - w) - 1e-4 * np.abs(w)
        assert err.max() <= 1e-5 * max(top, GRAD_NOISE * 1e5), (
            name, err.max() / top)
    if want_ms.get("batch_stats"):
        stats = tree_to_state_dict({}, want_ms["batch_stats"])
        mine = p.tm.state_dict()
        assert stats
        for key, val in stats.items():
            np.testing.assert_allclose(mine[key].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        moved = any(not torch.equal(mine[k], p.sd[k]) for k in stats)
        assert moved == (nb.get("images") is not None)


@pytest.mark.parametrize("kind", ["text", "vit"])
def test_pretrainer_eval_matches_jax(kind):
    # deterministic mlm_only and a binary objective, as the dev eval runs
    p = _pair(kind)
    p.tm.load_state_dict(p.sd)
    p.tm.eval()
    for obj in ("mlm_only", "swapping_based_nsp"):
        nb, aux = _planned(kind, obj, seed=4)
        want = _np(jax.jit(functools.partial(p.jm.apply, objective=obj))(
            p.vars, _jb(nb), aux=_jb(aux)))
        with torch.no_grad():
            got = p.tm(device_batch(nb, "cpu"), obj, device_batch(aux, "cpu"))
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("objective", PATCH)
def test_patch_objectives_need_the_visual_stream(objective):
    # both packages raise ValueError without the folded CLIP stream
    p = _pair("text")
    nb, aux = _planned("vit", objective)
    nb.pop("images")
    with pytest.raises(ValueError):
        p.jm.apply(p.vars, _jb(nb), objective, _jb(aux))
    with pytest.raises(ValueError, match="folded CLIP"):
        p.tm(device_batch(nb, "cpu"), objective, device_batch(aux, "cpu"))


def test_patch_grid_must_match_the_tower():
    # JAX's gathers clamp the plan's out-of-range indices; the port refuses
    # a plan whose stream is not the tower's (it would fault on the card)
    p = _pair("vit")
    tc = dataclasses.replace(
        p.tc, patch_grid=3,
        multimodal_pretrain_objectives=["patch_based_image_swapping"])
    tm = tpre.SequencingPretrainer(tc, p.tv)
    nb, aux = _planned("vit", "patch_based_image_swapping")
    aux["patch_perm"] = aux["patch_perm"][:, :1 + 2 * 9]
    with pytest.raises(ValueError, match="patch_grid 3"):
        tm(device_batch(nb, "cpu"), "patch_based_image_swapping",
           device_batch(aux, "cpu"))


# the objective lists of the launchers and a few more, and the heads
# their JAX init creates
TREES = {
    "text_default": ("text", [], {}),
    "text_no_mlm": ("text", ["no_mlm", "margin_loss", "time_contrastive"],
                    {}),
    "text_nsp": ("text", ["swapping_based_nsp", "sequence_based_nsp",
                          "visual_mlm"], {}),
    "wikihow_pretrain": ("rn", ["image_swapping",
                                "patch_based_image_swapping",
                                "patch_based_mrm_classification"], {}),
    "image_only": ("rn", ["patch_based_mrm_classification"],
                   dict(multimodal_img_part=True)),
    "margins": ("vit", ["margin_loss", "multimodal_margin_loss",
                        "multimodal_swapping"], {}),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_parameter_tree_matches_jax_init(name):
    # the port builds exactly the heads the JAX init traces into being
    # (mlm_head even with no_mlm: that init always runs MLM; none with
    # multimodal_img_part; no time_contrastive head)
    kind, names, kw = TREES[name]
    jc, tc = _cfgs(kind, multimodal_pretrain_objectives=names, **kw)
    jv, tv = _vcfgs(kind)
    objectives, _ = tpre.resolve_objectives(names)
    shapes = _jax_shapes(jpre.SequencingPretrainer(jc, jv), kind, objectives)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = tree_to_state_dict(zeros["params"], zeros.get("batch_stats"))
    got = tpre.SequencingPretrainer(tc, tv).state_dict()
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert ("mlm_head.bias" in got) == (not kw)
    # and params_from_jax picks the same model from the tree
    assert sorted(params_from_jax(zeros["params"], tc,
                                  zeros.get("batch_stats"), tv)) == sorted(got)


def test_visual_feature_encoder_promotes_as_flax():
    # bf16 Dense, then a LayerNorm that returns f32 (Flax promotes to its
    # f32 parameters), the values Flax's
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    jm = jmm.VisualFeatEncoder(32, 0.0, jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    tm = tmm.VisualFeatEncoder(48, 32, 0.0, torch.bfloat16)
    tm.load_state_dict(tree_to_state_dict(_np(v["params"])))
    got = tm(torch.from_numpy(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


# ----- the loop and the dev eval ---------------------------------------------


class _ListDataset:
    def __init__(self, items):
        self._items = items

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i, epoch=0):
        return self._items[i]


def _dataset(kind, n_items, seed):
    items = []
    for i in range(n_items):
        b = _stories((N,), seed + i, N, SEQ, PER_SEQ,
                     res=KINDS[kind].get("res"))
        items.append({k: v[0] for k, v in b.items()})
    return _ListDataset(items)


def _loop_args(out, **kw):
    base = dict(per_gpu_train_batch_size=2, per_gpu_eval_batch_size=2,
                learning_rate=1e-4, weight_decay=0.01, adam_epsilon=1e-8,
                max_grad_norm=1.0, num_train_epochs=1, max_steps=4,
                warmup_steps=1, gradient_accumulation_steps=1,
                logging_steps=1, save_steps=0, seed=3, output_dir=str(out),
                mlm_probability=0.15, model_name_or_path="simple",
                evaluate_during_training=False, max_eval_steps=None,
                clip_visual_model_weights=None, overwrite_output_dir=True,
                do_not_load_optimizer=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _recorder(module, log):
    real = module.plan_objective

    def record(objective, batch, cfg, rng, *a, **kw):
        nb, aux = real(objective, batch, cfg, rng, *a, **kw)
        log.append((objective, nb, aux))
        return nb, aux
    return record


def _scalars(out, tag):
    with open(os.path.join(str(out), "logs", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r["tag"] == tag]


def test_run_pretraining_matches_jax(monkeypatch, tmp_path):
    # one seed: the same objectives and plans, the JAX init's draws on the
    # first batch included, in the same order; from the same weights at
    # dropout 0, the same losses for 4 steps (5 stories a pass: the last
    # batch padded)
    objectives = ["image_swapping", "patch_based_mrm_classification"]
    jc, tc = _cfgs("vit", multimodal_pretrain_objectives=objectives)
    jv, tv = _vcfgs("vit")
    ds = _dataset("vit", 5, 10)
    jlog, tlog = [], []
    monkeypatch.setattr(jloop, "plan_objective", _recorder(jloop, jlog))
    monkeypatch.setattr(tloop, "plan_objective", _recorder(tloop, tlog))
    # both start from the same random weights (in place of the inits)
    given = _random_tree(_jax_shapes(jpre.SequencingPretrainer(jc, jv),
                                     "vit", objectives), 5)

    class GivenInit(jpre.SequencingPretrainer):
        def init(self, *args, **kwargs):
            return given

    jloop.run_pretraining(jc, GivenInit(jc, jv), ds,
                          _loop_args(tmp_path / "jax"), tokenizer=None,
                          mesh=make_mesh(n_data=1,
                                         devices=jax.devices()[:1]))
    sd = params_from_jax(given["params"], tc, None, tv)
    monkeypatch.setattr(tloop, "init_weights",
                        lambda m, seed: (m.load_state_dict(sd), m)[1])
    res = tloop.run_pretraining(tc, tpre.SequencingPretrainer(tc, tv), ds,
                                _loop_args(tmp_path / "port"), "cpu")
    assert len(tlog) == len(jlog) == len(objectives) + 4
    for (to, tb, ta), (jo, jb, ja) in zip(tlog, jlog):
        assert to == jo
        _assert_same(tb, jb, to)
        _assert_same(ta, ja, to)
    assert res.global_step == 4
    want = _scalars(tmp_path / "jax", "pretrain/loss")
    got = _scalars(tmp_path / "port", "pretrain/loss")
    assert len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_scalars(tmp_path / "port", "pretrain/mlm"),
                               _scalars(tmp_path / "jax", "pretrain/mlm"),
                               rtol=1e-5, atol=1e-6)


def test_evaluate_pretraining_matches_jax():
    # the same dict on the same weights: eval_loss, eval_mlm, perplexity,
    # 5 stories in batches of 2 (the last padded), then max_eval_steps
    p = _pair("vit")
    p.tm.load_state_dict(p.sd)
    ds = _dataset("vit", 5, 20)
    tx = make_optimizer()
    params = p.vars["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), model_state={}, tx=tx,
                       apply_fn=p.jm.apply)
    args = _loop_args("unused")
    for steps in (None, 2):
        want = jloop.evaluate_pretraining(
            p.jc, state, args, ds, max_eval_steps=steps,
            mesh=make_mesh(n_data=1, devices=jax.devices()[:1]))
        got = tloop.evaluate_pretraining(p.tc, p.tm, args, ds,
                                         max_eval_steps=steps)
        assert set(got) == set(want) == {"eval_loss", "eval_mlm",
                                         "eval_perplexity"}
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)


def test_pretrain_step_with_no_loss_term():
    # `no_mlm` alone: the total is a zero on the graph, so the step's
    # backward runs and every gradient is zero, as in the JAX step
    model = copy.deepcopy(_pair("text").tm)
    nb, aux = _planned("text", "mlm_only")
    opt = AdamW(model, learning_rate=1e-3, warmup_steps=1, total_steps=10)
    out = pretrain_step(model, opt, nb, aux, "mlm_only", 0, 0, use_mlm=False)
    assert set(out) == {"loss", "grad_norm"}
    assert float(out["loss"]) == 0.0 and float(out["grad_norm"]) == 0.0
    grads = [q.grad for q in model.parameters() if q.grad is not None]
    assert grads and not any(bool(g.any()) for g in grads)


def test_update_needs_a_loss_on_the_graph():
    # a loss that lost its graph raises, not a step on zero gradients
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError):
        tsteps._update(AdamW(model), torch.zeros(()))


@pytest.mark.parametrize("max_steps,want", [(4, [2, 4]), (3, [2, 3])])
def test_final_checkpoint_written_once(monkeypatch, tmp_path, max_steps,
                                       want):
    # saves every 2 steps, then the final save, which a save at the last
    # step has already written (the JAX loop writes it again, unchanged)
    saved = []
    real = tloop.save_checkpoint

    def record(out, step, *a, **kw):
        saved.append(step)
        return real(out, step, *a, **kw)

    monkeypatch.setattr(tloop, "save_checkpoint", record)
    _, tc = _cfgs("text", multimodal_pretrain_objectives=["margin_loss"])
    res = tloop.run_pretraining(
        tc, tpre.SequencingPretrainer(tc), _dataset("text", 8, 30),
        _loop_args(tmp_path, max_steps=max_steps, save_steps=2), "cpu")
    assert res.global_step == max_steps
    assert saved == want
    assert all((tmp_path / f"checkpoint-{s}" / "model.pt").is_file()
               for s in want)
