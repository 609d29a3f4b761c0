"""The port's multimodal CLIP path against the JAX package's, on the CPU:
the uint8 image tail (`ops/preprocess.py`), the Flax BatchNorm, the RN50
tower (both folds, img_len 1 and 3, train mode with its BatchNorm
statistics, `skip_last_layer`), the attention pool, the ViT tower (and its
ViLT text mode), the multimodal encoder's three modes, the multimodal
sequencer's forward and 4 train steps at dropout 0 (loss, every gradient
and the BatchNorm statistics after each step; with `freeze_vision_model`
along the port's own trajectory, with a trained tower along the JAX
package's, its gradients held to its f64 run), the image loaders, the
WikiHow image half and the datasets' image batches. Tiny towers (`tiny_rn`, `tiny_vit`), weights moved
from Flax by `params_from_jax`; every comparison states its tolerance."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import images as jimages
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import get_processor as j_get_processor
from multimodal_sequencing_tpu.models import clip_visual as jclip
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.multimodal_encoder import (
    MultimodalEncoder as JMultimodalEncoder)
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.ops.preprocess import (
    preprocess_uint8_images as j_preprocess)
from multimodal_sequencing_tpu.train.state import (
    TrainState, make_optimizer as j_make_optimizer)
from multimodal_sequencing_tpu.train.steps import compute_loss as j_compute_loss
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import images as timages
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.registry import get_processor as t_get_processor
from multimodal_sequencing_tpu_torch.models import clip_visual as tclip
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
from multimodal_sequencing_tpu_torch.models.multimodal_encoder import (
    MultimodalEncoder)
from multimodal_sequencing_tpu_torch.models.sequencer import SequencingModel
from multimodal_sequencing_tpu_torch.ops.preprocess import (
    preprocess_uint8_images)
from multimodal_sequencing_tpu_torch.train.state import AdamW
from multimodal_sequencing_tpu_torch.train.steps import (
    compute_loss, device_batch)

torch.set_num_threads(1)

N_IMG, SEQ = 3, 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jit(method, **static):
    """`method` (a Flax `init` or `apply`) jitted with its static keyword
    arguments bound: one compile in place of eager op-by-op dispatch."""
    return jax.jit(functools.partial(method, **static))


def _vcfgs(clip, **kw):
    if clip == "RN50":  # 64 px: a 2 x 2 grid, so the fold has 4 patches
        kw.setdefault("image_resolution", 64)
        return jclip.CLIPVisionConfig.tiny_rn(**kw), \
            tcfg.CLIPVisionConfig.tiny_rn(**kw)
    return jclip.CLIPVisionConfig.tiny_vit(**kw), \
        tcfg.CLIPVisionConfig.tiny_vit(**kw)


def _cfgs(clip="RN50", **kw):
    enc = dict(max_position_embeddings=200, type_vocab_size=N_IMG,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    res = 64 if clip == "RN50" else 32
    common = dict(hierarchical_version="v1", max_story_length=N_IMG,
                  max_seq_length=SEQ, per_seq_max_length=12, multimodal=True,
                  clip_model_name=clip, image_size=(res, res), **kw)
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc),
                                  **common),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc),
                                  **common))


def _batch(res, b=2, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 1000, (b, SEQ)).astype(np.int32)
    ids[:, ::SEQ // N_IMG] = 0  # a CLS a step
    am = np.ones((b, SEQ), np.int32)
    am[-1, SEQ - 9:] = 0
    return {"input_ids": ids, "attention_mask": am,
            "token_type_ids": (np.arange(SEQ) // (SEQ // N_IMG)).clip(
                max=N_IMG - 1)[None].repeat(b, 0).astype(np.int32),
            "images": rng.randint(0, 256, (b, N_IMG, res, res, 3)).astype(
                np.uint8),
            "labels": np.stack([rng.permutation(N_IMG)
                                for _ in range(b)]).astype(np.int32),
            "valid": np.ones(b, bool)}


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


# ----- preprocessing ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["imagenet", "detectron2_bgr"])
@pytest.mark.parametrize("src,size", [((40, 56), (32, 32)),  # downsample
                                      ((20, 24), (32, 32)),  # upsample
                                      ((32, 32), (32, 32))])  # no resize
def test_preprocess_matches_jax(mode, src, size):
    u8 = np.random.default_rng(0).integers(0, 256, (2, 3) + src + (3,),
                                           dtype=np.uint8)
    for chw in (True, False):
        want = np.asarray(j_preprocess(jnp.asarray(u8), size=size,
                                       to_chw=chw, mode=mode))
        got = preprocess_uint8_images(_t(u8), size=size, to_chw=chw,
                                      mode=mode).numpy()
        assert got.shape == want.shape
        # f32 sums of the resize weights in another order: 1e-5 of the
        # largest value (~150 detectron2, ~2.6 imagenet); without antialias
        # the downsampled case would be off by tenths
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                                   rtol=0)


# ----- BatchNorm -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_flax(dtype, train):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 5, 4, 8)) * 3 + 2).astype(np.float32)  # NHWC
    jdt = jnp.dtype(dtype)
    mod = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                        epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                            "bias": rng.standard_normal(8).astype(np.float32)},
                 "batch_stats": {"mean": rng.standard_normal(8).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}
    if train:
        want, upd = mod.apply(variables, jnp.asarray(x, jdt),
                              mutable=["batch_stats"])
        upd = _np(upd)["batch_stats"]
    else:
        want, upd = mod.apply(variables, jnp.asarray(x, jdt)), None
    bn = tclip.BatchNorm(8, getattr(torch, dtype))
    bn.load_state_dict(tree_to_state_dict(variables["params"],
                                          variables["batch_stats"]))
    xt = _t(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with torch.no_grad():
        got = bn(xt, deterministic=not train).permute(0, 2, 3, 1)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    # f32: the same formula, f32 sums in another order; bf16: one bf16 ulp
    # of the output (|y| up to ~10)
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    if train:  # the running averages: biased variance, momentum 0.9
        np.testing.assert_allclose(bn.running_mean.numpy(), upd["mean"],
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), upd["var"],
                                   atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_array_equal(bn.running_mean.numpy(),
                                      variables["batch_stats"]["mean"])


# ----- towers ----------------------------------------------------------------


def _tower_pair(jmod, tmod, x_nhwc, **kw):
    variables = _np(_jit(jmod.init, **kw)(jax.random.PRNGKey(3),
                                          jnp.asarray(x_nhwc)))
    tmod.load_state_dict(tree_to_state_dict(variables["params"],
                                            variables.get("batch_stats")))
    return variables


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("img_len", [1, 3])
@pytest.mark.parametrize("train", [False, True])
def test_modified_resnet_matches_jax(quirk, img_len, train):
    jv, tv = _vcfgs("RN50", ref_fold_quirk=quirk)
    x = np.random.default_rng(2).standard_normal(
        (2 * img_len, 64, 64, 3)).astype(np.float32)
    jm, tm = jclip.ModifiedResNet(jv), tclip.ModifiedResNet(tv)
    variables = _tower_pair(jm, tm, x, img_len=img_len)
    xt = _t(x).permute(0, 3, 1, 2)
    # skip_last_layer returns the trunk before the pool, where the fold
    # plays no part: one fold and length are enough for it
    for skip in (False, True) if (quirk, img_len) == (False, 3) else (False,):
        kw = dict(skip_last_layer=skip, img_len=img_len)
        if train:
            want, upd = _jit(jm.apply, deterministic=False,
                             mutable=["batch_stats"], **kw)(variables,
                                                            jnp.asarray(x))
        else:
            want, upd = _jit(jm.apply, **kw)(variables, jnp.asarray(x)), None
        fresh = tclip.ModifiedResNet(tv)
        fresh.load_state_dict(tm.state_dict())
        with torch.no_grad():
            got = fresh(xt, deterministic=not train, **kw)
        if skip:  # (B * L, C, h, w) against NHWC
            got = got.permute(0, 2, 3, 1)
        want = np.asarray(want)
        assert got.shape == want.shape
        # f32 through 4 bottlenecks: sums in another order, relative to the
        # largest entry; in train mode each BatchNorm normalizes by the
        # statistics of few samples a channel (24 at the last stage),
        # which magnifies those differences tenfold
        rel = 1e-4 if train else 1e-5
        np.testing.assert_allclose(got.numpy(), want, rtol=10 * rel,
                                   atol=rel * np.abs(want).max())
        if train:  # every BatchNorm's updated running averages
            stats = tree_to_state_dict({}, _np(upd)["batch_stats"])
            got_stats = {k: v for k, v in fresh.state_dict().items()
                         if k in stats}
            assert len(got_stats) == len(stats) == 2 * 19
            for key, val in stats.items():
                np.testing.assert_allclose(got_stats[key].numpy(),
                                           val.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=key)


def test_folds_differ_and_keep_their_layout():
    # the clean fold keeps each patch's channels together; the quirk
    # interleaves channels and images (the reference's NCHW reshape)
    _, tv = _vcfgs("RN50")
    pool = tclip.AttentionPool2d(tv)
    x = torch.arange(2 * 3 * 256 * 2 * 2, dtype=torch.float32).reshape(
        6, 256, 2, 2)
    clean = pool.fold(x, 3)
    assert torch.equal(clean[1, 5], x[3 + 5 // 4, :, (5 % 4) // 2, 5 % 2])
    pool.cfg.ref_fold_quirk = True
    quirk = pool.fold(x, 3)
    flat = x[3:].reshape(-1)
    assert torch.equal(quirk[1, :, 7], flat[7 * 12:8 * 12])
    assert not torch.equal(clean, quirk)


def test_attention_pool_matches_jax():
    jv, tv = _vcfgs("RN50")
    x = np.random.default_rng(4).standard_normal(
        (6, 2, 2, 256)).astype(np.float32)
    jm, tm = jclip.AttentionPool2d(jv), tclip.AttentionPool2d(tv)
    variables = _tower_pair(jm, tm, x, img_len=3)
    want = np.asarray(_jit(jm.apply, img_len=3)(variables, jnp.asarray(x)))
    got = tm(_t(x).permute(0, 3, 1, 2), 3).detach().numpy()
    assert got.shape == (2, 3 * 4 + 1, 2 * tv.output_dim)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # f32


@pytest.mark.parametrize("text", [False, True])
def test_visual_transformer_matches_jax(text):
    jv, tv = _vcfgs("ViT-B/32")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    jm, tm = jclip.VisualTransformer(jv), tclip.VisualTransformer(tv)
    variables = _tower_pair(jm, tm, x, img_len=3)
    xt = _t(x).permute(0, 3, 1, 2)
    cases = [dict(), dict(skip_last_layer=True)]
    if text:
        emb = rng.standard_normal((2, 7, 32)).astype(np.float32)
        mask = np.ones((2, 7), np.int32)
        mask[1, 4:] = 0
        cases = [dict(text_embedding=emb, text_mask=mask),
                 dict(text_embedding=emb)]
    for kw in cases:
        static = {k: v for k, v in kw.items() if isinstance(v, bool)}
        arrays = {k: jnp.asarray(v) for k, v in kw.items()
                  if not isinstance(v, bool)}
        want = np.asarray(_jit(jm.apply, img_len=3, **static)(
            variables, jnp.asarray(x), **arrays))
        with torch.no_grad():
            got = tm(xt, img_len=3, **{k: _t(v) for k, v in kw.items()})
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_img_part_under_the_heatmap_heads_raises():
    # the language is cut to one CLS token, so the steps' CLS positions lie
    # outside the encoded sequence: the JAX gather fills them with NaN,
    # the port refuses the configuration
    jc, tc = _cfgs("RN50", multimodal_img_part=True)
    jv, tv = _vcfgs("RN50")
    batch = _batch(64)
    jm = JSequencingModel(jc, jv)
    jin = [jnp.asarray(batch[k]) for k in
           ("input_ids", "attention_mask", "token_type_ids")]
    variables = _jit(jm.init)(jax.random.PRNGKey(0), *jin,
                              images=jnp.asarray(batch["images"]))
    hm = _jit(jm.apply)(variables, *jin,
                        images=jnp.asarray(batch["images"]))["heatmap"]
    assert np.isnan(np.asarray(hm)).any()
    with pytest.raises(ValueError, match="multimodal_img_part"):
        SequencingModel(tc, tv)


def test_vit_wider_output_than_width_raises():
    # the JAX encoder fails on it with a broadcasting TypeError; the port
    # refuses it when the encoder is built
    _, tc = _cfgs("ViT-B/32")
    with pytest.raises(ValueError, match="output_dim == vit_width"):
        MultimodalEncoder(tc, tcfg.CLIPVisionConfig.tiny_vit(output_dim=16))
    assert tcfg.CLIPVisionConfig.tiny_vit().feat_dim == 32
    assert tcfg.CLIPVisionConfig.rn50().feat_dim == 2048


# ----- the encoder and the sequencer -----------------------------------------


@pytest.mark.parametrize("clip,mode", [("RN50", "joint"), ("RN50", "text_part"),
                                       ("RN50", "img_part"),
                                       ("ViT-B/32", "joint")])
def test_multimodal_encoder_modes_match_jax(clip, mode):
    kw = {"text_part": dict(multimodal_text_part=True),
          "img_part": dict(multimodal_img_part=True), "joint": {}}[mode]
    jc, tc = _cfgs(clip, **kw)
    jv, tv = _vcfgs(clip)
    batch = _batch(tc.image_size[0], seed=6)
    jenc, tenc = JMultimodalEncoder(jc, jv), MultimodalEncoder(tc, tv)
    jin = [jnp.asarray(batch[k]) for k in
           ("input_ids", "attention_mask", "token_type_ids")]
    variables = _np(_jit(jenc.init)(jax.random.PRNGKey(0), *jin,
                                    images=jnp.asarray(batch["images"])))
    tenc.load_state_dict(tree_to_state_dict(variables["params"],
                                            variables.get("batch_stats")))
    want = _jit(jenc.apply)(variables, *jin,
                            images=jnp.asarray(batch["images"]))
    with torch.no_grad():
        got = tenc(*[_t(batch[k]).long() for k in
                     ("input_ids", "attention_mask", "token_type_ids")],
                   images=_t(batch["images"]))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)  # f32
    if mode == "img_part":
        assert got[0].shape[1] == 1
    if mode == "text_part":
        assert not hasattr(tenc, "visual_model")


@pytest.mark.parametrize("clip,quirk", [("RN50", False), ("RN50", True),
                                        ("ViT-B/32", False)])
def test_sequencing_model_forward_matches_jax(clip, quirk):
    jc, tc = _cfgs(clip)
    jv, tv = _vcfgs(clip, ref_fold_quirk=quirk)
    batch = _batch(tc.image_size[0], seed=7)
    jm = JSequencingModel(jc, jv)
    jin = [jnp.asarray(batch[k]) for k in
           ("input_ids", "attention_mask", "token_type_ids")]
    variables = _np(_jit(jm.init)(jax.random.PRNGKey(1), *jin,
                                  images=jnp.asarray(batch["images"])))
    tm = SequencingModel(tc, tv).eval()
    tm.load_state_dict(params_from_jax(variables["params"], tc,
                                       variables.get("batch_stats"), tv))
    want = _jit(jm.apply)(variables, *jin,
                          images=jnp.asarray(batch["images"]))
    with torch.no_grad():
        got = tm(*[_t(batch[k]).long() for k in
                   ("input_ids", "attention_mask", "token_type_ids")],
                 images=_t(batch["images"]))
    # f32: the heat map within 1e-5, the joint stream's visual part 1e-4
    np.testing.assert_allclose(got["heatmap"].numpy(),
                               np.asarray(want["heatmap"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["visual_output"].numpy(),
                               np.asarray(want["visual_output"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got["present"].numpy(),
                                  np.asarray(want["present"]))


def _jax_grad_fn(jm, jc):
    """The JAX train step's loss, BatchNorm update and gradients (its
    `make_train_step` loss_fn at dropout 0), jitted."""
    @jax.jit
    def fn(params, batch_stats, batch):
        def loss_fn(p):
            out, new_ms = jm.apply(
                {"params": p, "batch_stats": batch_stats},
                batch["input_ids"], batch["attention_mask"],
                batch["token_type_ids"], images=batch["images"],
                deterministic=False, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(2)})
            return j_compute_loss(jc, out, batch)[0], new_ms["batch_stats"]

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return fn


def _jax_state(jm, batch, **kw):
    """`make_train_state` for `jm` with its init jitted."""
    variables = dict(_jit(jm.init, deterministic=True)(
        jax.random.PRNGKey(0), *[jnp.asarray(batch[k]) for k in (
            "input_ids", "attention_mask", "token_type_ids")],
        images=jnp.asarray(batch["images"])))
    params = variables.pop("params")
    tx = j_make_optimizer(**kw)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), model_state=variables,
                      tx=tx, apply_fn=jm.apply)


def _jax_step_fn(jm, jc):
    """One jitted JAX train step, as `make_train_step` runs it: (new state,
    loss, gradients, updated BatchNorm statistics)."""
    grad_fn = _jax_grad_fn(jm, jc)

    @jax.jit
    def step(state, batch):
        (loss, stats), grads = grad_fn(
            state.params, state.model_state["batch_stats"], batch)
        return (state.apply_gradients(grads,
                                      model_state={"batch_stats": stats}),
                loss, grads, stats)

    return step


def _port_step(model, tc, batch, step):
    """The port's train-mode forward and backward on `batch`: (loss,
    {name: gradient}, zeros where none)."""
    db = device_batch(batch, "cpu")
    out = model.train()(db["input_ids"], db["attention_mask"],
                        db["token_type_ids"], images=db["images"],
                        deterministic=False, rng=DropoutRng(1, step, "cpu"))
    loss, _ = compute_loss(tc, out, db)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p))
                         for n, p in model.named_parameters()}


def _grad_dist(got, want, total):
    """Each gradient's distance over the global norm."""
    return {n: (got[n].double() - w.double()).norm().item() / total
            for n, w in want.items()}


def test_train_steps_match_jax():
    # 4 steps of the tiny multimodal sequencer (RN50 tower) with
    # `freeze_vision_model`, at dropout 0, from the same weights and
    # batches, f32 throughout: the loss, every gradient (its distance over
    # the global norm) and every BatchNorm statistic after each step, and
    # the weights after the last; the tower gets zero gradients, its
    # statistics move, its conv kernels decay and its BatchNorm scales stay
    jc, tc = _cfgs("RN50", freeze_vision_model=True)
    jv, tv = _vcfgs("RN50")
    batches = [_batch(64, seed=10 + i) for i in range(4)]
    kw = dict(learning_rate=2e-3, warmup_steps=1, total_steps=4,
              weight_decay=0.01, adam_epsilon=1e-8, max_grad_norm=1.0)
    jm = JSequencingModel(jc, jv)
    state = _jax_state(jm, batches[0], **kw)
    model = SequencingModel(tc, tv)
    model.load_state_dict(params_from_jax(
        _np(state.params), tc, _np(state.model_state), tv))
    tower0 = {k: v.clone() for k, v in model.state_dict().items()
              if ".visual_model." in f".{k}"}
    opt = AdamW(model, **kw)
    step_fn = _jax_step_fn(jm, jc)
    for i, batch in enumerate(batches):
        state, want_loss, want_grads, stats = step_fn(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, grads = _port_step(model, tc, batch, i)
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        want = tree_to_state_dict(_np(want_grads))
        assert set(grads) == set(want)
        total = sum(float((w.double() ** 2).sum())
                    for w in want.values()) ** 0.5
        for name, err in _grad_dist(grads, want, total).items():
            assert err <= 1e-5, (i, name, err)  # f32 sums in another order
            if ".visual_model." in f".{name}":
                assert not grads[name].any(), name
        opt.step([grads[n] for n in opt.names])
        mine = model.state_dict()
        want_stats = tree_to_state_dict({}, _np(stats))
        assert len(want_stats) == 2 * 19  # 3 stem + 4 x 4 block BatchNorms
        for key, val in want_stats.items():
            np.testing.assert_allclose(mine[key].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
    final = params_from_jax(_np(state.params), tc, _np(state.model_state), tv)
    for key, val in model.state_dict().items():
        # after 3 updates of nonzero learning rate: Adam moves an entry
        # whose gradient is rounding noise by a fraction of lr; the
        # attention key biases (softmax-invariant, zero gradient but for
        # rounding) by up to lr either way in each update
        atol = (2 * 3 * kw["learning_rate"]
                if key.endswith(("key.bias", "k_proj.bias"))
                else kw["learning_rate"] / 10)
        np.testing.assert_allclose(val.numpy(), final[key].numpy(),
                                   atol=atol, rtol=0, err_msg=key)
    moved = {k: not torch.equal(model.state_dict()[k], v)
             for k, v in tower0.items()}
    assert all(moved[k] for k in moved if k.endswith("running_var"))
    assert all(moved[k] for k in moved if k.endswith("conv1.weight"))
    assert not any(moved[k] for k in moved if ".bn" in k
                   and k.endswith(".weight"))


def test_trained_tower_steps_match_jax():
    # A trained tower's gradients are ill-conditioned in f32: BatchNorm in
    # train mode over the tiny tower's few samples a channel cancels most
    # of the stem's gradient, so the JAX package's own f32 gradients there
    # are up to 0.2 % of the global norm off its f64 run of the same step
    # (the second batch). At each of 4 steps of the JAX package's train
    # trajectory (the port's weights and statistics set to its state
    # first): the loss and every BatchNorm statistic within 1e-5 of its f32
    # step, and every gradient within 1e-5 of the global norm of its f64
    # step (the port's f32 sums come within 8e-7).
    jc, tc = _cfgs("RN50")
    jv, tv = _vcfgs("RN50")
    batches = [_batch(64, seed=10 + i) for i in range(4)]
    kw = dict(learning_rate=2e-3, warmup_steps=1, total_steps=4,
              weight_decay=0.01, adam_epsilon=1e-8, max_grad_norm=1.0)
    jm = JSequencingModel(jc, jv)
    state = _jax_state(jm, batches[0], **kw)
    step_fn = _jax_step_fn(jm, jc)
    with jax.enable_x64():
        jc64 = dataclasses.replace(jc, encoder=dataclasses.replace(
            jc.encoder, dtype="float64"))
        grad_fn64 = _jax_grad_fn(
            JSequencingModel(jc64, dataclasses.replace(jv, dtype="float64")),
            jc64)
    model = SequencingModel(tc, tv)
    for i, batch in enumerate(batches):
        model.load_state_dict(params_from_jax(
            _np(state.params), tc, _np(state.model_state), tv))
        with jax.enable_x64():
            f64 = jax.tree.map(lambda x: np.asarray(x, np.float64),
                               (state.params, state.model_state))
            _, exact = grad_fn64(f64[0], f64[1]["batch_stats"],
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()})
            exact = tree_to_state_dict(_np(exact))
        state, want_loss, _, stats = step_fn(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, grads = _port_step(model, tc, batch, i)
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        assert set(grads) == set(exact)
        total = sum(float((w.double() ** 2).sum())
                    for w in exact.values()) ** 0.5
        for name, err in _grad_dist(grads, exact, total).items():
            assert err <= 1e-5, (i, name, err)
        got_stats = model.state_dict()
        for key, val in tree_to_state_dict({}, _np(stats)).items():
            np.testing.assert_allclose(got_stats[key].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")


def test_remat_of_the_joint_layers_is_exact():
    # EncoderConfig.remat recomputes the joint layers in the backward: the
    # loss, every gradient and the BatchNorm statistics (the tower runs
    # once, so they update once) equal a plain step's bit for bit
    _, tc = _cfgs("RN50")
    _, tv = _vcfgs("RN50")
    batch = _batch(64, seed=3)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tc, encoder=dataclasses.replace(
            tc.encoder, remat=remat))
        model = SequencingModel(cfg, tv)
        model.load_state_dict(runs[0][2] if runs else model.state_dict())
        start = {k: v.clone() for k, v in model.state_dict().items()}
        loss, grads = _port_step(model, cfg, batch, 0)
        runs.append((loss, grads, start, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
    for key, val in runs[0][3].items():
        assert torch.equal(val, runs[1][3][key]), key


# ----- data ------------------------------------------------------------------


def _png_paths(wikihow_dir):
    img_dir = os.path.join(wikihow_dir, "www.wikihow.com", "images")
    return [os.path.join(img_dir, f"train_0_{s}.png") for s in range(3)]


@pytest.mark.parametrize("loader", ["load_image_stack",
                                    "load_image_stack_uint8",
                                    "load_image_stack_detectron2",
                                    "load_image_stack_uint8_bgr"])
def test_image_loaders_match_jax(wikihow_dir, tmp_path, loader):
    bad = tmp_path / "not_an_image.png"
    bad.write_bytes(b"not a png")
    paths = _png_paths(wikihow_dir) + [None, str(tmp_path / "missing.png"),
                                       str(bad)]
    want = getattr(jimages, loader)(paths, (32, 40))
    got = getattr(timages, loader)(paths, (32, 40))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # the same host code
    # the last three are the missing-path and failed-read zeros (minus the
    # pixel means in the detectron2 float pipeline)
    zero = jimages.load_image_stack_detectron2([None], (32, 40))[0] \
        if loader == "load_image_stack_detectron2" else 0
    assert (got[3:] == zero).all() and got[:3].std() > 0
    # each of the three PNGs decodes, none is the zero fill
    assert all((img != zero).any() for img in got[:3])


def test_read_image_and_normalize_match_jax(wikihow_dir):
    path = _png_paths(wikihow_dir)[0]
    np.testing.assert_array_equal(timages.read_image_rgb(path),
                                  jimages.read_image_rgb(path))
    np.testing.assert_array_equal(timages.load_and_transform(path, (24, 24)),
                                  jimages.load_and_transform(path, (24, 24)))
    np.testing.assert_array_equal(timages.rescale(
        timages.read_image_rgb(path), 20), jimages.rescale(
        jimages.read_image_rgb(path), 20))


def _copy_wikihow(src, dst, drop):
    """The fixture's data with some step images deleted (`drop`: (split,
    article, step) triples)."""
    import shutil
    shutil.copytree(src, dst)
    for split, a, s in drop:
        os.remove(os.path.join(dst, "www.wikihow.com", "images",
                               f"{split}_{a}_{s}.png"))
    return str(dst)


@pytest.mark.parametrize("min_len", [3, 5])
def test_wikihow_image_half_matches_jax(wikihow_dir, tmp_path, min_len):
    # article 0 loses one step image (dropped; a 4-step story survives only
    # min_story_length 3), article 2 loses none
    data = _copy_wikihow(wikihow_dir, tmp_path / "wh",
                         [("train", 0, 1), ("train", 1, 0), ("train", 1, 4)])
    kw = dict(data_dir=data, min_story_length=min_len, max_story_length=5)
    jex = j_get_processor("wikihow_sort", **kw).get_train_examples()
    jmissing = open(os.path.join(data, "missing_images_train.txt")).read()
    os.remove(os.path.join(data, "missing_images_train.txt"))
    tex = t_get_processor("wikihow_sort", **kw).get_train_examples()
    tmissing = open(os.path.join(data, "missing_images_train.txt")).read()
    # each lost step is logged once for each image field it fails
    assert tmissing == jmissing and tmissing.count("\n") == 6
    assert [(e.guid, e.text_seq, e.img_path_seq) for e in tex] == [
        (e.guid, e.text_seq, e.img_path_seq) for e in jex]
    assert len(tex) == (6 if min_len == 3 else 4)
    assert all(p is not None for e in tex for p in e.img_path_seq)
    # without images nothing is dropped and no path is kept
    plain = t_get_processor("wikihow_sort", paired_with_image=False,
                            **kw).get_train_examples()
    assert len(plain) == 6 and all(p is None for e in plain
                                   for p in e.img_path_seq)


@pytest.mark.parametrize("kind", ["sort", "pure_class"])
@pytest.mark.parametrize("uint8", [True, False])
def test_dataset_image_batches_match_jax(wikihow_dir, kind, uint8):
    kw = dict(data_dir=wikihow_dir, min_story_length=5, max_story_length=5)
    jex = j_get_processor("wikihow_sort", **kw).get_train_examples()
    tex = t_get_processor("wikihow_sort", **kw).get_train_examples()
    common = dict(max_length=96, per_seq_max_length=12, max_story_length=5,
                  seed=3, multimodal=True, image_size=(24, 32),
                  uint8_images=uint8)
    if kind == "sort":
        jset = jds.SortDataset(jex, jtok.load_tokenizer("simple"),
                               min_story_length=5, **common)
        tset = tds.SortDataset(tex, ttok.load_tokenizer("simple"), **common)
    else:
        jset = jds.PureClassDataset(jex, jtok.load_tokenizer("simple"),
                                    decode=True, min_story_length=5, **common)
        tset = tds.PureClassDataset(tex, ttok.load_tokenizer("simple"),
                                    **common)
    # 6 stories in batches of 4: the last batch pads by repeating its last
    # story, images included
    jb = list(jds.data_loader(jset, 4, shuffle=True, seed=1))
    tb = list(tds.data_loader(tset, 4, shuffle=True, seed=1))
    assert len(jb) == len(tb) == 2
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_array_equal(a["valid"], b["valid"])
    last = tb[-1]
    assert last["images"].dtype == (np.uint8 if uint8 else np.float32)
    assert last["images"].shape[:2] == (4, 5)
    np.testing.assert_array_equal(last["images"][2], last["images"][3])
    assert not last["valid"][2:].all()
