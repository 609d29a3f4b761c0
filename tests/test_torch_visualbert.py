"""The port's VisualBERT encoder and naive multimodal model against the JAX
package's, on the CPU: the encoders in each mode (ResNet and FPN towers;
sidecar regional tokens, the missing-sidecar sentinel, inline ROI with and
without the full-image feature, `bypass_transformer`, img_part, text_part)
and their bf16 dtypes; `SequencingModel` v0 and v1 over both (forward,
loss, gradients, train steps with the BatchNorm statistics); the BERSON
inners (encode, loss, gradients, beam); the pretrainer's non-patch
objectives and the patch objectives' ValueError. The data and CLI paths
are in `test_torch_visualbert_cli.py`. Tiny f32 configs (resnet18 towers,
32 px; 64 px where the towers run in train mode), weights moved by
`params_from_jax`; every comparison states its tolerance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sequencing_tpu.ops.preprocess  # noqa: F401 (imported
# before any trace: its module constants must not be built under jit)
from multimodal_sequencing_tpu.data import packing as jpacking
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.models import berson as jberson
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models import pretrainer as jpre
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.models.visualbert import (
    VisualBERTEncoder as JVisualBERTEncoder)
from multimodal_sequencing_tpu.train import loop as jloop
from multimodal_sequencing_tpu.train import mlm as jmlm
from multimodal_sequencing_tpu.train import objectives as jobj
from multimodal_sequencing_tpu.train.state import (
    TrainState, make_optimizer as j_make_optimizer)
from multimodal_sequencing_tpu.train.steps import compute_loss as j_compute_loss
from multimodal_sequencing_tpu_torch.models import berson as tberson
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models import pretrainer as tpre
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
from multimodal_sequencing_tpu_torch.models.sequencer import (
    SequencingModel, init_weights)
from multimodal_sequencing_tpu_torch.models.visualbert import (
    VisualBERTEncoder)
from multimodal_sequencing_tpu_torch.train.state import AdamW
from multimodal_sequencing_tpu_torch.train.steps import (
    compute_loss, device_batch)

torch.set_num_threads(1)

N, SEQ, PER_SEQ, RES, SIDE, K = 3, 48, 12, 32, 16, 2
ENC = dict(max_position_embeddings=100, type_vocab_size=N,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
D2 = "detectron2_R_18_FPN"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jb(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _close(got, want, rel=1e-5, msg=""):
    """|got - want| <= rel x the largest |want| (f32 sums in another
    order)."""
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, (msg, err)


def _cfgs(mt="visualbert", vision="resnet18", res=RES, encoder=None,
          **kw):
    vision = kw.pop("vision_model", vision)
    common = dict(hierarchical_version="v1", max_story_length=N,
                  max_seq_length=SEQ, per_seq_max_length=PER_SEQ,
                  multimodal=True, multimodal_model_type=mt,
                  vision_model=vision, image_size=(res, res),
                  visual_feat_dim=SIDE)
    if vision.startswith("detectron2"):
        common["vision_feature_dim"] = SIDE
    common.update(kw)
    enc = {**ENC, **(encoder or {})}
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc),
                                  **common),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc),
                                  **common))


def _batch(b=2, seed=0, res=RES, regional=None):
    """Packed ids (a CLS a step, a padded tail), uint8 step images, labels,
    and with `regional` R the (B, N, R, SIDE) sidecars."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 1000, (b, SEQ)).astype(np.int32)
    ids[:, ::SEQ // N] = 0
    am = np.ones((b, SEQ), np.int32)
    am[-1, SEQ - 7:] = 0
    out = {"input_ids": ids, "attention_mask": am,
           "token_type_ids": (np.arange(SEQ) // (SEQ // N)).clip(
               max=N - 1)[None].repeat(b, 0).astype(np.int32),
           "images": rng.randint(0, 256, (b, N, res, res, 3)).astype(
               np.uint8),
           "labels": np.stack([rng.permutation(N) for _ in range(b)]
                              ).astype(np.int32),
           "valid": np.ones(b, bool)}
    if regional:
        out["img_regional_features"] = rng.standard_normal(
            (b, N, regional, SIDE)).astype(np.float32)
    return out


def _inputs(batch, *keys):
    return [torch.from_numpy(batch[k]).long() for k in keys]


def _model_kwargs(batch, regional):
    """The call's images and regional features: `sidecar` the batch's,
    `sentinel` the (B, 1) zeros of a story with a missing sidecar."""
    kw = {"images": batch["images"]}
    if regional == "sidecar":
        kw["img_regional_features"] = batch["img_regional_features"]
    elif regional == "sentinel":
        kw["img_regional_features"] = np.zeros((len(batch["images"]), 1),
                                               np.float32)
    return kw


class Pair:
    """A JAX `SequencingModel` initialized on the call that builds its
    whole tree (sidecars for a ResNet tower's regional_proj, none for an FPN
    tower's inline ROI) and the port's on the same weights."""

    def __init__(self, jc, tc, batch, init_regional=None):
        self.jc, self.tc = jc, tc
        self.jm = JSequencingModel(jc)
        self.init_regional = init_regional
        init_kw = _model_kwargs(batch, init_regional)
        # the init call's outputs too: one compile where a test reads them
        self.init_out, variables = jax.jit(functools.partial(
            self.jm.init_with_output, deterministic=True))(
            jax.random.PRNGKey(0), *[jnp.asarray(batch[k]) for k in (
                "input_ids", "attention_mask", "token_type_ids")],
            **_jb(init_kw))
        self.vars = _np(variables)
        self.tm = SequencingModel(tc)
        self.tm.load_state_dict(params_from_jax(
            self.vars["params"], tc, self.vars.get("batch_stats")))
        self.tm.eval()

    def forward(self, batch, regional=None):
        """The port's eval forward on `batch` and JAX's (the init call's
        outputs when `batch` and `regional` are the init's)."""
        kw = _model_kwargs(batch, regional)
        want = (self.init_out if regional == self.init_regional else
                jax.jit(self.jm.apply)(self.vars, *[
                    jnp.asarray(batch[k]) for k in (
                        "input_ids", "attention_mask", "token_type_ids")],
                    **_jb(kw)))
        with torch.no_grad():
            got = self.tm(*_inputs(batch, "input_ids", "attention_mask",
                                   "token_type_ids"),
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
        return got, want


# (config changes, the JAX init call's regional features, the compared
# call's, whether the port's encoder is built for inline ROI)
VB_MODES = {
    "resnet": (dict(), None, None, False),
    "sidecar": (dict(num_img_regional_features=K), "sidecar", "sidecar",
                False),
    "sentinel": (dict(num_img_regional_features=K), "sidecar", "sentinel",
                 False),
    "bypass": (dict(num_img_regional_features=K, bypass_transformer=True),
               "sidecar", "sidecar", False),
    "fpn": (dict(vision_model=D2), None, None, False),
    "fpn_sentinel": (dict(vision_model=D2, num_img_regional_features=K,
                          include_full_img_features=False), "sentinel",
                     "sentinel", False),
    "fpn_sidecar": (dict(vision_model=D2, num_img_regional_features=K,
                         include_full_img_features=False), "sidecar",
                    "sidecar", False),
    "inline": (dict(vision_model=D2, num_img_regional_features=K,
                    include_full_img_features=False), None, None, True),
    "inline_full": (dict(vision_model=D2, num_img_regional_features=K,
                         include_full_img_features=True), None, None, True),
    "inline_full_sidecar": (dict(vision_model=D2, num_img_regional_features=K,
                                 include_full_img_features=True), None,
                            "sidecar", True),
    "img_part": (dict(multimodal_img_part=True), None, None, False),
    "text_part": (dict(multimodal_text_part=True), None, None, False),
}


def _visual_tokens(tc, regional):
    """The visual stream's length for a mode."""
    if tc.multimodal_text_part:
        return 0
    k = tc.num_img_regional_features
    if regional == "sidecar" or (k and regional is None
                                 and tc.vision_model.startswith("detectron2")):
        return N * (1 + k)
    return N


@pytest.mark.parametrize("mode", sorted(VB_MODES))
def test_visualbert_modes_match_jax(mode):
    # the VisualBERT encoder in eval mode, JAX's initialized on the call
    # that builds its tree and the port's built to match (the sequencer's
    # without inline ROI, BERSON's and the pretrainer's with): the language
    # and visual streams and the pooled CLS within 1e-5 of the largest
    # entry; the visual stream as long as the mode makes it (the sentinel
    # adds no regional tokens and runs no inline ROI)
    change, init_reg, call_reg, inline = VB_MODES[mode]
    jc, tc = _cfgs(**change)
    batch = _batch(regional=K)
    ids = [jnp.asarray(batch[k]) for k in ("input_ids", "attention_mask",
                                           "token_type_ids")]
    jm = JVisualBERTEncoder(jc)
    want, variables = jax.jit(jm.init_with_output)(
        jax.random.PRNGKey(0), *ids, **_jb(_model_kwargs(batch, init_reg)))
    variables = _np(variables)
    tm = VisualBERTEncoder(tc, inline_roi=inline)
    # the port builds regional_proj whenever K is set; JAX's init only
    # where 4-D sidecars reached it
    missing = tm.load_state_dict(tree_to_state_dict(
        variables["params"], variables.get("batch_stats")),
        strict=False).missing_keys
    assert all(k.startswith("regional_proj.") for k in missing), missing
    assert bool(missing) == (init_reg == "sentinel")
    kw = _model_kwargs(batch, call_reg)
    if call_reg != init_reg:
        want = jax.jit(jm.apply)(variables, *ids, **_jb(kw))
    with torch.no_grad():
        got = tm.eval()(*_inputs(batch, "input_ids", "attention_mask",
                                 "token_type_ids"),
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    for g, w, name in zip(got, want, ("lang", "visn", "pooled")):
        if w is None:
            assert g is None and tc.multimodal_text_part, name
            continue
        _close(g, w, msg=name)
    if not tc.multimodal_text_part:
        assert got[1].shape[1] == _visual_tokens(tc, call_reg)
    assert got[0].shape[1] == (1 if tc.multimodal_img_part else SEQ)


def test_visualbert_modules_follow_the_config():
    # regional_proj whenever K is set (the sidecars' width for a ResNet
    # tower, the box head's for an FPN tower); the FPN's objectness and box
    # heads with K; a sidecar of another width raises
    _, tc = _cfgs(num_img_regional_features=K)
    enc = VisualBERTEncoder(tc)
    assert enc.regional_proj.in_features == SIDE
    assert enc.regional_proj.out_features == 512  # resnet18's features
    assert not hasattr(VisualBERTEncoder(_cfgs()[1]), "regional_proj")
    _, tc2 = _cfgs(vision_model=D2, num_img_regional_features=K,
                   vision_feature_dim=24, include_full_img_features=False)
    enc2 = VisualBERTEncoder(tc2)
    assert enc2.regional_proj.in_features == 24
    assert hasattr(enc2.vision_model, "box_fc1")
    assert enc2.vision_model.num_regional_features == K + 1
    assert not hasattr(VisualBERTEncoder(_cfgs(vision_model=D2)[1])
                       .vision_model, "box_fc1")
    # the sequencer's: no inline ROI, so no box head, and the image
    # feature is the flattened p6
    seq_enc = SequencingModel(tc2).encoder
    assert not hasattr(seq_enc.vision_model, "box_fc1")
    assert seq_enc.visual_embeddings.projection.in_features == 256
    batch = _batch(regional=K)
    ids = _inputs(batch, "input_ids")[0]
    wide = torch.zeros(2, N, K, SIDE + 1)
    with pytest.raises(ValueError, match="width"):
        enc(ids, images=torch.from_numpy(batch["images"]),
            img_regional_features=wide)
    # an inline FPN tower without the full-image feature takes it from its
    # top ROI, so it cannot take sidecars; the sequencer's FPN tower takes
    # nothing else
    images = torch.from_numpy(batch["images"])
    with pytest.raises(ValueError, match="sidecars"):
        enc2(ids, images=images, img_regional_features=torch.zeros(
            2, N, K, 24))
    with pytest.raises(ValueError, match="without inline ROI"):
        seq_enc(ids, images=images)


def test_visualbert_bf16_dtypes_match_jax():
    # under a bf16 encoder the visual embeddings' LayerNorm returns f32,
    # the joint stream is promoted to f32, and the first layer's
    # attention_ln takes that f32 residual and returns bf16: the dtypes of
    # JAX's intermediates, and the outputs within 3 bf16 ulps (2^-6) of the
    # largest entry
    jc, tc = _cfgs(num_img_regional_features=K,
                   encoder=dict(dtype="bfloat16"))
    batch = _batch(regional=K)
    p = Pair(jc, tc, batch, "sidecar")
    ids = [jnp.asarray(batch[k]) for k in ("input_ids", "attention_mask",
                                           "token_type_ids")]
    want, inter = jax.jit(functools.partial(
        p.jm.apply, capture_intermediates=True, mutable=["intermediates"]))(
        p.vars, *ids, **_jb(_model_kwargs(batch, "sidecar")))
    inter = inter["intermediates"]["encoder"]
    jdt = {"visual_embeddings": inter["visual_embeddings"]["__call__"][0],
           "attention_ln": inter["layer_0"]["attention_ln"]["__call__"][0],
           "layer_0": inter["layer_0"]["__call__"][0]}
    seen = {}
    enc = p.tm.encoder
    hooks = [
        enc.visual_embeddings.register_forward_hook(
            lambda m, i, o: seen.update(visual_embeddings=o.dtype)),
        enc.layer_0.attention_ln.register_forward_hook(
            lambda m, i, o: seen.update(attention_ln=o.dtype,
                                        attention_ln_in=i[0].dtype)),
        enc.layer_0.register_forward_hook(
            lambda m, i, o: seen.update(layer_0=o.dtype))]
    with torch.no_grad():
        got = p.tm(*_inputs(batch, "input_ids", "attention_mask",
                            "token_type_ids"),
                   images=torch.from_numpy(batch["images"]),
                   img_regional_features=torch.from_numpy(
                       batch["img_regional_features"]))
    for h in hooks:
        h.remove()
    assert seen["visual_embeddings"] == torch.float32
    assert str(jdt["visual_embeddings"].dtype) == "float32"
    assert seen["attention_ln_in"] == torch.float32
    assert seen["attention_ln"] == torch.bfloat16
    assert str(jdt["attention_ln"].dtype) == "bfloat16"
    assert seen["layer_0"] == torch.bfloat16
    assert str(jdt["layer_0"].dtype) == "bfloat16"
    assert got["sequence_output"].dtype == torch.bfloat16
    assert str(want["sequence_output"].dtype) == "bfloat16"
    for key in ("sequence_output", "visual_output", "heatmap"):
        _close(got[key], want[key], rel=2.0 ** -6, msg=key)


@pytest.mark.parametrize("mt,vision", [("visualbert", "resnet18"),
                                       ("naive", D2)])
def test_init_weights_follow_flax_initializers(mt, vision):
    # each leaf's std against the JAX package's init (lecun_normal Dense
    # and Conv kernels, 1/sqrt(features) Embed tables, normal(0.02)
    # visual positions, zero biases, unit scales, BatchNorm statistics 0
    # and 1): 4 standard errors of a std estimate, 4 / sqrt(2 n), plus the
    # truncation's share; the bits differ
    jc, tc = _cfgs(mt, vision, num_img_regional_features=K
                   if mt == "visualbert" else None)
    p = Pair(jc, tc, _batch(regional=K), "sidecar" if mt == "visualbert"
             else None)
    want = p.tm.state_dict()
    got = init_weights(SequencingModel(tc), 0).state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if w.unique().numel() == 1:
            assert torch.equal(g, w), key
            continue
        n = w.numel()
        assert abs(g.std().item() / w.std().item() - 1) < (
            4 / np.sqrt(2 * n) + 0.02), key
        assert abs(g.mean().item()) < 4 * w.std().item() / np.sqrt(n), key


# ----- the naive model -------------------------------------------------------


NAIVE_MODES = {"resnet": dict(), "fpn": dict(vision_model=D2),
               "img_part": dict(multimodal_img_part=True,
                                hierarchical_version="v0"),
               "text_part": dict(multimodal_text_part=True),
               "naive_model": dict(multimodal_model_type="naive_model")}


@pytest.mark.parametrize("mode", sorted(NAIVE_MODES))
def test_naive_modes_match_jax(mode):
    # the sequencer over the naive model (its pooled tower: resnet18's
    # features or the FPN's flattened p6; img_part: one zero token with
    # mask 0 and the images; text_part: no images): every output within
    # 1e-5 of the largest entry, the streams split where JAX splits them
    kw = {"mt": "naive", **NAIVE_MODES[mode]}
    jc, tc = _cfgs(**{("mt" if k == "multimodal_model_type" else k): v
                      for k, v in kw.items()})
    batch = _batch()
    p = Pair(jc, tc, batch)
    got, want = p.forward(batch)
    head = "logits" if tc.hierarchical_version == "v0" else "heatmap"
    for key in ("sequence_output", "pooled_output", head):
        _close(got[key], want[key], msg=key)
    if tc.multimodal_text_part:
        assert got["visual_output"] is None and want["visual_output"] is None
    else:
        _close(got["visual_output"], want["visual_output"], msg="visual")
        assert got["visual_output"].shape[1] == N
    assert hasattr(p.tm.encoder, "cls_head")
    assert got["sequence_output"].shape[1] == (
        1 if tc.multimodal_img_part else SEQ)


# ----- train steps -----------------------------------------------------------


def _jax_step_fn(jm, jc, regional):
    """One jitted JAX train step at dropout 0 (`make_train_step`'s
    loss_fn): (new state, loss, gradients, updated BatchNorm statistics)."""
    def loss_fn(params, batch_stats, batch):
        kw = {"images": batch["images"]}
        if regional:
            kw["img_regional_features"] = batch["img_regional_features"]
        out, new_ms = jm.apply(
            {"params": params, "batch_stats": batch_stats},
            batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], deterministic=False,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)},
            **kw)
        return j_compute_loss(jc, out, batch)[0], new_ms["batch_stats"]

    @jax.jit
    def step(state, batch):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.model_state["batch_stats"], batch)
        return (state.apply_gradients(grads,
                                      model_state={"batch_stats": stats}),
                loss, grads, stats)

    return step


@pytest.mark.parametrize("mt,version", [("visualbert", "v1"),
                                        ("visualbert", "v0"),
                                        ("naive", "v1"), ("naive", "v0")])
def test_train_steps_match_jax(mt, version):
    # 2 steps of the sequencer at dropout 0 from the same weights and
    # batches, 64 px, `freeze_vision_model` (the towers' train-mode f32
    # gradients are ill-conditioned; test_torch_vision_towers.py holds them
    # to an f64 run): the loss within 1e-5, every gradient within 1e-5 of
    # the global norm (the tower's zero), every BatchNorm statistic after
    # each step within 1e-5 of its largest, and the weights after the
    # updates within lr / 10
    regional = K if mt == "visualbert" else None
    jc, tc = _cfgs(mt, res=64, hierarchical_version=version,
                   freeze_vision_model=True,
                   num_img_regional_features=regional)
    batches = [_batch(seed=20 + i, res=64, regional=regional)
               for i in range(2)]
    if version == "v0":
        for b in batches:
            b["labels"] = np.asarray([0, 1], np.int32)
    kw = dict(learning_rate=2e-3, warmup_steps=1, total_steps=2,
              weight_decay=0.01, adam_epsilon=1e-8, max_grad_norm=1.0)
    jm = JSequencingModel(jc)
    p = Pair(jc, tc, batches[0], "sidecar" if regional else None)
    tx = j_make_optimizer(**kw)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p.vars["params"],
                       opt_state=tx.init(p.vars["params"]),
                       model_state={"batch_stats": p.vars["batch_stats"]},
                       tx=tx, apply_fn=jm.apply)
    model = p.tm
    opt = AdamW(model, **kw)
    step_fn = _jax_step_fn(jm, jc, regional)
    for i, batch in enumerate(batches):
        state, want_loss, want_grads, stats = step_fn(state, _jb(batch))
        db = device_batch(batch, "cpu")
        extra = ({"img_regional_features": db["img_regional_features"]}
                 if regional else {})
        out = model.train()(db["input_ids"], db["attention_mask"],
                            db["token_type_ids"], images=db["images"],
                            deterministic=False,
                            rng=DropoutRng(1, i, "cpu"), **extra)
        loss, _ = compute_loss(tc, out, db)
        model.zero_grad(set_to_none=True)
        loss.backward()
        grads = {n: (q.grad if q.grad is not None else torch.zeros_like(q))
                 for n, q in model.named_parameters()}
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        want = tree_to_state_dict(_np(want_grads))
        assert set(grads) == set(want)
        total = sum(float((w.double() ** 2).sum())
                    for w in want.values()) ** 0.5
        for name, w in want.items():
            err = (grads[name].double() - w.double()).norm().item() / total
            assert err <= 1e-5, (i, name, err)
            if ".vision_model." in f".{name}":
                assert not grads[name].any(), name
        opt.step([grads[n] for n in opt.names])
        mine = model.state_dict()
        want_stats = tree_to_state_dict({}, _np(stats))
        assert want_stats
        for key, val in want_stats.items():
            np.testing.assert_allclose(
                mine[key].numpy(), val.numpy(), rtol=0,
                atol=1e-5 * val.abs().max().item(), err_msg=f"{i} {key}")
    final = params_from_jax(_np(state.params), tc, _np(state.model_state))
    for key, val in model.state_dict().items():
        if "running_" in key:
            continue
        atol = (2 * kw["learning_rate"] if key.endswith("key.bias")
                else kw["learning_rate"] / 10)
        np.testing.assert_allclose(val.numpy(), final[key].numpy(), rtol=0,
                                   atol=atol, err_msg=key)


# ----- BERSON ----------------------------------------------------------------


LENS = [3, 2, 3]


def _berson_batch(seed=0):
    tok = jtok.SimpleWordTokenizer(vocab_size=1000)
    rng = np.random.RandomState(seed)
    packer = jpacking.StoryPacker(tok, SEQ, PER_SEQ)
    items = [packer.pack_berson_story(
        [f"alpha {k} beta {i} gamma delta" for i in range(m)],
        rng.permutation(m).tolist(), max_story_length=N)
        for k, m in enumerate(LENS)]
    batch = {k: np.stack([np.asarray(it[k]) for it in items])
             for k in items[0]}
    batch["valid"] = np.ones(len(LENS), bool)
    batch["images"] = rng.randint(0, 256, (len(LENS), N, RES, RES, 3)
                                  ).astype(np.uint8)
    return batch


@pytest.mark.parametrize("mt,vision", [("visualbert", "resnet18"),
                                       ("visualbert", D2),
                                       ("naive", "resnet18")])
def test_berson_inners_match_jax(mt, vision):
    # BERSON over the VisualBERT (a ResNet tower, and an FPN tower with
    # inline ROI: its K regional tokens a pair image) and naive inners:
    # the encode intermediates, the losses with the image-stream pairwise
    # head, the beam orders, equal, and (the ResNet VisualBERT inner) every
    # gradient of the deterministic loss (the towers' BatchNorms on their
    # running statistics) within 1e-5 of the global norm
    kw = dict(wrapper_model_type="berson")
    if vision == D2:
        kw.update(num_img_regional_features=K,
                  include_full_img_features=False)
    jc, tc = _cfgs(mt, vision, **kw)
    batch = _berson_batch()
    jm = jberson.BersonOrdering(jc, beam_size=3, multimodal_loss=True)
    variables = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), _jb(batch)))
    tm = tberson.BersonOrdering(tc, beam_size=3, multimodal_loss=True)
    tm.load_state_dict(params_from_jax(variables["params"], tc,
                                       variables.get("batch_stats")))
    tm.eval()
    tb = device_batch(batch, "cpu")
    want = jax.jit(functools.partial(
        jm.apply, method=jberson.BersonOrdering.encode))(variables,
                                                         _jb(batch))
    got = tm.encode(tb)
    for key in ("doc", "key", "cls_score", "cls_output_matrix",
                "cls_score_matrix", "his1_matrix", "his2_matrix",
                "cls_score_img"):
        _close(got[key], want[key], msg=key)
    want = jax.jit(jm.apply)(variables, _jb(batch))
    got = tm(tb)
    assert set(got) == set(want)
    for key in ("loss", "pointer_loss", "pairwise_loss", "img_pairwise_loss"):
        _close(got[key], want[key], msg=key)

    beam = np.asarray(jax.jit(functools.partial(
        jm.apply, method=jberson.BersonOrdering.beam_search))(
        variables, _jb(batch)))
    with torch.no_grad():
        np.testing.assert_array_equal(tm.beam_search(tb).numpy(), beam)
    if (mt, vision) != ("visualbert", "resnet18"):
        return

    def loss(params):
        return jm.apply({**variables, "params": params}, _jb(batch))["loss"]

    want_g = tree_to_state_dict(_np(jax.jit(jax.grad(loss))(
        variables["params"])))
    tm.zero_grad()
    got["loss"].backward()
    total = sum(float((w.double() ** 2).sum())
                for w in want_g.values()) ** 0.5
    params = dict(tm.named_parameters())
    assert set(params) == set(want_g)
    for name, w in want_g.items():
        g = params[name].grad
        g = torch.zeros_like(w) if g is None else g
        err = (g.double() - w.double()).norm().item() / total
        assert err <= 1e-5, (name, err)


def test_berson_inner_types():
    # vilbert and naive_model raise as in the JAX package; the VisualBERT
    # and naive inners carry no CLIP tower config
    for mt in ("vilbert", "naive_model"):
        with pytest.raises(NotImplementedError, match="raise here too"):
            tberson.BersonOrdering(_cfgs(mt)[1])
    assert tberson.BersonOrdering(_cfgs("naive")[1]).vision_cfg is None


# ----- pretraining -----------------------------------------------------------


# each encoder's objectives: between them the pooled heads, the doubled
# margin batch, the steps' CLS triplets and the swapped step images
PRE_OBJECTIVES = {"visualbert": ("swapping_based_nsp", "margin_loss"),
                  "naive": ("time_contrastive", "image_swapping")}


def _planned(jc, objective, seed=0):
    tok = jtok.SimpleWordTokenizer(vocab_size=1000)
    rng = np.random.RandomState(seed)
    packer = jpacking.StoryPacker(tok, SEQ, PER_SEQ)
    rows = [packer.pack_story([" ".join(f"w{rng.randint(300)}" for _ in
                                        range(rng.randint(3, PER_SEQ + 2)))
                               for _ in range(N)]) for _ in range(3)]
    batch = {k: np.stack([r[i] for r in rows]) for i, k in enumerate(
        ("input_ids", "attention_mask", "token_type_ids"))}
    batch["images"] = rng.randint(0, 256, (3, N, RES, RES, 3)).astype(
        np.uint8)
    g = np.random.default_rng(seed)
    batch["input_ids"], batch["mlm_labels"] = jmlm.mask_tokens_sentence(
        batch["input_ids"], mlm_probability=0.15, pad_id=jc.pad_id,
        cls_id=jc.cls_id, mask_id=jc.mask_id,
        vocab_size=jc.encoder.vocab_size, ignore_index=jc.mlm_ignore_index,
        rng=g)
    nb, aux = jobj.plan_objective(objective, batch, jc, g)
    return nb, {k: v for k, v in aux.items()
                if isinstance(v, np.ndarray) and v.ndim > 0}


@pytest.mark.parametrize("mt", ["visualbert", "naive"])
def test_pretrainer_matches_jax(mt):
    # the loss dict (with MLM) and every gradient of non-patch objectives
    # (eval mode, dropout 0: the towers on their running statistics)
    # within 1e-5 (the gradients relative to the global norm), on the tree
    # JAX's init makes from the objectives' traces
    tok = jtok.SimpleWordTokenizer(vocab_size=1000)
    ids = dict(cls_id=tok.cls_token_id, pad_id=tok.pad_token_id,
               mask_id=tok.mask_token_id)
    objectives = PRE_OBJECTIVES[mt]
    jc, tc = _cfgs(mt, multimodal_pretrain_objectives=list(objectives),
                   **ids)
    jm = jpre.SequencingPretrainer(jc)
    variables = {}
    for obj in objectives:
        nb, aux = _planned(jc, obj)
        v = jax.jit(functools.partial(jm.init, objective=obj))(
            jax.random.PRNGKey(0), _jb(nb), aux=_jb(aux))
        variables = jloop._merge_variable_trees(variables, dict(_np(v)))
    tm = tpre.SequencingPretrainer(tc)
    tm.load_state_dict(params_from_jax(variables["params"], tc,
                                       variables.get("batch_stats")))
    tm.eval()
    for obj in objectives:
        nb, aux = _planned(jc, obj, seed=1)

        def run(params):
            losses = jm.apply({**variables, "params": params}, _jb(nb), obj,
                              _jb(aux))
            return losses["loss"], losses

        (_, want), want_g = jax.jit(jax.value_and_grad(run, has_aux=True))(
            variables["params"])
        tm.zero_grad()
        got = tm(device_batch(nb, "cpu"), obj, device_batch(aux, "cpu"))
        got["loss"].backward()
        assert set(got) == set(want), obj
        for key in want:
            _close(got[key], want[key], msg=f"{obj} {key}")
        want_g = tree_to_state_dict(_np(want_g))
        total = sum(float((w.double() ** 2).sum())
                    for w in want_g.values()) ** 0.5
        for name, q in tm.named_parameters():
            g = torch.zeros_like(q) if q.grad is None else q.grad
            err = (g.double() - want_g[name].double()).norm().item() / total
            assert err <= 1e-5, (obj, name, err)


@pytest.mark.parametrize("mt", ["visualbert", "naive"])
def test_patch_objectives_raise(mt):
    # the patch objectives corrupt the folded CLIP stream, which these
    # encoders have not: ValueError in both packages
    jc, tc = _cfgs(mt, multimodal_pretrain_objectives=[
        "patch_based_image_swapping"])
    nb, aux = _planned(jc, "patch_based_image_swapping")
    with pytest.raises(ValueError, match="per-step"):
        jax.eval_shape(functools.partial(
            jpre.SequencingPretrainer(jc).init,
            objective="patch_based_image_swapping"),
            jax.random.PRNGKey(0), _jb(nb), aux=_jb(aux))
    with pytest.raises(ValueError, match="per-step"):
        tpre.SequencingPretrainer(tc)(device_batch(nb, "cpu"),
                                      "patch_based_image_swapping",
                                      device_batch(aux, "cpu"))
