"""The port's BERSON ordering wrapper against the JAX package's, on the CPU:
the pair packing (native and numpy, full and short stories), `BersonDataset`
and its batches, the time-contrastive plan, `HierarchicalAttention` and
`TransformerInterEncoder` alone, and `BersonOrdering` over the text
encoder and the CLIP encoder (`tiny_rn`, `tiny_vit`) on weights moved by
`params_from_jax`: the `encode()` intermediates, the losses (heat-map aux,
`multimodal_loss`, `time_contrastive`), the gradients at dropout 0, the beam
orders (W <= n, W > n, exact ties; stories of 2-4 steps in a batch of 5),
a train step with the tower's BatchNorm statistics, the sort evaluator's
berson branch, and the CLI: train -> checkpoint -> `--do_eval` ->
`trainers.eval --sort_method berson`. Tiny f32 configs; every comparison
states its tolerance (1e-5 of the largest entry unless named)."""

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
from multimodal_sequencing_tpu.data import _native as jnative
from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import packing as jpacking
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import get_processor as j_get_processor
from multimodal_sequencing_tpu.models import berson as jberson
from multimodal_sequencing_tpu.models import clip_visual as jclip
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu.train import objectives as jobjectives
from multimodal_sequencing_tpu.train.evaluation import SortEvaluator as JSortEvaluator
from multimodal_sequencing_tpu.train.state import TrainState, make_optimizer
from multimodal_sequencing_tpu_torch.data import _native as tnative
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import packing as tpacking
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.registry import get_processor as t_get_processor
from multimodal_sequencing_tpu_torch.models import berson as tberson
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.models.sequencer import init_weights
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train import objectives as tobjectives
from multimodal_sequencing_tpu_torch.train.evaluation import SortEvaluator
from multimodal_sequencing_tpu_torch.train.state import AdamW
from multimodal_sequencing_tpu_torch.train.steps import (berson_train_step,
                                                         device_batch)

torch.set_num_threads(1)

N, SEQ, PER_SEQ = 4, 64, 8
LENS = [4, 2, 3, 4, 2]  # a batch of 5 stories of 2-4 steps
ENC = dict(max_position_embeddings=100, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
RES = {"clip_rn": 64, "clip_vit": 32}  # RN50 at 64 px: a 2 x 2 grid


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=1e-5, msg=""):
    """|got - want| <= rel x the largest |want| (f32 sums in another
    order)."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, (msg, err)


def _tokenizers():
    return (jtok.SimpleWordTokenizer(vocab_size=1000),
            ttok.SimpleWordTokenizer(vocab_size=1000))


# ----- packing and data --------------------------------------------------------


def test_berson_pairs_and_membership_match_jax():
    for n in (2, 3, 5):
        np.testing.assert_array_equal(tpacking.berson_pairs(n),
                                      jberson.berson_pairs(n))
        for got, want in zip(tberson._sentence_membership(n),
                             jberson._sentence_membership(n)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("m", [5, 3, 2])
def test_pack_berson_story_matches_jax(monkeypatch, native, m):
    # a full story (5 of 5 steps) and short ones: dead pairs are all-pad rows
    # with label 0, ground_truth padded with the dead indices; steps of
    # unequal lengths, one longer than the pair's half
    jt, tt = _tokenizers()
    texts = [" ".join(f"w{s}x{t}" for t in range(3 + 4 * s))
             for s in range(m)]
    label = np.random.RandomState(m).permutation(m).tolist()
    if native:
        assert tnative.available(), tnative.build_error()
    else:
        monkeypatch.setattr(tnative, "pack_berson", lambda *a: None)
        monkeypatch.setattr(jnative, "pack_berson", lambda *a: None)
    got = tpacking.StoryPacker(tt, SEQ, PER_SEQ).pack_berson_story(
        texts, label, max_story_length=5)
    want = jpacking.StoryPacker(jt, SEQ, PER_SEQ).pack_berson_story(
        texts, label, max_story_length=5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert got["input_ids"].shape == (20, 2 * PER_SEQ)
    if m < 5:
        dead = (got["pairs_list"] >= m).any(1)
        assert not got["attention_mask"][dead].any()
        assert not got["pairwise_labels"][dead].any()


@pytest.mark.parametrize("multimodal", [False, True])
def test_berson_dataset_and_batches_match_jax(wikihow_dir, multimodal):
    kw = dict(data_dir=wikihow_dir, min_story_length=5, max_story_length=5)
    jex = j_get_processor("wikihow_sort", **kw).get_train_examples()
    tex = t_get_processor("wikihow_sort", **kw).get_train_examples()
    common = dict(max_length=96, per_seq_max_length=12, max_story_length=5,
                  seed=3, multimodal=multimodal, image_size=(24, 32),
                  uint8_images=True)
    jset = jds.BersonDataset(jex, jtok.load_tokenizer("simple"),
                             min_story_length=5, **common)
    tset = tds.BersonDataset(tex, ttok.load_tokenizer("simple"), **common)
    for epoch in (0, 1):
        jb = list(jds.data_loader(jset, 4, shuffle=True, seed=1, epoch=epoch))
        tb = list(tds.data_loader(tset, 4, shuffle=True, seed=1, epoch=epoch))
        assert len(jb) == len(tb) == 2
        for a, b in zip(tb, jb):
            assert set(a) == set(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
    assert tb[0]["input_ids"].shape == (4, 20, 24)
    assert ("images" in tb[0]) == multimodal


@pytest.mark.parametrize("n", [5, 3, 2])
def test_time_contrastive_plan_matches_jax(n):
    cfg = dataclasses.replace(tcfg.MultimodalConfig(), max_story_length=n)
    batch = {"input_ids": np.zeros((7, 3), np.int32)}
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):  # the generator's state carries over batches
        _, want = jobjectives.plan_objective("time_contrastive", batch, cfg, jr)
        _, got = tobjectives.plan_objective("time_contrastive", batch, cfg, tr)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(NotImplementedError):  # not an objective
        tobjectives.plan_objective("itm", batch, cfg, tr)


# ----- modules alone ---------------------------------------------------------------


def _module_cfgs(n=N):
    kw = dict(max_story_length=n)
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**ENC), **kw),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**ENC), **kw))


def test_hierarchical_attention_matches_jax():
    # random pair encodings of a batch of 2 with a short story (dead pairs
    # with the harmless span [0, 1]) and spans of every length
    jc, tc = _module_cfgs()
    rng = np.random.RandomState(0)
    b, P, L, h = 2, N * (N - 1), 16, 64
    top = rng.randn(b, P, L, h).astype(np.float32)
    sep0 = rng.randint(1, L // 2, (b, P))
    sep = np.stack([sep0, sep0 + rng.randint(1, L // 2, (b, P))], -1)
    mask_cls = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    dead = (tpacking.berson_pairs(N)[None] >= 2).any(-1) & (np.arange(b) == 1)[:, None]
    sep[dead] = [0, 1]
    jm = jberson.HierarchicalAttention(jc)
    args = (jnp.asarray(top), jnp.asarray(top[:, :, 0]), jnp.asarray(sep),
            jnp.asarray(mask_cls))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    want = jax.jit(jm.apply)(v, *args)
    tm = tberson.HierarchicalAttention(tc)
    tm.load_state_dict(tree_to_state_dict(_np(v["params"])))
    got = tm(torch.from_numpy(top), torch.from_numpy(top[:, :, 0]),
             torch.from_numpy(sep), torch.from_numpy(mask_cls))
    names = ("doc", "cls_output_matrix", "cls_score", "cls_score_matrix",
             "his1", "his2")
    for name, g, w in zip(names, got, want):
        _close(g, w, msg=name)
    assert not got[0][1, 2:].any()  # dead steps' vectors are zero


def test_inter_encoder_matches_jax():
    # 2 layers, 8 heads over the step vectors, a short story's dead steps
    # masked as keys; deterministic
    jc, tc = _module_cfgs()
    rng = np.random.RandomState(1)
    x = rng.randn(3, N, 64).astype(np.float32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 0]], np.float32)
    jm = jberson.TransformerInterEncoder(64)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(mask))
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask))
    tm = tberson.TransformerInterEncoder(64)
    sd = tree_to_state_dict(_np(v["params"]))
    assert sd["layer_0.self_attn.query.weight"].shape == (64, 64)
    assert sd["layer_0.self_attn.query.bias"].shape == (64,)
    tm.load_state_dict(sd)
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)), want)


# ----- the whole wrapper -------------------------------------------------------------


def _cfgs(kind):
    kw = dict(max_story_length=N, max_seq_length=SEQ,
              per_seq_max_length=PER_SEQ, hierarchical_version="v1",
              wrapper_model_type="berson",
              wrapper_model_with_heatmap=kind == "text")
    if kind != "text":
        kw.update(multimodal=True, image_size=(RES[kind],) * 2,
                  clip_model_name="RN50" if kind == "clip_rn" else "ViT-B/32")
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**ENC), **kw),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**ENC), **kw))


def _vcfgs(kind):
    if kind == "text":
        return None, None
    if kind == "clip_rn":
        return (jclip.CLIPVisionConfig.tiny_rn(image_resolution=64),
                tcfg.CLIPVisionConfig.tiny_rn(image_resolution=64))
    return jclip.CLIPVisionConfig.tiny_vit(), tcfg.CLIPVisionConfig.tiny_vit()


def _story_batch(kind, seed=0, lens=LENS, texts=None, n=N):
    jt, _ = _tokenizers()
    rng = np.random.RandomState(seed)
    packer = jpacking.StoryPacker(jt, SEQ, PER_SEQ)
    items = []
    for k, m in enumerate(lens):
        steps = texts or [f"alpha {k} beta {i} gamma delta {seed}"
                          for i in range(m)]
        items.append(packer.pack_berson_story(
            steps[:m], rng.permutation(m).tolist(), max_story_length=n))
    batch = {k: np.stack([np.asarray(it[k]) for it in items])
             for k in items[0]}
    batch["valid"] = np.arange(len(lens)) < len(lens) - 1  # one padding row
    if kind != "text":
        res = RES[kind]
        batch["images"] = rng.randint(0, 256, (len(lens), n, res, res, 3)
                                      ).astype(np.uint8)
    _, tc = jobjectives.plan_objective(
        "time_contrastive", batch,
        dataclasses.replace(_cfgs("text")[0], max_story_length=n),
        np.random.default_rng(seed + 11))
    batch.update(tc_anchor=tc["anchor_idx"], tc_positive=tc["positive_idx"],
                 tc_negative=tc["negative_idx"])
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return device_batch(batch, "cpu")


class Pair:
    """One JAX `BersonOrdering` (jitted methods) and the port's on its
    weights."""

    def __init__(self, kind, beam_size=3):
        self.kind = kind
        self.jc, self.tc = _cfgs(kind)
        jv, tv = _vcfgs(kind)
        mm = kind != "text"
        self.jm = jberson.BersonOrdering(self.jc, jv, beam_size=beam_size,
                                         time_contrastive=True,
                                         multimodal_loss=mm)
        self.batch = _story_batch(kind)
        self.vars = jax.jit(self.jm.init)(jax.random.PRNGKey(0),
                                          _jb(self.batch))
        self.tm = tberson.BersonOrdering(self.tc, tv, beam_size=beam_size,
                                         time_contrastive=True,
                                         multimodal_loss=mm)
        self.tm.load_state_dict(params_from_jax(
            _np(self.vars["params"]), self.tc,
            _np(self.vars.get("batch_stats")), tv))
        self.tm.eval()
        self.apply = jax.jit(self.jm.apply)
        self.encode = jax.jit(functools.partial(
            self.jm.apply, method=jberson.BersonOrdering.encode))

    def beam(self, batch, width):
        jm = self.jm.clone(beam_size=width)
        want = np.asarray(jax.jit(functools.partial(
            jm.apply, method=jberson.BersonOrdering.beam_search))(
            self.vars, _jb(batch)))
        self.tm.beam_size = width
        return self.tm.beam_search(_tb(batch)).numpy(), want


_PAIRS = {}


def _pair(kind) -> Pair:
    """The pair of `kind`, initialized once a test process (tests that
    change its weights make their own)."""
    if kind not in _PAIRS:
        _PAIRS[kind] = Pair(kind)
    return _PAIRS[kind]


@pytest.fixture(scope="module", params=["text", "clip_rn", "clip_vit"])
def pair(request):
    return _pair(request.param)


ENC_KEYS = ("doc", "key", "cls_score", "cls_output_matrix",
            "cls_score_matrix", "his1_matrix", "his2_matrix")


def test_encode_intermediates_match_jax(pair):
    want = pair.encode(pair.vars, _jb(pair.batch))
    got = pair.tm.encode(_tb(pair.batch))
    for k in ENC_KEYS:
        _close(got[k], want[k], msg=k)
    for g, w in zip(got["hcn"], want["hcn"]):
        _close(g, w, msg="hcn")
    if pair.kind != "text":
        _close(got["cls_score_img"], want["cls_score_img"])
    # a short story's dead steps: zero vectors, finite everywhere
    assert not got["doc"][1, 2:].any()
    assert all(torch.isfinite(got[k]).all() for k in ENC_KEYS)


def test_losses_match_jax(pair):
    # pointer NLL + 0.6 x pairwise CE, the time-contrastive triplets (some
    # on dead steps of the short stories), the heat-map aux (text) or the
    # image-stream pairwise CE (clip); the padding row excluded by `valid`
    want = pair.apply(pair.vars, _jb(pair.batch))
    got = pair.tm(_tb(pair.batch))
    extra = ("heatmap_loss",) if pair.kind == "text" else (
        "img_pairwise_loss",)
    keys = ("loss", "pointer_loss", "pairwise_loss", "time_contrastive_loss")
    for k in keys + extra:
        _close(got[k], want[k], msg=k)
    assert set(got) == set(want)
    _close(got["pointer_logits"], np.asarray(want["pointer_logits"]))
    if pair.kind == "text":
        _close(got["heatmap"], want["heatmap"])


def _live_tc(batch):
    """Time-contrastive times on live steps only: the JAX norm's gradient is
    NaN where anchor and positive are both dead (zero) steps."""
    b = dict(batch)
    b.update(tc_anchor=np.zeros(len(LENS), np.int32),
             tc_positive=np.ones(len(LENS), np.int32),
             tc_negative=np.ones(len(LENS), np.int32))
    return b


@pytest.mark.parametrize("kind", ["text", "clip_rn"])
def test_gradients_match_jax(kind):
    # every gradient of the deterministic loss (dropout 0; the tower's
    # BatchNorms on their running statistics), its distance over the global
    # norm
    p = _pair(kind)
    batch = _live_tc(p.batch)

    def loss(params):
        return p.jm.apply({**p.vars, "params": params}, _jb(batch))["loss"]

    want = tree_to_state_dict(_np(jax.jit(jax.grad(loss))(
        p.vars["params"])))
    p.tm.zero_grad()
    p.tm(_tb(batch))["loss"].backward()
    got = {n: q.grad if q.grad is not None else torch.zeros_like(q)
           for n, q in p.tm.named_parameters()}
    assert set(got) == set(want)
    total = sum(float((w.double() ** 2).sum()) for w in want.values()) ** 0.5
    for name, w in want.items():
        err = (got[name].double() - w.double()).norm().item() / total
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("width", [2, 6])
def test_beam_orders_match_jax(pair, width):
    # W < n and W > n (the tied beams of the first step stay for the stories
    # of 2 steps); orders are permutations of each true length
    got, want = pair.beam(pair.batch, width)
    np.testing.assert_array_equal(got, want)
    for row, m in zip(got, LENS):
        assert sorted(row[:m]) == list(range(m)) and (row[m:] == -1).all()


class _Jitted:
    """A Flax module whose `apply(variables, batch, method=...)` is
    jitted."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, batch, method):
        return jax.jit(functools.partial(self.module.apply, method=method))(
            variables, batch)


class _GivenEncoding(jberson.BersonOrdering):
    """The JAX wrapper with `encode` replaced by the batch's `enc_*`
    entries."""

    def encode(self, batch, deterministic=True, trunk_out=None):
        enc = {k[4:]: v for k, v in batch.items() if k.startswith("enc_")}
        enc["hcn"] = (enc.pop("h"), enc.pop("c"))
        return enc


def test_beam_exact_ties_take_the_lower_index():
    # an encoding whose steps are all alike, in values whose sums are exact
    # in any order: every candidate of every pointer step ties exactly, so
    # the orders are decided by the tie rule alone (the lower index first,
    # as jax.lax.top_k takes it), on a full story and one of 3 steps
    p = _pair("text")
    b, h = 2, 64
    mask_cls = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
    off = ~np.eye(N, dtype=bool)[None, :, :, None]
    enc = {"doc": np.full((b, N, h), 0.5, np.float32) * mask_cls[..., None],
           "key": np.full((b, N, h), 0.25, np.float32),
           "h": np.full((b, h), 0.125, np.float32),
           "c": np.zeros((b, h), np.float32),
           "cls_output_matrix": np.where(off, 0.5, 0.0).astype(np.float32)
           * np.ones((b, N, N, h), np.float32),
           "cls_score_matrix": np.zeros((b, N, N, 2), np.float32),
           "mask_cls": mask_cls}
    batch = {f"enc_{k}": v for k, v in enc.items()}
    for width in (1, 3, 6):
        want = np.asarray(_Jitted(_GivenEncoding(p.jc, beam_size=width)).apply(
            p.vars, _jb(batch), method=jberson.BersonOrdering.beam_search))
        p.tm.beam_size = width
        got = p.tm.beam_search({}, {
            "hcn": (torch.from_numpy(enc["h"]), torch.from_numpy(enc["c"])),
            **{k: torch.from_numpy(v) for k, v in enc.items()
               if k not in ("h", "c")}}).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, [[0, 1, 2, 3], [0, 1, 2, -1]])


def test_train_step_and_batch_norm_statistics_match_jax(monkeypatch):
    # 3 train steps of the RN50 inner (BatchNorm in train mode, statistics
    # updated once a step) with the optimizer, the paragraph encoder's own
    # dropout set to 0 in both packages. Along the JAX package's trajectory
    # (the port's weights and statistics set to its state before each step;
    # Adam turns f32 noise into steps of up to lr, so two trajectories part
    # by ~1e-5 of the loss within 3 steps): the loss and the statistics
    # after each step, and the weights after the last update
    monkeypatch.setattr(jberson, "TransformerInterEncoder", functools.partial(
        jberson.TransformerInterEncoder, dropout=0.0))
    p = Pair("clip_rn")
    p.tm.para_encoder.dropout = 0.0
    tv = _vcfgs("clip_rn")[1]
    kw = dict(learning_rate=2e-3, warmup_steps=1, total_steps=3,
              weight_decay=0.01, adam_epsilon=1e-8, max_grad_norm=1.0)
    tx = make_optimizer(**kw)
    params = p.vars["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params),
                       model_state={"batch_stats": p.vars["batch_stats"]},
                       tx=tx, apply_fn=p.jm.apply)

    @jax.jit
    def j_step(state, batch):
        def loss_fn(prm):
            out, ms = state.apply_fn({"params": prm, **state.model_state},
                                     batch, deterministic=False,
                                     rngs={"dropout": jax.random.PRNGKey(0)},
                                     mutable=["batch_stats"])
            return out["loss"], ms
        (loss, ms), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(g, ms), loss

    opt = AdamW(p.tm, **kw)
    for i in range(3):
        batch = _live_tc(_story_batch("clip_rn", seed=20 + i))
        p.tm.load_state_dict(params_from_jax(
            _np(state.params), p.tc, _np(state.model_state), tv))
        state, want_loss = j_step(state, _jb(batch))
        out = berson_train_step(p.tm, opt, batch, i, 0)
        np.testing.assert_allclose(float(out["loss"]), float(want_loss),
                                   rtol=1e-5)
        mine = p.tm.state_dict()
        stats = tree_to_state_dict({}, _np(state.model_state["batch_stats"]))
        assert len(stats) == 2 * 19  # 3 stem + 4 x 4 block BatchNorms
        for key, val in stats.items():
            np.testing.assert_allclose(mine[key].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
    final = params_from_jax(_np(state.params), p.tc, _np(state.model_state),
                            tv)
    for key, val in p.tm.state_dict().items():
        # Adam moves an entry whose gradient is rounding noise by a
        # fraction of lr; the attention key biases (softmax-invariant, zero
        # gradient but for rounding) by up to lr either way
        atol = (2 * kw["learning_rate"] if key.endswith(
            ("key.bias", "k_proj.bias")) else kw["learning_rate"] / 10)
        np.testing.assert_allclose(val.numpy(), final[key].numpy(),
                                   atol=atol, rtol=0, err_msg=key)


def test_sort_evaluator_berson_matches_jax(pair):
    # the eval harness's berson branch: pack with an identity label, beam
    # search, cut to each story's length
    jt, tt = _tokenizers()
    rng = np.random.RandomState(5)
    stories = [[f"step {k} part {i} words" for i in range(m)]
               for k, m in enumerate([4, 3, 2])]
    images = (None if pair.kind == "text" else rng.randint(
        0, 256, (3, N, RES[pair.kind], RES[pair.kind], 3)).astype(np.uint8))
    jev = JSortEvaluator(pair.jc, jpacking.StoryPacker(jt, SEQ, PER_SEQ))
    want = jev._decode_batch("berson", {"berson": (
        _Jitted(pair.jm.clone(beam_size=4)), pair.vars)}, stories, images)
    tev = SortEvaluator(pair.tc, tpacking.StoryPacker(tt, SEQ, PER_SEQ),
                        "cpu")
    pair.tm.beam_size = 4
    got = tev._decode_batch("berson", {"berson": pair.tm}, stories, images)
    assert got == want
    assert [sorted(o) for o in got] == [list(range(m)) for m in (4, 3, 2)]
    assert len(tev.forward_seconds) == len(tev.decode_seconds) == 1


# ----- model construction ---------------------------------------------------------


def test_init_weights_follow_flax_initializers():
    # lecun_normal (fan-in = input width) for the heads' Denses and the
    # multi-head projections, orthogonal recurrent LSTM kernels, zero
    # biases; a seed gives the same model
    _, tc = _cfgs("text")
    model = init_weights(tberson.BersonOrdering(tc), 0)
    for g in "ifgo":
        w = getattr(model.decoder, f"h{g}").weight
        torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5,
                                   rtol=0)
        assert not getattr(model.decoder, f"h{g}").bias.any()
        assert getattr(model.decoder, f"i{g}").bias is None
    ff = model.para_encoder.layer_0.ff_1.weight  # fan-in 64
    assert abs(ff.std().item() - 64 ** -0.5) < 0.01
    out = model.para_encoder.layer_1.self_attn.out.weight
    assert abs(out.std().item() - 64 ** -0.5) < 0.02
    again = init_weights(tberson.BersonOrdering(tc), 0)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("multimodal", [False, True])
def test_pretrained_weights_load_into_the_inner_encoder(tmp_path, multimodal):
    # a local HF text model's weights go into BERSON's `inner` (the JAX
    # package's apply_pretrained_to_state(..., encoder_key="inner")), as
    # convert_hf_text_encoder gives them; a BERSON checkpoint of the port
    # serves as --clip_visual_model_weights: its tower, and nothing else
    import argparse
    from multimodal_sequencing_tpu_torch.models.convert import (
        convert_hf_text_encoder, load_pretrained_weights)
    from multimodal_sequencing_tpu_torch.train.checkpoint import save_model
    from test_torch_train import _hf_state_dict
    hf = tmp_path / "hf"
    hf.mkdir()
    sd = _hf_state_dict("roberta.")
    torch.save(sd, hf / "pytorch_model.bin")
    kw = dict(multimodal=True, image_size=(64, 64)) if multimodal else {}
    tc = tcfg.MultimodalConfig(
        encoder=tcfg.EncoderConfig.tiny(vocab_size=50265),
        max_story_length=N, wrapper_model_type="berson", **kw)
    tv = _vcfgs("clip_rn")[1] if multimodal else None
    model = init_weights(tberson.BersonOrdering(tc, tv), 0)
    assert load_pretrained_weights(model, argparse.Namespace(
        model_name_or_path=str(hf), clip_visual_model_weights=None))
    got = model.inner.state_dict()
    want = convert_hf_text_encoder(sd, 2)
    assert len(want) > 30
    for key, val in want.items():
        assert torch.equal(got[key], val), key
    if not multimodal:
        return
    save_model(model, tc, str(tmp_path / "ckpt"))
    fresh = init_weights(tberson.BersonOrdering(tc, tv), 1)
    assert load_pretrained_weights(fresh, argparse.Namespace(
        model_name_or_path="simple",
        clip_visual_model_weights=str(tmp_path / "ckpt")))
    tower = [k for k in fresh.state_dict() if k.startswith(
        "inner.visual_model.")]
    assert tower
    for key in tower:
        assert torch.equal(fresh.state_dict()[key], model.state_dict()[key])
    assert not torch.equal(fresh.inner.layer_0.attention.query.weight,
                           model.inner.layer_0.attention.query.weight)


@pytest.mark.parametrize("mt", ["visualbert", "naive", "vilbert"])
def test_other_inner_encoders_raise(mt):
    _, tc = _cfgs("clip_rn")
    with pytest.raises(NotImplementedError, match="A5" if mt != "vilbert"
                       else "raise here too"):
        tberson.BersonOrdering(dataclasses.replace(
            tc, multimodal_model_type=mt))
    with pytest.raises(NotImplementedError, match="text stream"):
        tberson.BersonOrdering(dataclasses.replace(tc,
                                                   multimodal_img_part=True))


# ----- the CLI ---------------------------------------------------------------------


def _train_argv(data, out, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--do_train", "--task_name", "wikihow_hl_v1",
            "--wrapper_model_type", "berson", "--beam_size", "4",
            "--data_dir", data, "--max_seq_length", "64",
            "--per_seq_max_length", "8", "--per_gpu_train_batch_size", "2",
            "--per_gpu_eval_batch_size", "2", "--learning_rate", "1e-3",
            "--warmup_steps", "1", "--logging_steps", "1", "--seed", "0",
            "--eval_splits", "dev", "--output_dir", str(out),
            "--overwrite_output_dir", "--device", "cpu", *extra]


def _eval_argv(data, out, ckpt, *extra):
    return ["--model_name_or_path", str(ckpt), "--model_size", "tiny",
            "--task_name", "wikihow_sort", "--sort_method", "berson",
            "--beam_size", "4", "--data_dir", data, "--eval_splits", "dev",
            "--max_seq_length", "64", "--per_seq_max_length", "8",
            "--per_gpu_eval_batch_size", "2", "--output_dir", str(out),
            "--device", "cpu", *extra]


MM = ["--multimodal", "--vision_image_size", "32"]


def test_berson_config_and_model_match_jax(wikihow_dir, tmp_path):
    # the config of the wrapper's flags (what config.json records), the
    # model's options and its parameter tree's shapes
    argv = _train_argv(wikihow_dir, tmp_path, *MM, "--multimodal_loss",
                       "--wrapper_model_with_heatmap", "--beam_size", "3",
                       "--pairwise_loss_lam", "0.4",
                       "--additional_wrapper_level_objectives",
                       "time_contrastive")
    at = argv.index("--device")  # the JAX parser has no --device
    jargs = jcli.resolve_args(jcli.build_parser("train").parse_args(
        argv[:at] + argv[at + 2:]))
    targs = tcli.parse_args("train", argv)
    jc, tc = jcli.build_config(jargs)[0], tcli.build_config(targs)[0]
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    assert tc.wrapper_model_type == "berson" and tc.wrapper_model_with_heatmap
    jm, tm = jcli.build_model(jc, jargs), tcli.build_berson(tc, targs)
    for name in ("beam_size", "pairwise_loss_lam", "time_contrastive",
                 "multimodal_loss"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert (3, 0.4) == (tm.beam_size, tm.pairwise_loss_lam)


@pytest.mark.parametrize("extra", [
    ["--wrapper_model_with_heatmap", "--additional_wrapper_level_objectives",
     "time_contrastive"],
    MM + ["--clip_model_name", "ViT-B/32"],
    MM + ["--multimodal_loss"]],
    ids=["text", "clip_vit", "clip_rn_multimodal_loss"])
def test_cli_train_do_eval_and_eval(wikihow_dir, tmp_path, extra):
    out = tmp_path / "run"
    res = tcli.main_train(_train_argv(
        wikihow_dir, out, "--max_steps", "3", "--save_steps", "2",
        "--evaluate_during_training", "--do_eval", *extra))
    assert res.global_step == 3
    assert all(np.isfinite(h["loss"]) for h in res.history)
    names = sorted(os.listdir(out))
    assert names == ["checkpoint-2", "checkpoint-3", "checkpoint-best",
                     "eval_results_split_dev_checkpoint-2.txt",
                     "eval_results_split_dev_checkpoint-3.txt",
                     "eval_results_split_dev_checkpoint-best.txt", "logs"]
    assert set(res.eval_results) == {"checkpoint-2", "checkpoint-3",
                                     "checkpoint-best"}
    for tag, by_split in res.eval_results.items():
        assert set(by_split["dev"]) == {"partial_match", "exact_match", "tau"}
    ck = out / "checkpoint-3"
    saved = tcfg.MultimodalConfig.from_json((ck / "config.json").read_text())
    assert saved.wrapper_model_type == "berson"
    assert (ck / "vision_config.json").exists() == ("--multimodal" in extra)
    ev_argv = _eval_argv(wikihow_dir, tmp_path / "eval", ck,
                         *[a for a in extra if a in MM + [
                             "--clip_model_name", "ViT-B/32"]])
    if "--multimodal_loss" in extra:
        # the eval's BERSON has no image-stream head, as in the JAX package
        with pytest.raises(ValueError, match="multimodal_loss"):
            tcli.main_eval(ev_argv)
        return
    ev = tcli.main_eval(ev_argv)
    orders = [[int(x) for x in line.split()] for line in
              (tmp_path / "eval" / "output_order.txt").read_text().splitlines()]
    assert len(orders) == 2 and all(sorted(o) == list(range(5))
                                    for o in orders)
    assert set(ev["dev"]) >= {"partial_match", "exact_match", "tau"}
    # a heat-map eval of a BERSON checkpoint is refused
    with pytest.raises(ValueError, match="BERSON"):
        tcli.main_eval([a if a != "berson" else "heat_map" for a in ev_argv])


def test_jax_eval_refuses_a_multimodal_loss_checkpoint(tmp_path, monkeypatch):
    # what the port's eval does with such a checkpoint is what the JAX
    # package's does: its eval model has no img_projection, and the restore
    # refuses the checkpoint's extra parameters
    from multimodal_sequencing_tpu.train.checkpoint import save_checkpoint
    jc = dataclasses.replace(_cfgs("clip_vit")[0], max_story_length=2)
    jv, _ = _vcfgs("clip_vit")
    jm = jberson.BersonOrdering(jc, jv, beam_size=2, multimodal_loss=True)
    batch = _story_batch("clip_vit", lens=[2], n=2)
    v = dict(jax.jit(jm.init)(jax.random.PRNGKey(0), _jb(batch)))
    params = v.pop("params")
    assert "img_projection" in params
    tx = make_optimizer()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), model_state=v, tx=tx,
                       apply_fn=jm.apply)
    ck = save_checkpoint(str(tmp_path), 1, state, cfg=jc)
    args = jcli.build_parser("eval").parse_args([
        "--model_name_or_path", "simple", "--model_size", "tiny",
        "--multimodal", "--clip_model_name", "ViT-B/32",
        "--vision_image_size", "32", "--max_story_length", "2",
        "--max_seq_length", str(SEQ), "--per_seq_max_length", str(PER_SEQ)])
    args = jcli.resolve_args(args)
    # the eval's init jitted (its values are the eager init's)
    init = jberson.BersonOrdering.init
    monkeypatch.setattr(jberson.BersonOrdering, "init", lambda self, *a: (
        jax.jit(functools.partial(init, self))(*a)))
    with pytest.raises(ValueError, match="img_projection"):
        jcli.load_model_for_eval(jc, args, "berson", ck)
