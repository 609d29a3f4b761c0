"""The port's v0 baselines against the JAX package's, on the CPU: the WikiHow
pairwise and abductive processors (tight and loose), the permutation
codec, `pack_all_pairs` (native, numpy and JAX's), the pairwise, head,
abductive, pure_class and retrieval datasets, the v0 `SequencingModel`
(text, `tiny_rn`, `tiny_vit`: logits, loss and gradients on weights moved
by `params_from_jax`), the topological and sequential decoders, the five
baseline sort methods of `SortEvaluator`, one `main_train` run of each v0
task, and the eval CLI's roles. Tiny configs, f32; every comparison states
its tolerance."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sequencing_tpu.ops.preprocess  # noqa: F401 (imported
# before any trace: its module constants must not be built under jit)
from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import packing as jpack
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import (
    get_processor as j_get_processor)
from multimodal_sequencing_tpu.models import clip_visual as jclip
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.parallel.mesh import make_mesh
from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu.train import loop as jloop
from multimodal_sequencing_tpu.train.evaluation import (
    SortEvaluator as JSortEvaluator)
from multimodal_sequencing_tpu.train.steps import (
    compute_loss as j_compute_loss)
from multimodal_sequencing_tpu.utils import permutation as jperm
from multimodal_sequencing_tpu_torch.data import _native
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import packing as tpack
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.caption_transforms import (
    CaptionTransformations)
from multimodal_sequencing_tpu_torch.data.registry import (
    get_processor as t_get_processor)
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
from multimodal_sequencing_tpu_torch.models.sequencer import SequencingModel
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train import loop as tloop
from multimodal_sequencing_tpu_torch.train.evaluation import (
    SortEvaluator as TSortEvaluator)
from multimodal_sequencing_tpu_torch.train.steps import compute_loss
from multimodal_sequencing_tpu_torch.utils import permutation as tperm

torch.set_num_threads(1)

MAX_LEN, PER_SEQ, N = 96, 12, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _asdicts(examples):
    return [dataclasses.asdict(e) for e in examples]


# ----- processors, permutations, packing -----------------------------------


PROCESSOR_CASES = {
    "pairwise_tight": ("wikihow_pairwise", dict(order_criteria="tight")),
    "pairwise_loose": ("wikihow_pairwise", dict(order_criteria="loose")),
    "abductive": ("wikihow_abductive", {}),
    "abductive_contrastive": ("wikihow_abductive",
                              dict(pred_method="contrastive")),
    "head": ("wikihow_head", {}),
    "pure_class": ("wikihow_pure_class", dict(pure_class=True)),
}


@pytest.mark.parametrize("images", [True, False])
@pytest.mark.parametrize("case", sorted(PROCESSOR_CASES))
def test_wikihow_processors_match_jax(wikihow_dir, case, images):
    task, kw = PROCESSOR_CASES[case]
    kw = dict(kw, data_dir=wikihow_dir, paired_with_image=images,
              min_story_length=4, max_story_length=5)
    # the eval caption transformation keeps the first sentence of a step
    ct = ("max_sentence_1", None)
    for spec in ct:
        tr = dict(caption_transforms=None if spec is None else
                  CaptionTransformations(None, "wikihow", [spec]))
        jproc = j_get_processor(task, **kw, **tr)
        tproc = t_get_processor(task, **kw, **tr)
        assert tproc.get_labels() == jproc.get_labels()
        for split in ("train", "dev", "test"):
            want = getattr(jproc, f"get_{split}_examples")()
            got = getattr(tproc, f"get_{split}_examples")()
            assert want and _asdicts(got) == _asdicts(want), (case, split)
    if case == "pairwise_loose":  # 6 stories of 5 steps: 20 pairs each
        assert len(got) == 2 * 20 and sum(
            e.label == "ordered" for e in got) == 2 * 10


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6])
def test_permutation_codec_matches_jax(n):
    want = jperm.build_permutation_label_maps(n)
    assert tperm.build_permutation_label_maps(n) == want
    for rank, perm in want[1].items():
        assert tperm.permutation_rank(perm) == jperm.permutation_rank(perm) \
            == rank
        assert tperm.permutation_unrank(rank, n) == perm


def _step_ids(seed, n, vocab=1000):
    rng = np.random.default_rng(seed)
    return [np.concatenate([[0], rng.integers(5, vocab, int(rng.integers(
        1, 14))), [2]]).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("n,L", [(5, 64), (5, 16), (3, 128), (2, 7)])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_pack_all_pairs_matches_jax(monkeypatch, n, L, route):
    # every ordered pair (i, j), i != j, i-major, cut at L (L 16 and 7 cut
    # some pairs inside their second or first step)
    if route == "native":
        assert _native.available(), _native.build_error()
    else:
        monkeypatch.setattr(_native, "_load", lambda: None)
    for seed in range(3):
        ids = _step_ids(seed, n)
        texts = [f"t{seed}_{k}" for k in range(n)]
        jp = jpack.StoryPacker(jtok.load_tokenizer("simple"), L, PER_SEQ)
        tp = tpack.StoryPacker(ttok.load_tokenizer("simple"), L, PER_SEQ)
        for packer in (jp, tp):
            packer._cache.update(zip(texts, ids))
        want = jp.pack_all_pairs(texts, L)
        got = tp.pack_all_pairs(texts, L)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        for a, b in ((0, 1), (n - 1, 0)):
            for g, w in zip(tp.pack_pair(texts[a], texts[b]),
                            jp.pack_pair(texts[a], texts[b])):
                np.testing.assert_array_equal(g, w)


# ----- datasets ------------------------------------------------------------


DATASETS = {
    "pairwise": ("wikihow_pairwise", "PairwiseDataset", {}),
    "head": ("wikihow_head", "HeadPredDataset", {}),
    "abductive": ("wikihow_abductive", "AbductiveDataset", {}),
    "pure_class": ("wikihow_pure_class", "PureClassDataset",
                   dict(decode=False)),
    "retrieve": ("wikihow_retrieve", "RetrievalDataset", {}),
}


def _same_items(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray) or np.isscalar(want[k]):
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("multimodal", [False, True])
@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_datasets_match_jax(wikihow_dir, kind, multimodal):
    task, cls, kw = DATASETS[kind]
    pkw = dict(data_dir=wikihow_dir, paired_with_image=multimodal,
               order_criteria="loose")
    jex = j_get_processor(task, **pkw).get_train_examples()
    tex = t_get_processor(task, **pkw).get_train_examples()
    common = dict(max_length=MAX_LEN, per_seq_max_length=PER_SEQ,
                  max_story_length=N, seed=3, multimodal=multimodal,
                  image_size=(32, 32))
    jset = getattr(jds, cls)(jex, jtok.load_tokenizer("simple"),
                             min_story_length=N, **common, **kw)
    tset = getattr(tds, cls)(tex, ttok.load_tokenizer("simple"), **common,
                             **kw)
    assert len(tset) == len(jset) > 0
    for epoch in (0, 1):
        for i in range(len(jset)):
            _same_items(tset.__getitem__(i, epoch), jset.__getitem__(i, epoch))
    jb = list(jds.data_loader(jset, 4, shuffle=True, seed=1, epoch=1))
    tb = list(tds.data_loader(tset, 4, shuffle=True, seed=1, epoch=1))
    assert len(tb) == len(jb)
    for got, want in zip(tb, jb):
        _same_items(got, want)
    if kind == "retrieve":
        for got, want in zip(tset.candidates_list(), jset.candidates_list()):
            _same_items(got, want)
    if kind == "pure_class":  # the label is the scramble's rank
        item = tset[0]
        assert 0 <= int(item["labels"]) < 120


# ----- the v0 model -------------------------------------------------------


def _cfgs(num_labels=2, clip=None, **kw):
    enc = dict(vocab_size=1000, type_vocab_size=N, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, gelu_impl="erf")
    common = dict(hierarchical_version="v0", num_labels=num_labels,
                  max_story_length=N, max_seq_length=MAX_LEN,
                  per_seq_max_length=PER_SEQ, **kw)
    if clip is not None:
        res = 64 if clip == "RN50" else 32
        common.update(multimodal=True, clip_model_name=clip,
                      image_size=(res, res))
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc),
                                  **common),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc),
                                  **common))


def _vcfgs(clip):
    if clip is None:
        return None, None
    if clip == "RN50":
        return (jclip.CLIPVisionConfig.tiny_rn(image_resolution=64),
                tcfg.CLIPVisionConfig.tiny_rn(image_resolution=64))
    return (jclip.CLIPVisionConfig.tiny_vit(),
            tcfg.CLIPVisionConfig.tiny_vit())


def _batch(b, n_labels, seed, images=None, res=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1000, (b, MAX_LEN)).astype(np.int32)
    steps = MAX_LEN // N
    ids[:, ::steps] = 0
    am = np.ones((b, MAX_LEN), np.int32)
    am[-1, MAX_LEN - 20:] = 0
    ids[am == 0] = 1
    out = {"input_ids": ids, "attention_mask": am,
           "token_type_ids": (np.arange(MAX_LEN) // steps).clip(max=N - 1)[
               None].repeat(b, 0).astype(np.int32),
           "labels": rng.integers(0, n_labels, b).astype(np.int32),
           "valid": np.arange(b) < b - 1}  # the last row is padding
    if images is not None:
        out["images"] = rng.integers(0, 256, (b, images, res, res, 3)).astype(
            np.uint8)
    return out


def _pair(num_labels, clip=None, seed=1):
    """A JAX v0 sequencer, its variables, and the port's on its weights."""
    jc, tc = _cfgs(num_labels, clip)
    jv, tv = _vcfgs(clip)
    jm = JSequencingModel(jc, jv)
    ids = np.full((1, MAX_LEN), jc.pad_id, np.int32)
    ids[0, 0] = jc.cls_id
    init = {} if clip is None else {"images": jnp.zeros(
        (1, 2, jc.image_size[0], jc.image_size[0], 3), jnp.uint8)}
    variables = _np(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                     jnp.asarray(ids), **init))
    tm = SequencingModel(tc, tv)
    tm.load_state_dict(params_from_jax(variables["params"], tc,
                                       variables.get("batch_stats"), tv))
    return jc, tc, jm, variables, tm.eval(), tv


MODEL_CASES = [(2, None), (5, None), (120, None), (2, "RN50"),
               (2, "ViT-B/32")]


@pytest.mark.parametrize("num_labels,clip", MODEL_CASES)
def test_v0_model_matches_jax(num_labels, clip):
    jc, tc, jm, variables, tm, tv = _pair(num_labels, clip)
    assert {"cls_head.dense.weight", "cls_head.out_proj.weight",
            "cls_head.out_proj.bias"} <= set(tm.state_dict())
    assert tm.cls_head.out_proj.weight.shape == (num_labels, 64)
    assert not hasattr(tm, "heatmap_head")
    batch = _batch(4, num_labels, 3, None if clip is None else 2,
                   tc.image_size[0])
    keys = ("input_ids", "attention_mask", "token_type_ids")
    extra = {} if clip is None else {"images": batch["images"]}
    want = jax.jit(jm.apply)(variables, *[jnp.asarray(batch[k]) for k in keys],
                             **{k: jnp.asarray(v) for k, v in extra.items()})
    with torch.no_grad():
        got = tm(*[torch.from_numpy(batch[k]).long() for k in keys],
                 **{k: torch.from_numpy(v) for k, v in extra.items()})
    # f32 logits within 1e-5 relative to their largest entry
    w = np.asarray(want["logits"])
    assert got["logits"].dtype == torch.float32 and w.shape == (4, num_labels)
    np.testing.assert_allclose(got["logits"].numpy(), w,
                               atol=1e-5 * np.abs(w).max(), rtol=1e-5)

    # the train-mode loss (dropout 0, BatchNorm by the batch) and its
    # gradients: loss within 1e-5 relative, each gradient within 1e-5 of
    # the global gradient norm
    def loss_fn(params):
        v = dict(variables, params=params)
        out, _ = jm.apply(v, *[jnp.asarray(batch[k]) for k in keys],
                          **{k: jnp.asarray(x) for k, x in extra.items()},
                          deterministic=False, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        loss, metrics = j_compute_loss(jc, out, {
            "labels": jnp.asarray(batch["labels"]),
            "valid": jnp.asarray(batch["valid"])})
        return loss, metrics["acc"]

    (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tm.train()
    out = tm(*[torch.from_numpy(batch[k]).long() for k in keys],
             **{k: torch.from_numpy(v) for k, v in extra.items()},
             deterministic=False, rng=DropoutRng(0, 0, "cpu"))
    tb = {"labels": torch.from_numpy(batch["labels"]).long(),
          "valid": torch.from_numpy(batch["valid"])}
    loss, metrics = compute_loss(tc, out, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert metrics["acc"].item() == pytest.approx(float(jacc))
    want_g = tree_to_state_dict(_np(jgrads))
    norm = np.sqrt(sum(float((g.double() ** 2).sum())
                       for g in want_g.values()))
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    assert set(want_g) == set(got_g)
    for k, g in want_g.items():
        gg = torch.zeros_like(g) if got_g[k] is None else got_g[k]
        np.testing.assert_allclose(gg.numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * norm, err_msg=k)


def test_v0_loss_without_valid_and_other_heads():
    _, tc, _, _, tm, _ = _pair(2)
    batch = _batch(3, 2, 5)
    out = tm(*[torch.from_numpy(batch[k]).long() for k in
               ("input_ids", "attention_mask", "token_type_ids")])
    labels = torch.from_numpy(batch["labels"]).long()
    loss, m = compute_loss(tc, out, {"labels": labels})
    want = torch.nn.functional.cross_entropy(out["logits"], labels)
    torch.testing.assert_close(loss, want)
    assert set(m) == {"loss", "acc"}
    # the p0 pointer head builds on the same config, without cls_head
    p0 = SequencingModel(dataclasses.replace(tc, hierarchical_version="p0"))
    assert hasattr(p0, "pointer_head") and not hasattr(p0, "cls_head")


# ----- decoders -------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("head", [False, True])
def test_decode_topological_matches_jax(n, head):
    rng = np.random.default_rng(n + 10 * head)
    logits = rng.normal(size=(64, n, n, 2)).astype(np.float32)
    head_idx = rng.integers(0, n, 64) if head else None
    want = JSortEvaluator.decode_topological(logits, head_idx)
    got = TSortEvaluator.decode_topological(logits, head_idx)
    assert got == want
    assert all(sorted(o) == list(range(n)) for o in got)
    if head:
        assert [o[0] for o in got] == head_idx.tolist()


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("abductive", [False, True])
def test_decode_sequential_matches_jax(n, abductive):
    rng = np.random.default_rng(n + 10 * abductive)
    logits = rng.normal(size=(64, n, n)).astype(np.float32)
    # exact ties on some rows: both take the lowest remaining step
    logits[:8] = np.round(logits[:8])
    head_idx = rng.integers(0, n, 64)
    cube = (rng.normal(size=(64, n, n, n)).astype(np.float32) * 10
            if abductive else None)
    want = JSortEvaluator.decode_sequential(logits, head_idx, cube)
    got = TSortEvaluator.decode_sequential(logits, head_idx, cube)
    assert got == want
    if abductive and n > 3:  # the cube changes some orders (at n = 3 the
        # third step is the one left)
        assert got != TSortEvaluator.decode_sequential(logits, head_idx)


# ----- the evaluator ----------------------------------------------------------


METHOD_ROLES = {
    "topological": ["pairwise"],
    "head_and_topological": ["head", "pairwise"],
    "head_and_sequential": ["head", "pairwise"],
    "head_and_sequential_abductive": ["head", "pairwise", "abductive"],
    "pure_class": ["pure_class"],
}
ROLE_LABELS = {"pairwise": 2, "abductive": 2, "head": N, "pure_class": 120}


def _eval_cfgs(device_decode=False):
    jc, tc = _cfgs(2, device_decode=device_decode)
    vocab = dict(vocab_size=50265)  # the simple tokenizer's ids
    return (dataclasses.replace(jc, encoder=dataclasses.replace(
        jc.encoder, **vocab)), dataclasses.replace(
        tc, encoder=dataclasses.replace(tc.encoder, **vocab)))


def _role_models(roles, jc, tc, seed):
    out = {}
    for k, role in enumerate(roles):
        jrc = dataclasses.replace(jc, num_labels=ROLE_LABELS[role])
        trc = dataclasses.replace(tc, num_labels=ROLE_LABELS[role])
        jm = JSequencingModel(jrc)
        ids = np.full((1, MAX_LEN), jrc.pad_id, np.int32)
        ids[0, 0] = jrc.cls_id
        v = _np(jax.jit(jm.init)(jax.random.PRNGKey(seed + k),
                                 jnp.asarray(ids)))
        tm = SequencingModel(trc)
        tm.load_state_dict(params_from_jax(v["params"], trc))
        out[role] = ((jm, v), tm.eval())
    return out


def _sort_loaders(wikihow_dir, split="train"):
    kw = dict(data_dir=wikihow_dir, min_story_length=N, max_story_length=N)
    common = dict(max_length=MAX_LEN, per_seq_max_length=PER_SEQ,
                  max_story_length=N, seed=0)
    jex = getattr(j_get_processor("wikihow_sort", paired_with_image=False,
                                  **kw), f"get_{split}_examples")()
    tex = getattr(t_get_processor("wikihow_sort", paired_with_image=False,
                                  **kw), f"get_{split}_examples")()
    return (jds.data_loader(jds.SortDataset(
                jex, jtok.load_tokenizer("simple"), **common), 4),
            tds.data_loader(tds.SortDataset(
                tex, ttok.load_tokenizer("simple"), **common), 4))


@pytest.mark.parametrize("method,device_decode", [
    ("topological", False), ("topological", True),
    ("head_and_topological", False), ("head_and_sequential", False),
    ("head_and_sequential_abductive", False), ("pure_class", False)])
def test_evaluator_methods_match_jax(wikihow_dir, tmp_path, method,
                                     device_decode):
    jc, tc = _eval_cfgs(device_decode)
    models = _role_models(METHOD_ROLES[method], jc, tc, seed=7)
    jloader, tloader = _sort_loaders(wikihow_dir)
    tok = "simple"
    jres = JSortEvaluator(
        jc, jpack.StoryPacker(jtok.load_tokenizer(tok), MAX_LEN, PER_SEQ),
        micro_batch=16).evaluate(
            jloader, method, {r: m[0] for r, m in models.items()},
            output_dir=str(tmp_path / "jax"), data_split="train")
    evaluator = TSortEvaluator(
        tc, tpack.StoryPacker(ttok.load_tokenizer(tok), MAX_LEN, PER_SEQ),
        device="cpu", micro_batch=16)
    tres = evaluator.evaluate(tloader, method,
                              {r: m[1] for r, m in models.items()},
                              output_dir=str(tmp_path / "port"),
                              data_split="train")
    assert tres == jres
    for name in ("output_order.txt", "all_predictions.csv",
                 "eval_results_split_train.txt"):
        assert (tmp_path / "port" / name).read_text() == (
            tmp_path / "jax" / name).read_text()
    # 6 stories in batches of 4: 2 batches; per batch, 20 pairs a story at
    # micro-batch 16, a story forward for the head, 60 triples a story
    per_batch = {"topological": [5, 3], "head_and_topological": [6, 4],
                 "head_and_sequential": [6, 4],
                 "head_and_sequential_abductive": [21, 12],
                 "pure_class": [1, 1]}[method]
    assert evaluator.forwards == sum(per_batch)
    assert len(evaluator.forward_seconds) == len(
        evaluator.decode_seconds) == 2


def test_pair_logit_matrix_and_cube_match_jax(wikihow_dir):
    jc, tc = _eval_cfgs()
    models = _role_models(["pairwise"], jc, tc, seed=3)
    (jm, v), tm = models["pairwise"]
    batch = next(_sort_loaders(wikihow_dir)[1])
    stories = batch["texts"]
    jev = JSortEvaluator(jc, jpack.StoryPacker(
        jtok.load_tokenizer("simple"), MAX_LEN, PER_SEQ), micro_batch=16)
    tev = TSortEvaluator(tc, tpack.StoryPacker(
        ttok.load_tokenizer("simple"), MAX_LEN, PER_SEQ), "cpu",
        micro_batch=16)
    want = jev.pair_logit_matrix(jm, v, stories)
    got = tev.pair_logit_matrix(tm, stories)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0)
    want = jev.abductive_logit_cube(jm, v, stories)
    got = tev.abductive_logit_cube(tm, stories)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    # 4 stories: 80 pairs of 2 x 12 tokens packed to 64, 240 triples to
    # max_seq_length, at micro-batch 16
    assert tev.forwards == 5 + 15


# ----- the CLIs ---------------------------------------------------------------


def _no_dropout_tiny(monkeypatch):
    """Both packages' `EncoderConfig.tiny` (f32) at dropout 0, so both
    train the same function through their CLIs (their dropout bits
    differ)."""
    for mod in (jcfg, tcfg):
        real = mod.EncoderConfig.tiny

        def tiny(real=real, **kw):
            return real(**{"hidden_dropout_prob": 0.0,
                           "attention_probs_dropout_prob": 0.0, **kw})

        monkeypatch.setattr(mod.EncoderConfig, "tiny", staticmethod(tiny))


def _train_argv(data_dir, out, task, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--replace_token_type_embeddings",
            "--do_train", "--task_name", task, "--hierarchical_version",
            "v0", "--data_dir", data_dir, "--max_seq_length", "64",
            "--per_seq_max_length", str(PER_SEQ),
            "--per_gpu_train_batch_size", "4", "--learning_rate", "1e-3",
            "--max_steps", "2", "--warmup_steps", "1", "--logging_steps",
            "1", "--save_steps", "0", "--gelu_impl", "erf", "--seed", "0",
            "--output_dir", str(out), "--overwrite_output_dir", *extra]


def _losses(out):
    with open(os.path.join(str(out), "logs", "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f)
                if r["tag"] == "train/loss"]


def _main_train_both(monkeypatch, data_dir, tmp_path, task, *extra):
    """The JAX package's `main_train`, then the port's from the same
    initial weights (the JAX init's, moved by `params_from_jax`)."""
    _no_dropout_tiny(monkeypatch)
    captured = {}
    real = jloop.make_train_state

    def capture(*a, **kw):
        captured["state"] = real(*a, **kw)
        return captured["state"]

    monkeypatch.setattr(jloop, "make_train_state", capture)
    # one device: the JAX loop's batch is per_gpu_train_batch_size times
    # the mesh's data axis
    monkeypatch.setattr(jloop, "make_mesh", lambda n_model=1: make_mesh(
        n_data=1, devices=jax.devices()[:1]))
    jstate = jcli.main_train(_train_argv(data_dir, tmp_path / "jax", task,
                                         *extra))
    targv = _train_argv(data_dir, tmp_path / "port", task, *extra)
    tc = tcli.build_config(tcli.parse_args("train", targv))[0]
    tc.num_labels = tcli.num_labels_of(task.split("_", 1)[1], N)
    sd = params_from_jax(_np(captured["state"].params), tc)
    monkeypatch.setattr(tloop, "init_weights",
                        lambda m, seed: (m.load_state_dict(sd), m)[1])
    res = tcli.main_train(targv + ["--device", "cpu"])
    return jstate, res, tc


@pytest.mark.parametrize("task", ["wikihow_pairwise", "wikihow_head",
                                  "wikihow_abductive", "wikihow_pure_class"])
def test_main_train_v0_tasks_match_jax(wikihow_dir, tmp_path, monkeypatch,
                                       task):
    # two steps (the first at learning rate 0) of each task from the same
    # weights on the same batches: both losses within 1e-5 relative, the
    # weights after the second update within 1e-5 (the attention key
    # biases, whose gradient is rounding, within two Adam steps of lr)
    jstate, res, tc = _main_train_both(monkeypatch, wikihow_dir, tmp_path,
                                       task)
    assert res.global_step == 2
    want = _losses(tmp_path / "jax")
    assert len(want) == 2
    np.testing.assert_allclose(_losses(tmp_path / "port"), want, rtol=1e-5)
    final = params_from_jax(_np(jstate.params), tc)
    for key, val in res.model.state_dict().items():
        atol = 2 * 1e-3 if key.endswith("key.bias") else 1e-5
        np.testing.assert_allclose(val.numpy(), final[key].numpy(), rtol=0,
                                   atol=atol, err_msg=key)
    ck = tmp_path / "port" / "checkpoint-2"
    saved = tcfg.MultimodalConfig.from_json((ck / "config.json").read_text())
    assert saved.hierarchical_version == "v0"
    assert saved.num_labels == ROLE_LABELS[task.split("_", 1)[1]]


def test_main_train_v0_head_mismatches_raise(wikihow_dir, tmp_path):
    argv = _train_argv(wikihow_dir, tmp_path / "a", "wikihow_pairwise",
                       "--device", "cpu")
    argv[argv.index("v0")] = "v1"  # a heat-map head on step pairs
    with pytest.raises(ValueError, match="does not train the v1 head"):
        tcli.main_train(argv)
    # the pure_decode task trains the encoder-decoder whatever the head
    # version flag (test_torch_pure_decode.py holds it to JAX)
    argv = _train_argv(wikihow_dir, tmp_path / "b", "wikihow_pure_decode",
                       "--device", "cpu")
    res = tcli.main_train(argv)
    assert res.global_step == 2
    assert type(res.model).__name__ == "EncoderIndexDecoder"


def _eval_argv(data_dir, out, method, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--task_name", "wikihow_sort", "--sort_method", method,
            "--data_dir", data_dir, "--eval_splits", "dev",
            "--max_seq_length", "64", "--per_seq_max_length", str(PER_SEQ),
            "--per_gpu_eval_batch_size", "2", "--seed", "0",
            "--output_dir", str(out), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def v0_checkpoints(wikihow_dir, tmp_path_factory):
    """A pairwise and a head checkpoint of the port's train CLI (tiny)."""
    root = tmp_path_factory.mktemp("v0_ckpts")
    out = {}
    for task in ("pairwise", "head"):
        argv = ["--model_name_or_path", "simple", "--model_size", "tiny",
                "--do_train", "--task_name", f"wikihow_{task}",
                "--hierarchical_version", "v0", "--data_dir", wikihow_dir,
                "--max_seq_length", "64", "--per_seq_max_length",
                str(PER_SEQ), "--per_gpu_train_batch_size", "4",
                "--max_steps", "2", "--save_steps", "0", "--seed", "0",
                "--output_dir", str(root / task), "--device", "cpu"]
        tcli.main_train(argv)
        out[task] = str(root / task / "checkpoint-2")
    return out


@pytest.mark.parametrize("method", sorted(METHOD_ROLES))
def test_eval_cli_baseline_methods(wikihow_dir, tmp_path, v0_checkpoints,
                                   method):
    # the roles by method: the trained pairwise and head checkpoints where
    # the method takes them, a fresh model (seeded 0) for the others
    roles = METHOD_ROLES[method]
    paths = [v0_checkpoints.get(r) for r in roles]
    flags = []
    for flag, path in zip(("--model_name_or_path_1", "--model_name_or_path_2",
                           "--model_name_or_path_3"), paths):
        if path:
            flags += [flag, path]
    out = tmp_path / "eval"
    res, evaluator = tcli.run_eval(_eval_argv(wikihow_dir, out, method,
                                              *flags))
    orders = [[int(x) for x in line.split()] for line in
              (out / "output_order.txt").read_text().splitlines()]
    assert len(orders) == 2 and all(sorted(o) == list(range(N))
                                    for o in orders)
    assert set(res["dev"]) >= {"partial_match", "exact_match", "tau"}
    assert evaluator.forwards > 0


def test_eval_cli_roles_refuse_other_heads(wikihow_dir, tmp_path,
                                           v0_checkpoints):
    # a head checkpoint (5 labels) as the pairwise role, and a v0
    # checkpoint as the heat map's, are refused
    with pytest.raises(ValueError, match="pairwise role"):
        tcli.main_eval(_eval_argv(wikihow_dir, tmp_path, "topological",
                                  "--model_name_or_path_1",
                                  v0_checkpoints["head"]))
    with pytest.raises(ValueError, match="heatmap role"):
        tcli.main_eval(_eval_argv(wikihow_dir, tmp_path, "heat_map",
                                  "--model_name_or_path_1",
                                  v0_checkpoints["pairwise"]))


def test_topological_device_decode_through_the_cli(wikihow_dir, tmp_path,
                                                   v0_checkpoints):
    # the decode on the evaluator's device (the CPU here; the orders are
    # held to the JAX package's device route in
    # test_evaluator_methods_match_jax)
    out = tmp_path / "device"
    res = tcli.main_eval(_eval_argv(
        wikihow_dir, out, "topological", "--model_name_or_path_1",
        v0_checkpoints["pairwise"], "--device_decode"))
    orders = [[int(x) for x in line.split()] for line in
              (out / "output_order.txt").read_text().splitlines()]
    assert len(orders) == 2 and all(sorted(o) == list(range(N))
                                    for o in orders)
    assert set(res["dev"]) >= {"partial_match", "tau"}
