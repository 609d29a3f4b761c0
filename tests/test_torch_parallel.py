"""The port's parallel layer (`parallel/`) against its single process and
the JAX package.

* The sharding plan against JAX `tree_shardings` (no ranks).
* Two gloo ranks of data parallelism (one spawn for every case) and four as
  2 data x 2 model with tensor + sequence parallelism + FSDP (one spawn),
  each case held against the same model trained in this process on the
  same global batches: the fine-tune sequencer with dropout 0.1 and a
  final partial batch, the CLIP-RN50 sequencer with its BatchNorm
  statistics, pretraining with the margin objective (pairs across ranks),
  and BERSON. Tolerances, f32: the first step's loss 1e-5 relative, its
  gradients 1e-5 of their global norm, the weights and BatchNorm
  statistics after it 1e-5 of their largest, the third step's loss 1e-4
  relative.
* At dropout 0 the data-parallel losses follow the JAX single-device step
  at the JAX parity test's own tolerance (2e-5 relative).
* A checkpoint of the 4-rank FSDP run evaluates in one process to the
  run's own eval output.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.parallel.mesh import make_mesh as j_make_mesh
from multimodal_sequencing_tpu.parallel.sharding_rules import tree_shardings
from multimodal_sequencing_tpu.train.state import (
    make_optimizer as j_make_optimizer, make_train_state)
from multimodal_sequencing_tpu.train.steps import (
    device_batch as j_device_batch, make_train_step)
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import (
    _LEAVES, params_from_jax)
from multimodal_sequencing_tpu_torch.models.sequencer import SequencingModel
from multimodal_sequencing_tpu_torch.ops.attention import keep_bits
from multimodal_sequencing_tpu_torch.parallel.sharding_rules import plan
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train.checkpoint import (
    restore_checkpoint)
from multimodal_sequencing_tpu_torch.train.loop import mask_batch
from multimodal_sequencing_tpu_torch.train.objectives import plan_objective
from multimodal_sequencing_tpu_torch.train.steps import device_batch

from torch_parallel_ranks import run_case, run_ranks

torch.set_num_threads(1)

MAX_LEN, PER_SEQ = 96, 12
N_IMG, SEQ, RES = 3, 48, 64
LR = 2e-3
# FSDP shards a tiny model's parameters of at least this many elements
# (JAX's default 65536 would leave every tiny parameter whole)
FSDP_MIN = 1024


def _args(kind, wikihow_dir, *extra):
    return tcli.parse_args(kind, [
        "--model_name_or_path", "simple", "--model_size", "tiny",
        "--replace_token_type_embeddings", "--data_dir", wikihow_dir,
        "--max_seq_length", str(MAX_LEN), "--per_seq_max_length",
        str(PER_SEQ), "--task_name", "wikihow_hl_v1",
        "--hierarchical_version", "v1", "--output_dir", "unused",
        "--device", "cpu", *extra])


def _dropout(cfg, p):
    cfg.encoder.hidden_dropout_prob = p
    cfg.encoder.attention_probs_dropout_prob = p
    return cfg


def _text_case(wikihow_dir, batch, p):
    args = _args("train", wikihow_dir)
    cfg, tok = tcli.build_config(args)
    ds = tcli.make_dataset(args, tok, "hl_v1", tcli.load_examples(
        args, "wikihow", "hl_v1", "train"), "v1")
    batches = [b for e in range(2) for b in tds.data_loader(
        ds, batch, shuffle=True, seed=0, epoch=e)][:3]
    # with 4 stories a batch, the second is the final partial batch
    assert batch != 4 or not batches[1]["valid"].all()
    return {"kind": "seq", "cfg": _dropout(cfg, p), "batches": batches}


def _clip_case(p):
    # computed in f64 (the parameters stay f32): the train-mode tower's
    # gradients are ill-conditioned in f32, up to 0.2 % of the global norm
    # off its f64 run (tests/test_torch_multimodal.py), far above any
    # difference the ranks' order of sums makes
    rng = np.random.RandomState(0)
    enc = tcfg.EncoderConfig.tiny(max_position_embeddings=200,
                                  type_vocab_size=N_IMG,
                                  hidden_dropout_prob=p,
                                  attention_probs_dropout_prob=p,
                                  dtype="float64")
    cfg = tcfg.MultimodalConfig(
        encoder=enc, hierarchical_version="v1", max_story_length=N_IMG,
        max_seq_length=SEQ, per_seq_max_length=12, multimodal=True,
        clip_model_name="RN50", image_size=(RES, RES))
    batches = []
    for _ in range(3):
        b = 4
        ids = rng.randint(5, 1000, (b, SEQ)).astype(np.int32)
        ids[:, ::SEQ // N_IMG] = 0
        am = np.ones((b, SEQ), np.int32)
        am[-1, SEQ - 9:] = 0
        batches.append({
            "input_ids": ids, "attention_mask": am,
            "token_type_ids": (np.arange(SEQ) // (SEQ // N_IMG)).clip(
                max=N_IMG - 1)[None].repeat(b, 0).astype(np.int32),
            "images": rng.randint(0, 256, (b, N_IMG, RES, RES, 3)).astype(
                np.uint8),
            "labels": np.stack([rng.permutation(N_IMG) for _ in range(b)]
                               ).astype(np.int32),
            "valid": np.array([True, True, True, False])})
    return {"kind": "seq", "cfg": cfg, "batches": batches,
            "vcfg": tcfg.CLIPVisionConfig.tiny_rn(image_resolution=RES,
                                                  dtype="float64")}


TEXT_OBJECTIVES = ("margin_loss", "time_contrastive", "swapping_based_nsp")
# the objectives over the folded visual stream: patches replaced by other
# stories' (donors on the other rank too), masked-patch regression, and
# whole images swapped on the host
PATCH_OBJECTIVES = ("patch_based_image_sequence_predictions",
                    "patch_based_mrm_classification", "image_swapping")


def _pretrain_case(wikihow_dir, p, objectives=TEXT_OBJECTIVES):
    """Pretraining batches of 4 stories, one objective each; the patch
    objectives over the tiny ViT tower at 32 px (its grid of 4)."""
    extra = (["--multimodal", "--clip_model_name", "ViT-B/32",
              "--vision_image_size", "32"]
             if objectives == PATCH_OBJECTIVES else [])
    args = _args("pretrain", wikihow_dir, *extra,
                 "--multimodal_pretrain_objectives", *objectives)
    args.task_type = "pretrain"
    cfg, tok = tcli.build_config(args)
    vcfg = tcli.vision_config(cfg, args)
    if vcfg is not None:
        cfg.patch_grid = vcfg.grid
    ds = tds.PretrainDataset(tcli.load_examples(args, "wikihow", "pretrain",
                                                "train"), tok,
                             **tcli.dataset_kwargs(args))
    rng = np.random.default_rng(0)
    batches = []
    for objective, batch in zip(objectives, [
            b for e in range(2) for b in tds.data_loader(
                ds, 4, shuffle=True, seed=0, epoch=e)]):
        nb = {k: np.asarray(batch[k]) for k in
              ("input_ids", "attention_mask", "token_type_ids", "images")
              if k in batch}
        nb["input_ids"], nb["mlm_labels"] = mask_batch(cfg, args, nb, rng)
        nb, aux = plan_objective(objective, nb, cfg, rng)
        batches.append((objective, nb, {
            k: v for k, v in aux.items()
            if isinstance(v, np.ndarray) and v.ndim > 0}))
    return {"kind": "pretrain", "cfg": _dropout(cfg, p), "batches": batches,
            "vcfg": vcfg}


def _berson_case(wikihow_dir, p, batch=2):
    args = _args("train", wikihow_dir, "--wrapper_model_type", "berson",
                 "--per_seq_max_length", "8", "--max_seq_length", "64")
    cfg, tok = tcli.build_config(args)
    ds = tds.BersonDataset(tcli.load_examples(args, "wikihow", "hl_v1",
                                              "train"), tok, scramble=True,
                           **tcli.dataset_kwargs(args))
    rng = np.random.default_rng(11)
    batches = []
    for b in list(tds.data_loader(ds, batch, shuffle=True, seed=0))[:3]:
        _, tc = plan_objective("time_contrastive",
                               {"input_ids": b["input_ids"][:, 0]}, cfg, rng)
        b.update(tc_anchor=tc["anchor_idx"], tc_positive=tc["positive_idx"],
                 tc_negative=tc["negative_idx"])
        batches.append(b)
    return {"kind": "berson", "cfg": _dropout(cfg, p), "batches": batches}


# ----- the sharding plan ----------------------------------------------------


def _jax_cfg(tc):
    """The JAX package's config with the same fields (the two dataclasses
    have the same fields and defaults)."""
    enc = jcfg.EncoderConfig(**dataclasses.asdict(tc.encoder))
    return jcfg.MultimodalConfig(**{
        f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)
        if f.name != "encoder"}, encoder=enc)


def _sharded_by_jax(params, n_data, n_model, fsdp):
    mesh = j_make_mesh(n_data, n_model)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            tree_shardings(params, mesh, fsdp=fsdp,
                           fsdp_min_elems=FSDP_MIN))[0]:
        names = [str(getattr(p, "key", p)) for p in path]
        axes = {a for a in sh.spec if a is not None}
        if axes:
            name = ".".join(names[:-1] + [_LEAVES[names[-1]]])
            out[name] = ("model" in axes, "data" in axes)
    return out


@functools.lru_cache(maxsize=None)
def _models(kind, wikihow_dir):
    """(the JAX model's params, the port's model) of the same config."""
    if kind == "text":
        case = _text_case(wikihow_dir, 2, 0.0)
        tc, batch, vcfg, jv = case["cfg"], case["batches"][0], None, None
    else:
        from multimodal_sequencing_tpu.models import clip_visual as jclip
        case = _clip_case(0.0)
        tc, batch = case["cfg"], case["batches"][0]
    if kind == "clip_rn":
        vcfg, jv = (tcfg.CLIPVisionConfig.tiny_rn(image_resolution=RES),
                    jclip.CLIPVisionConfig.tiny_rn(image_resolution=RES))
    elif kind == "clip_vit":
        vcfg, jv = (tcfg.CLIPVisionConfig.tiny_vit(),
                    jclip.CLIPVisionConfig.tiny_vit())
        tc = dataclasses.replace(tc, clip_model_name="ViT-B/32",
                                 image_size=(32, 32))
        batch = dict(batch, images=batch["images"][:, :, :32, :32])
    jb = j_device_batch(batch)
    # the parameters' shapes (all that the shardings read), traced only
    params = jax.eval_shape(lambda: JSequencingModel(_jax_cfg(tc), jv).init(
        jax.random.PRNGKey(0), jb["input_ids"], jb["attention_mask"],
        jb["token_type_ids"], images=jb.get("images")))["params"]
    return params, SequencingModel(tc, vcfg)


@pytest.mark.parametrize("layout", [(1, 2, False), (2, 2, True),
                                    (4, 2, True), (8, 1, True)])
@pytest.mark.parametrize("kind", ["text", "clip_rn", "clip_vit"])
def test_sharding_plan_matches_jax_tree_shardings(wikihow_dir, kind, layout):
    n_data, n_model, fsdp = layout
    params, model = _models(kind, wikihow_dir)
    want = _sharded_by_jax(params, n_data, n_model, fsdp)
    got = {n: (t is not None, f is not None) for n, (t, f) in plan(
        ((n, p.shape) for n, p in model.named_parameters()), n_data, n_model,
        fsdp, FSDP_MIN).items()}
    assert got == want
    assert any(t for t, _ in got.values()) == (n_model > 1)
    assert any(f for _, f in got.values()) == fsdp


@pytest.mark.parametrize("index", [(0, 0, 4), (3, 0, 4), (2, 2, 4),
                                   (5, 1, 3)])
def test_keep_bits_of_a_slice_are_the_global_ones(index):
    # a rank's (B, H) heads at (b_off, h_off) of h_tot draw the bits of the
    # same heads of the whole batch
    b_off, h_off, h_tot = index
    whole = keep_bits(123, b_off + 2, h_tot, 40, 0.1)
    part = keep_bits(123, 2, 2 if h_tot > 2 else 1, 40, 0.1, index=index)
    np.testing.assert_array_equal(
        part.numpy(), whole[b_off:b_off + 2, h_off:h_off + part.shape[1]])


# ----- the ranks ------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_cases(wikihow_dir, tmp_path_factory):
    """Every 2-rank data-parallel case, run once on two ranks (global
    batches of 4, or 2 BERSON stories) and in this process."""
    work = str(tmp_path_factory.mktemp("dp"))
    text = _text_case(wikihow_dir, 4, 0.0)
    # the JAX single-device step at dropout 0 from the JAX init
    jc = _jax_cfg(text["cfg"])
    kw = dict(learning_rate=LR, warmup_steps=1, total_steps=10,
              weight_decay=0.01, adam_epsilon=1e-8, max_grad_norm=1.0)
    state = make_train_state(JSequencingModel(jc), jax.random.PRNGKey(0),
                             j_device_batch(text["batches"][0]),
                             tx=j_make_optimizer(**kw))
    weights = os.path.join(work, "jax_init.pt")
    torch.save(params_from_jax(jax.tree.map(np.asarray, state.params),
                               text["cfg"]), weights)
    step_fn = make_train_step(jc, donate=False)
    jax_losses = []
    for batch in text["batches"]:
        state, metrics = step_fn(state, j_device_batch(batch),
                                 jax.random.PRNGKey(1))
        jax_losses.append(float(metrics["loss"]))
    cases = {"text_jax": dict(text, weights=weights, lr=LR),
             "text_dropout": _text_case(wikihow_dir, 4, 0.1),
             "clip_rn": _clip_case(0.1),
             "pretrain": _pretrain_case(wikihow_dir, 0.1),
             "pretrain_patch": _pretrain_case(wikihow_dir, 0.1,
                                              PATCH_OBJECTIVES),
             "berson": _berson_case(wikihow_dir, 0.1)}
    got = run_ranks(2, 1, cases, work)
    want = {name: run_case(spec) for name, spec in cases.items()}
    return got, want, jax_losses


@pytest.fixture(scope="module")
def tp_cases(wikihow_dir, tmp_path_factory):
    """4 ranks as 2 data x 2 model, tensor + sequence parallel + FSDP."""
    work = str(tmp_path_factory.mktemp("tp"))
    par = dict(sequence_parallel=True, fsdp=True, fsdp_min_elems=FSDP_MIN)
    text = _text_case(wikihow_dir, 4, 0.1)
    heat = dict(text["batches"][0])
    cases = {"text": dict(text, heatmap_batch=heat, **par),
             "berson": dict(_berson_case(wikihow_dir, 0.1), **par),
             "clip_rn": dict(_clip_case(0.1), **par)}
    got = run_ranks(4, 2, cases, work)
    ref = {name: dict(spec, workdir=str(tmp_path_factory.mktemp(name)))
           for name, spec in cases.items()}
    want = {name: run_case(spec) for name, spec in ref.items()}
    return got, want, cases


def _assert_matches(got, want):
    # the first step's loss, gradients and the weights after it
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    g_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                         for g in want["grads"].values()))
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=0,
                                   atol=1e-5 * g_norm, err_msg=name)
    largest = max(float(np.abs(w).max()) for w in want["weights"].values()
                  if w.dtype.kind == "f")
    assert set(got["weights"]) == set(want["weights"])
    for name, w in want["weights"].items():
        np.testing.assert_allclose(got["weights"][name], w, rtol=0,
                                   atol=1e-5 * largest, err_msg=name)
    # three steps on
    np.testing.assert_allclose(got["losses"][2], want["losses"][2],
                               rtol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-4)


@pytest.mark.parametrize("case", ["text_jax", "text_dropout", "clip_rn",
                                  "pretrain", "pretrain_patch", "berson"])
def test_data_parallel_matches_one_process(dp_cases, case):
    got, want, _ = dp_cases
    _assert_matches(got[case], want[case])


def test_data_parallel_follows_the_jax_step(dp_cases):
    got, _, jax_losses = dp_cases
    np.testing.assert_allclose(got["text_jax"]["losses"], jax_losses,
                               rtol=2e-5)


def test_data_parallel_batch_norm_statistics_are_global(dp_cases):
    got, want, _ = dp_cases
    stats = [k for k in want["clip_rn"]["weights"] if "running_" in k]
    assert stats
    init = SequencingModel(_clip_case(0.1)["cfg"],
                           tcfg.CLIPVisionConfig.tiny_rn(
                               image_resolution=RES)).state_dict()
    moved = 0
    for k in stats:
        np.testing.assert_allclose(got["clip_rn"]["weights"][k],
                                   want["clip_rn"]["weights"][k], rtol=0,
                                   atol=1e-5 * float(np.abs(
                                       want["clip_rn"]["weights"][k]).max()),
                                   err_msg=k)
        moved += not np.allclose(want["clip_rn"]["weights"][k],
                                 init[k].numpy())
    assert moved == len(stats)


@pytest.mark.parametrize("case", ["pretrain", "pretrain_patch"])
def test_pretraining_terms_are_global(dp_cases, case):
    got, want, _ = dp_cases
    assert len(want[case]["terms"]) == 3
    for g, w in zip(got[case]["terms"], want[case]["terms"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", ["text", "berson", "clip_rn"])
def test_tensor_sequence_fsdp_matches_one_process(tp_cases, case):
    got, want, _ = tp_cases
    _assert_matches(got[case], want[case])


def test_fsdp_checkpoint_resumes_on_its_layout(tp_cases):
    # the whole tensors loaded, each rank keeping its part (weights and
    # Adam moments bit-equal to the run's after the resume)
    got, want, cases = tp_cases
    for res in (got["text"], want["text"]):
        assert res["resumed_step"] == len(cases["text"]["batches"])
        assert res["resumed_weights_equal"]
        assert res["resumed_moments_equal"]


def test_fsdp_checkpoint_evaluates_in_one_process(tp_cases):
    got, want, cases = tp_cases
    spec = cases["text"]
    model = SequencingModel(spec["cfg"])
    step = restore_checkpoint(got["text"]["checkpoint"], model)
    assert step == len(spec["batches"])
    model.eval()
    db = device_batch(spec["heatmap_batch"], "cpu")
    with torch.no_grad():
        hm = model(db["input_ids"], db["attention_mask"],
                   db["token_type_ids"])["heatmap"].numpy()
    # the 4-rank forward sums over the model group in another order
    np.testing.assert_allclose(hm, got["text"]["heatmap"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hm, want["text"]["heatmap"], rtol=0,
                               atol=1e-5)
