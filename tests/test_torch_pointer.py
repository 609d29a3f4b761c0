"""The port's p0/p1 pointer heads against the JAX package's, on the CPU:
the pointer logits (teacher-forced by the order labels and greedy), the
pointer NLL, the greedy decode and the gradients of the whole sequencer on
weights moved by `params_from_jax`; the eval's pointer substitution of
`pure_decode` (the exhaustive permutation argmax) through `SortEvaluator`
against the JAX package's; and the train and eval CLIs with a pointer head.
Tiny configs, f32, dropout 0; logits, losses and gradients within 1e-5 of
their largest |value|, integer outputs exactly. The helpers here serve
`test_torch_aux_heads.py` and `test_torch_pure_decode.py` too."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import datasets as jds
from multimodal_sequencing_tpu.data import packing as jpack
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.data.registry import (
    get_processor as j_get_processor)
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.heads import (
    PointerHead as JPointerHead)
from multimodal_sequencing_tpu.models.pure_decode import (
    EncoderIndexDecoder as JEncoderIndexDecoder)
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.train.evaluation import (
    SortEvaluator as JSortEvaluator)
from multimodal_sequencing_tpu.train.steps import (
    compute_loss as j_compute_loss)
from multimodal_sequencing_tpu_torch.data import datasets as tds
from multimodal_sequencing_tpu_torch.data import packing as tpack
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.data.registry import (
    get_processor as t_get_processor)
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.models.heads import PointerHead
from multimodal_sequencing_tpu_torch.models.pure_decode import (
    EncoderIndexDecoder)
from multimodal_sequencing_tpu_torch.models.sequencer import SequencingModel
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train.evaluation import (
    SortEvaluator as TSortEvaluator)
from multimodal_sequencing_tpu_torch.train.steps import compute_loss

torch.set_num_threads(1)

N, MAX_LEN, PER_SEQ, VOCAB = 5, 60, 12, 1000
REL = 1e-5  # of the largest |value| of the JAX side
MASKED = -1e8  # below it a logit is one of the heads' -1e9 masks
KEYS = ("input_ids", "attention_mask", "token_type_ids")
SIMPLE_VOCAB = len(ttok.load_tokenizer("simple"))  # the evaluators' stories


def cfgs(version, objectives=(), vocab=VOCAB, **kw):
    """The JAX and the port's tiny f32 configs at dropout 0."""
    enc = dict(vocab_size=vocab, type_vocab_size=N, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, gelu_impl="erf")
    common = dict(hierarchical_version=version, max_story_length=N,
                  max_seq_length=MAX_LEN, per_seq_max_length=PER_SEQ,
                  hl_include_objectives=list(objectives), **kw)
    return (jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc),
                                  **common),
            tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc),
                                  **common))


def make_batch(seed, b=4):
    """Packed stories of 12 tokens a step, the third with 4 steps (a dead
    fifth step), the last padded; order labels (permutations), MLM labels
    and ITM targets."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, (b, MAX_LEN)).astype(np.int32)
    ids[:, ::MAX_LEN // N] = 0
    ids[2, 4 * MAX_LEN // N] = 7  # no fifth CLS
    am = np.ones((b, MAX_LEN), np.int32)
    am[-1, MAX_LEN - 9:] = 0
    ids[am == 0] = 1
    tt = (np.arange(MAX_LEN) // (MAX_LEN // N))[None].repeat(b, 0).astype(
        np.int32)
    return {"input_ids": ids, "attention_mask": am, "token_type_ids": tt,
            "labels": np.stack([rng.permutation(N) for _ in range(b)]
                               ).astype(np.int32),
            "mlm_labels": np.where(rng.random((b, MAX_LEN)) < 0.2,
                                   rng.integers(5, VOCAB, (b, MAX_LEN)),
                                   -100).astype(np.int32),
            "itm_targets": rng.integers(0, 2, b).astype(np.int32),
            "valid": np.arange(b) < b - 1}


def models(version, objectives=(), seed=0, vocab=VOCAB):
    """A JAX model of `version` ("decode": pure_decode), its variables (the
    JAX init's), and the port's on its weights."""
    jc, tc = cfgs(version, objectives, vocab)
    if version == "decode":
        jm, tm = JEncoderIndexDecoder(jc), EncoderIndexDecoder(tc)
    else:
        jm, tm = JSequencingModel(jc), SequencingModel(tc)
    ids = make_batch(0)["input_ids"][:1]
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.asarray(ids)))
    tm.load_state_dict(params_from_jax(variables["params"], tc))
    return jc, tc, jm, variables, tm.eval()


def jax_forward(jm, variables, batch, labelled=True, **kw):
    return jm.apply(variables, *(jnp.asarray(batch[k]) for k in KEYS),
                    order_labels=(jnp.asarray(batch["labels"]) if labelled
                                  else None), **kw)


def port_forward(tm, batch, labelled=True):
    return tm(*(torch.from_numpy(batch[k]).long() for k in KEYS),
              order_labels=(torch.from_numpy(batch["labels"]).long()
                            if labelled else None))


def port_batch(batch):
    return {k: torch.from_numpy(v).to(torch.bool if k == "valid"
                                      else torch.long)
            for k, v in batch.items()}


def assert_close(got, want, what=""):
    """Within 1e-5 of the largest |value| of `want` that is not one of the
    heads' -1e9 masks (dead or already pointed steps), which must sit at
    the same places in both."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    live = want > MASKED
    assert np.array_equal(got > MASKED, live), what
    np.testing.assert_allclose(
        got[live], want[live], rtol=0,
        atol=REL * max(np.abs(want[live]).max(initial=0.0), 1e-30),
        err_msg=what)


def grads_match(jc, tc, jm, variables, tm, batch):
    """The gradients of the task loss (deterministic forward) in both
    packages, every parameter within 1e-5 of the largest |gradient|."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out = jax_forward(jm, {"params": params}, batch)
        return j_compute_loss(jc, out, jb)[0]

    want = tree_to_state_dict(jax.tree.map(np.asarray, jax.grad(loss_fn)(
        variables["params"])))
    tm.zero_grad()
    compute_loss(tc, port_forward(tm, batch), port_batch(batch))[0].backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    top = max(np.abs(g.numpy()).max() for g in want.values())
    assert set(got) == set(want)
    for k, g in want.items():
        gg = torch.zeros_like(g) if got[k] is None else got[k]
        np.testing.assert_allclose(gg.numpy(), g.numpy(), rtol=0,
                                   atol=REL * top, err_msg=k)


# ----- the pointer heads ----------------------------------------------------


@pytest.mark.parametrize("version", ["p0", "p1"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pointer_logits_match_jax(version, seed):
    jc, tc, jm, variables, tm = models(version, seed=seed)
    batch = make_batch(seed + 3)
    assert not hasattr(tm, "heatmap_head")
    for labelled in (True, False):  # teacher-forced, then greedy
        want = jax_forward(jm, variables, batch, labelled)["pointer_logits"]
        with torch.inference_mode():
            got = port_forward(tm, batch, labelled)
        assert got["pointer_logits"].dtype == torch.float32
        assert_close(got["pointer_logits"], want, f"{version} {labelled}")
        assert np.array_equal(got["present"].numpy(),
                              np.asarray(jax_forward(
                                  jm, variables, batch)["present"]))


@pytest.mark.parametrize("version", ["p0", "p1"])
def test_pointer_loss_decode_and_gradients_match_jax(version):
    jc, tc, jm, variables, tm = models(version, seed=2)
    batch = make_batch(5)
    jout = jax_forward(jm, variables, batch)
    want, jm_ = j_compute_loss(jc, jout, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    got, tmets = compute_loss(tc, port_forward(tm, batch), port_batch(batch))
    assert_close(got, want, "loss")
    assert set(tmets) == set(jm_) == {"loss"}
    # the NLL alone, without `valid`: the dead fifth step of story 2
    # drops out of its mean
    present = np.array(jout["present"])
    assert not present[2, 4]
    logits = np.array(jout["pointer_logits"])
    assert_close(PointerHead.loss(torch.from_numpy(logits),
                                  torch.from_numpy(batch["labels"]).long(),
                                  torch.from_numpy(present)),
                 JPointerHead.loss(jnp.asarray(logits),
                                   jnp.asarray(batch["labels"]),
                                   jnp.asarray(present)), "nll")
    greedy = np.asarray(jax_forward(jm, variables, batch,
                                    False)["pointer_logits"])
    for lg in (logits, greedy, np.zeros_like(greedy)):  # zeros: all tie
        want = np.asarray(JPointerHead.decode(jnp.asarray(lg),
                                              jnp.asarray(present)))
        got = PointerHead.decode(torch.from_numpy(lg),
                                 torch.from_numpy(present)).numpy()
        assert np.array_equal(got, want)
        assert all(sorted(row) == list(range(N)) for row in got[:2])
    grads_match(jc, tc, jm, variables, tm, batch)


def test_pointer_tree_matches_jax_init():
    for version, sub in (("p0", {"pos_emb", "self_attn", "ln1", "xq", "xk",
                                 "xv", "ln2", "index_q"}),
                         ("p1", {"lstm_pointer"})):
        jc, tc, jm, variables, tm = models(version)
        assert set(variables["params"]["pointer_head"]) == sub
        assert set(variables["params"]) == {"encoder", "pointer_head"}
        assert sorted(tm.state_dict()) == sorted(tree_to_state_dict(
            variables["params"]))
    assert set(variables["params"]["pointer_head"]["lstm_pointer"]) == {
        "cell", "query_proj"}


# ----- the eval's pointer substitution --------------------------------------


def sort_loader(pkg, wikihow_dir, split="train", batch=4):
    """A `SortDataset` loader of `split` (6 train stories) of either
    package, with the simple tokenizer."""
    kw = dict(data_dir=wikihow_dir, min_story_length=N, max_story_length=N,
              paired_with_image=False)
    get, ds_mod, tok = ((j_get_processor, jds, jtok) if pkg == "jax"
                        else (t_get_processor, tds, ttok))
    examples = getattr(get("wikihow_sort", **kw), f"get_{split}_examples")()
    return ds_mod.data_loader(ds_mod.SortDataset(
        examples, tok.load_tokenizer("simple"), max_length=MAX_LEN,
        per_seq_max_length=PER_SEQ, max_story_length=N, seed=0), batch)


def evaluators(jc, tc, micro_batch=8):
    packer = (jpack.StoryPacker(jtok.load_tokenizer("simple"), MAX_LEN,
                                PER_SEQ),
              tpack.StoryPacker(ttok.load_tokenizer("simple"), MAX_LEN,
                                PER_SEQ))
    return (JSortEvaluator(jc, packer[0], micro_batch=micro_batch),
            TSortEvaluator(tc, packer[1], "cpu", micro_batch=micro_batch))


@pytest.mark.parametrize("version", ["p0", "p1"])
def test_pointer_substitution_matches_jax(wikihow_dir, tmp_path, version):
    jc, tc, jm, variables, tm = models(version, seed=4, vocab=SIMPLE_VOCAB)
    jev, tev = evaluators(jc, tc)
    want = jev.evaluate(sort_loader("jax", wikihow_dir), "pure_decode",
                        {"pointer": (jm, variables)},
                        output_dir=str(tmp_path / "jax"), data_split="train")
    got = tev.evaluate(sort_loader("port", wikihow_dir), "pure_decode",
                       {"pointer": tm}, output_dir=str(tmp_path / "port"),
                       data_split="train")
    assert got == want
    for name in ("output_order.txt", "all_predictions.csv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert tev.forwards == 2 and len(tev.decode_seconds) == 2


def test_pointer_argmax_matches_jax_on_ties():
    # the exhaustive argmax over n! orders: equal logits tie every order,
    # and the first in lexicographic order wins in both packages
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, N, N)).astype(np.float32)
    logits[0] = 0.0
    logits[1, :, :2] = 3.0  # two steps tie everywhere
    got = TSortEvaluator.pointer_argmax(logits)
    assert got[0] == list(range(N))

    class Fixed:  # a stand-in for the JAX evaluator's story forward
        def story_logits(self, *a, **kw):
            return logits
    fixed = Fixed()
    fixed.cfg = jcfg.MultimodalConfig(max_story_length=N)
    want = JSortEvaluator._decode_batch(fixed, "pure_decode",
                                        {"pointer": (None, None)},
                                        [["x"] * N] * 6, None)
    assert got == want


# ----- the CLIs ---------------------------------------------------------------


def train_argv(data_dir, out, task, version, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "tiny",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", task, "--hierarchical_version", version,
            "--data_dir", data_dir, "--max_seq_length", "64",
            "--per_seq_max_length", str(PER_SEQ),
            "--per_gpu_train_batch_size", "4", "--learning_rate", "1e-3",
            "--max_steps", "2", "--warmup_steps", "1", "--logging_steps",
            "1", "--save_steps", "0", "--eval_splits", "dev",
            "--per_gpu_eval_batch_size", "2", "--seed", "0",
            "--output_dir", str(out), "--overwrite_output_dir",
            "--device", "cpu", *extra]


def eval_argv(data_dir, out, method, model, *extra):
    return ["--model_name_or_path", model, "--model_size", "tiny",
            "--task_name", "wikihow_sort", "--sort_method", method,
            "--data_dir", data_dir, "--eval_splits", "dev",
            "--max_seq_length", "64", "--per_seq_max_length", str(PER_SEQ),
            "--per_gpu_eval_batch_size", "2", "--seed", "0",
            "--output_dir", str(out), "--device", "cpu", *extra]


def orders_of(out):
    with open(os.path.join(str(out), "output_order.txt")) as f:
        return [[int(x) for x in line.split()] for line in f]


@pytest.fixture(scope="module")
def pointer_checkpoints(wikihow_dir, tmp_path_factory):
    """A p0 and a p1 run of the port's train CLI (tiny, 2 steps, with
    `--do_eval`), by version: (result, checkpoint directory)."""
    out = {}
    for version in ("p0", "p1"):
        run = tmp_path_factory.mktemp(f"train_{version}")
        res = tcli.main_train(train_argv(wikihow_dir, run, "wikihow_hl_v1",
                                         version, "--do_eval"))
        out[version] = (res, str(run / "checkpoint-2"))
    return out


@pytest.mark.parametrize("version", ["p0", "p1"])
def test_train_cli_pointer_head(pointer_checkpoints, version):
    res, ckpt = pointer_checkpoints[version]
    assert res.global_step == 2 and len(res.history) == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    saved = tcfg.MultimodalConfig.from_json(
        open(os.path.join(ckpt, "config.json")).read())
    assert saved.hierarchical_version == version
    assert isinstance(res.model.pointer_head, PointerHead)
    # --do_eval: the pointer substitution of pure_decode on checkpoint-2
    (name, metrics), = res.eval_results.items()
    assert name == "checkpoint-2"
    assert 0.0 <= metrics["partial_match"] <= 1.0


@pytest.mark.parametrize("version", ["p0", "p1"])
def test_eval_cli_pointer_role(wikihow_dir, tmp_path, pointer_checkpoints,
                               version):
    _, ckpt = pointer_checkpoints[version]
    res, ev = tcli.run_eval(eval_argv(wikihow_dir, tmp_path, "pure_decode",
                                      ckpt, "--hierarchical_version",
                                      version))
    assert set(res["dev"]) >= {"partial_match", "exact_match", "tau"}
    orders = orders_of(tmp_path)
    assert len(orders) == 2 and all(sorted(o) == list(range(N))
                                    for o in orders)
    assert ev.forwards == 1
    # the same checkpoint in the pure_decode role, or as a heat map, is
    # refused with the method that evaluates it
    for method, extra in (("pure_decode", ()), ("heat_map", ())):
        with pytest.raises(ValueError, match=f"--sort_method pure_decode "
                                             f"--hierarchical_version "
                                             f"{version}"):
            tcli.run_eval(eval_argv(wikihow_dir, tmp_path / method, method,
                                    ckpt, *extra))
