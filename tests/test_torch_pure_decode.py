"""The port's pure_decode encoder-decoder against the JAX package's, on the
CPU: the teacher-forced decoder logits, the loss and token accuracy,
`prefix_logits` and the gradients on weights moved by `params_from_jax`;
the beam-5 `generate` token for token, with exact ties (the dead beams'
-1e9, a decoder whose logits all tie) and the bigram ban; the parameter
tree; `SortEvaluator`'s `pure_decode` against the JAX evaluator's (orders,
files, metrics; `nan` for the metrics that need permutations); and
`main_train` of the pure_decode task from the JAX init's weights against
the JAX package's run, then `run_eval --sort_method pure_decode` on its
checkpoint. Tiny configs, f32, dropout 0; logits, losses and gradients
within 1e-5 of their largest |value|, tokens exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models.pure_decode import (
    EncoderIndexDecoder as JEncoderIndexDecoder)
from multimodal_sequencing_tpu.train.steps import (
    compute_loss as j_compute_loss)
from multimodal_sequencing_tpu_torch.data import packing as tpack
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.models.convert import (
    params_from_jax, tree_to_state_dict)
from multimodal_sequencing_tpu_torch.train import cli as tcli
from multimodal_sequencing_tpu_torch.train.evaluation import (
    SortEvaluator as TSortEvaluator)
from multimodal_sequencing_tpu_torch.train.steps import compute_loss
from test_torch_aux_heads import _losses, main_train_both
from test_torch_pointer import (KEYS, MAX_LEN, N, PER_SEQ, SIMPLE_VOCAB,
                                assert_close, cfgs, eval_argv, evaluators,
                                grads_match, jax_forward, make_batch, models,
                                orders_of, port_batch, port_forward,
                                sort_loader)

torch.set_num_threads(1)

V = N + 2  # the index vocabulary: N steps, START, PAD


@pytest.mark.parametrize("seed", [0, 1])
def test_decoder_logits_loss_and_gradients_match_jax(seed):
    jc, tc, jm, variables, tm = models("decode", seed=seed)
    batch = make_batch(seed + 10)
    for labelled in (True, False):  # teacher forcing; START only (init)
        want = jax_forward(jm, variables, batch, labelled)["dec_logits"]
        with torch.no_grad():
            got = port_forward(tm, batch, labelled)["dec_logits"]
        assert got.shape == (4, N, V) and got.dtype == torch.float32
        assert_close(got, want, f"dec_logits {labelled}")
    jout = jax_forward(jm, variables, batch)
    want_loss, want = j_compute_loss(jc, jout, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
    got_loss, got = compute_loss(tc, port_forward(tm, batch),
                                 port_batch(batch))
    assert set(got) == set(want) == {"loss", "token_acc"}
    assert_close(got_loss, want_loss, "loss")
    assert float(got["token_acc"]) == float(want["token_acc"])
    grads_match(jc, tc, jm, variables, tm, batch)


def test_prefix_logits_match_jax():
    jc, tc, jm, variables, tm = models("decode", seed=2)
    batch = make_batch(3)
    rng = np.random.default_rng(0)
    for t in (1, 3, N + 1):
        prefix = rng.integers(0, V, (4, t)).astype(np.int32)
        prefix[:, 0] = N  # START
        want = jm.apply(variables, *(jnp.asarray(batch[k]) for k in KEYS),
                        jnp.asarray(prefix),
                        method=JEncoderIndexDecoder.prefix_logits)
        with torch.no_grad():
            got = tm.prefix_logits(*(torch.from_numpy(batch[k]).long()
                                     for k in KEYS),
                                   torch.from_numpy(prefix).long())
        assert_close(got, want, f"prefix {t}")


def _generate_both(jm, variables, tm, batch, **kw):
    want = np.asarray(jm.apply(variables, *(jnp.asarray(batch[k])
                                            for k in KEYS),
                               method=JEncoderIndexDecoder.generate, **kw))
    got = tm.generate(*(torch.from_numpy(batch[k]).long() for k in KEYS),
                      **kw).numpy()
    return got, want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("beams", [5, 2])
def test_generate_matches_jax(seed, beams):
    jc, tc, jm, variables, tm = models("decode", seed=seed)
    got, want = _generate_both(jm, variables, tm, make_batch(20 + seed),
                               num_beams=beams)
    assert got.shape == (4, N) and np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < V


@pytest.mark.parametrize("case", ["all_tie", "favour_0", "favour_pad",
                                  "no_ban"])
def test_generate_exact_ties_and_bigram_ban(case):
    # lm_head zeroed: every token of every step ties exactly, and the
    # stable sort must take the lower index first, as lax.top_k does;
    # a bias for one token makes it win until the bigram ban assigns -1e9
    # to its repeat (and with the ban off, it repeats)
    jc, tc, jm, variables, tm = models("decode", seed=5)
    params = jax.tree.map(np.copy, variables["params"])
    params["lm_head"]["kernel"][:] = 0.0
    params["lm_head"]["bias"][:] = 0.0
    if case in ("favour_0", "no_ban"):
        params["lm_head"]["bias"][0] = 5.0
    if case == "favour_pad":
        params["lm_head"]["bias"][N + 1] = 5.0
    tm.load_state_dict(params_from_jax(params, tc))
    kw = {"no_repeat_ngram_size": 0 if case == "no_ban" else 2}
    got, want = _generate_both(jm, {"params": params}, tm, make_batch(1),
                               **kw)
    assert np.array_equal(got, want)
    if case == "all_tie":  # worked by hand: lower indices, then the ban
        assert got[0].tolist() == [0, 0, 1, 0, 2]
    if case == "no_ban":
        assert got.tolist() == [[0] * N] * 4
    else:  # no bigram of [START] + tokens occurs twice
        for row in got.tolist():
            pairs = list(zip([N] + row, row))
            assert len(set(pairs)) == len(pairs), row


def test_decoder_tree_matches_jax_init():
    jc, tc, jm, variables, tm = models("decode")
    assert set(variables["params"]) == {
        "encoder", "tok_emb", "pos_emb", "self_attn", "ln1", "cross_attn",
        "ln2", "ffn_in", "ffn_out", "ln3", "lm_head"}
    assert sorted(tm.state_dict()) == sorted(tree_to_state_dict(
        variables["params"]))
    assert tm.pos_emb.shape == (N + 1, 64) and tm.start_id == N


def _force(variables, token, value=5.0):
    params = jax.tree.map(np.copy, variables["params"])
    params["lm_head"]["bias"][token] = value
    return {"params": params}


@pytest.mark.parametrize("forced", [None, N + 1])
def test_evaluator_pure_decode_matches_jax(wikihow_dir, tmp_path, forced):
    # the generated sequences, the output files and the metrics; with PAD
    # favoured no sequence is a permutation, so the metrics that need one
    # (ms, wms) are nan in both packages and the others are still reported
    jc, tc, jm, variables, tm = models("decode", seed=6, vocab=SIMPLE_VOCAB)
    if forced is not None:
        variables = _force(variables, forced)
        tm.load_state_dict(params_from_jax(variables["params"], tc))
    jev, tev = evaluators(jc, tc)
    want = jev.evaluate(sort_loader("jax", wikihow_dir), "pure_decode",
                        {"pure_decode": (jm, variables)},
                        output_dir=str(tmp_path / "jax"), data_split="train")
    got = tev.evaluate(sort_loader("port", wikihow_dir), "pure_decode",
                       {"pure_decode": tm}, output_dir=str(tmp_path / "port"),
                       data_split="train")
    assert set(got) == set(want)
    for k, v in want.items():
        assert (np.isnan(got[k]) and np.isnan(v)) or got[k] == v, k
    for name in ("output_order.txt", "all_predictions.csv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    if forced is not None:
        assert np.isnan(got["ms"]) and np.isnan(got["wms"])
        assert np.isfinite(got["partial_match"])
        assert all(sorted(o) != list(range(N))
                   for o in orders_of(tmp_path / "port"))
    assert tev.forwards == 2 and len(tev.decode_seconds) == 2
    assert all(d > 0 for d in tev.decode_seconds)


def test_metrics_that_raise_report_nan():
    # one prediction that is not a permutation through the port's evaluate:
    # the metrics that need permutations raise ValueError, reported nan
    class Fixed:  # a pure_decode stand-in with one fixed generation
        def encode(self, ids, am, tt):
            return ids, am

        def generate(self, _, enc=None):
            return torch.tensor([[0, 0, 1, 2, 3]]).expand(len(enc[0]), N)

    _, tc = cfgs("decode")
    tev = TSortEvaluator(tc, tpack.StoryPacker(ttok.load_tokenizer("simple"),
                                               MAX_LEN, PER_SEQ),
                         "cpu", micro_batch=4)
    loader = [{"texts": [["a b", "c d", "e f", "g h", "i j"]],
               "labels": [np.arange(N)], "guid": ["g0"]}]
    res = tev.evaluate(loader, "pure_decode", {"pure_decode": Fixed()})
    assert np.isnan(res["ms"]) and np.isnan(res["wms"])
    assert res["partial_match"] == pytest.approx(0.2)
    assert res["exact_match"] == 0.0


def test_main_train_pure_decode_matches_jax_then_evaluates(
        wikihow_dir, tmp_path, monkeypatch):
    # two steps from the JAX init's weights: both losses and token
    # accuracies within 1e-5 (the decoder has no dropout; the encoder's is
    # 0), the weights after them within 1e-5; then the port's eval CLI on
    # the checkpoint writes its outputs
    jstate, res, tc = main_train_both(monkeypatch, wikihow_dir, tmp_path,
                                      "wikihow_pure_decode", "v0")
    want = _losses(tmp_path / "jax")
    assert len(want) == 2 and res.global_step == 2
    np.testing.assert_allclose(_losses(tmp_path / "port"), want, rtol=1e-5)
    final = params_from_jax(jax.tree.map(np.asarray, jstate.params), tc)
    for key, val in res.model.state_dict().items():
        atol = 2 * 1e-3 if key.endswith("key.bias") else 1e-5
        np.testing.assert_allclose(val.numpy(), final[key].numpy(), rtol=0,
                                   atol=atol, err_msg=key)
    assert all(0.0 <= h["token_acc"] <= 1.0 for h in res.history)
    ckpt = tmp_path / "port" / "checkpoint-2"
    saved = json.loads((ckpt / "config.json").read_text())
    assert saved["hierarchical_version"] == "decode"
    out = tmp_path / "eval"
    results, ev = tcli.run_eval(eval_argv(wikihow_dir, out, "pure_decode",
                                          str(ckpt)))
    assert set(results["dev"]) >= {"partial_match", "exact_match", "tau"}
    tokens = orders_of(out)
    assert len(tokens) == 2 and all(len(t) == N for t in tokens)
    assert os.path.isfile(out / "eval_results_split_dev.txt")
    assert ev.forwards == 1
    # a pure_decode checkpoint in another role names its method
    with pytest.raises(ValueError, match="--sort_method pure_decode\\)"):
        tcli.run_eval(eval_argv(wikihow_dir, tmp_path / "hm", "heat_map",
                                str(ckpt)))
