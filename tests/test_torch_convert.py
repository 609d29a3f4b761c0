"""HF text weights and tokenizers in the port against the JAX package:
`strip_prefixes`, `resize_token_type_embeddings`, `convert_hf_text_encoder`
(equal to the JAX conversion moved by `params_from_jax`, and a forward that
matches the HF model's at the JAX package's tolerances, atol 3e-4 and
rtol 1e-3 as in `tests/test_convert.py`), `load_torch_state_dict`, and an HF
tokenizer directory (a tiny byte-level BPE trained here and saved as a
`RobertaTokenizerFast`) that gives the same ids and packs in both packages.
Tiny HF models are built from `transformers` configs with random weights;
nothing is downloaded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.data import packing as jpack
from multimodal_sequencing_tpu.data import tokenization as jtok
from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models import convert as jconvert
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu_torch.data import packing as tpack
from multimodal_sequencing_tpu_torch.data import tokenization as ttok
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models import convert as tconvert
from multimodal_sequencing_tpu_torch.models.encoder import TextEncoder

torch.set_num_threads(1)

SPECIAL = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]  # ids 0..4, RoBERTa's
CORPUS = [
    "Gather all the tools you need. Make sure the workbench is clean.",
    "Measure the plank twice before cutting. Use a sharp pencil to mark.",
    "Cut along the marked line slowly. Keep your fingers clear of the blade.",
    "Sand the edges until they are smooth. Wipe away the dust with a cloth.",
    "Apply the first coat of paint evenly. Let it dry for two hours.",
    "Attach the hinges with the provided screws. Tighten them firmly.",
]


def write_bpe_tokenizer(path) -> str:
    """A byte-level BPE of ~400 tokens trained on CORPUS, saved as an HF
    `RobertaTokenizerFast` directory; returns the directory."""
    from tokenizers import ByteLevelBPETokenizer
    from transformers import RobertaTokenizerFast
    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(CORPUS * 4, vocab_size=400, min_frequency=1,
                            special_tokens=SPECIAL, show_progress=False)
    tok = RobertaTokenizerFast(tokenizer_object=bpe._tokenizer,
                               bos_token="<s>", eos_token="</s>",
                               sep_token="</s>", cls_token="<s>",
                               unk_token="<unk>", pad_token="<pad>",
                               mask_token="<mask>")
    tok.save_pretrained(str(path))
    return str(path)


def _hf_model(kind, seed):
    """A tiny HF BertModel or RobertaModel with random weights, and the
    encoder config that reads it."""
    from transformers import BertConfig, BertModel, RobertaConfig, RobertaModel
    common = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    if kind == "bert":
        hf = BertModel(BertConfig(vocab_size=200, max_position_embeddings=64,
                                  type_vocab_size=2, **common))
        enc = dict(vocab_size=200, max_position_embeddings=64,
                   type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0,
                   position_offset=0)
    else:
        hf = RobertaModel(RobertaConfig(vocab_size=300,
                                        max_position_embeddings=70,
                                        type_vocab_size=1, pad_token_id=1,
                                        **common))
        enc = dict(vocab_size=300, max_position_embeddings=70,
                   type_vocab_size=1, layer_norm_eps=1e-12, pad_token_id=1,
                   position_offset=2)
    enc.update(common, dtype="float32")
    return hf.eval(), enc


def _prefixed(sd, prefix):
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("sd", [
    {"roberta.embeddings.word_embeddings.weight": 1, "bert.pooler.x": 2,
     "plain": 3},
    {"module.roberta.a": 1, "bert.bert.b": 2, "lm_head.c": 3},
    {"roberta.": 1, "robertab": 2}])
def test_strip_prefixes_matches_jax(sd):
    assert tconvert.strip_prefixes(sd) == jconvert.strip_prefixes(sd)
    prefixes = ("lm_head.", "module.")
    assert (tconvert.strip_prefixes(sd, prefixes)
            == jconvert.strip_prefixes(sd, prefixes))


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("new_size", [1, 3, 5])
def test_resize_token_type_embeddings_matches_jax(rows, new_size):
    table = np.random.default_rng(rows).normal(size=(rows, 4)).astype(
        np.float32)
    want = jconvert.resize_token_type_embeddings(
        {"embeddings": {"token_type_embeddings": {"embedding": table}}},
        new_size)["embeddings"]["token_type_embeddings"]["embedding"]
    key = "embeddings.token_type_embeddings.weight"
    sd = {key: torch.from_numpy(table), "other": torch.zeros(1)}
    got = tconvert.resize_token_type_embeddings(sd, new_size)
    np.testing.assert_array_equal(got[key].numpy(), want)
    assert got["other"] is sd["other"] and sd[key].shape == (rows, 4)
    # a state dict without the table, as the JAX tree without it
    assert tconvert.resize_token_type_embeddings({"other": 1}, 5) == {
        "other": 1}


@pytest.mark.parametrize("prefix", ["", "roberta.", "bert."])
@pytest.mark.parametrize("kind", ["bert", "roberta"])
def test_convert_hf_text_encoder_matches_jax(kind, prefix):
    hf, enc = _hf_model(kind, seed=len(kind) + len(prefix))
    sd = _prefixed(hf.state_dict(), prefix)
    got = tconvert.convert_hf_text_encoder(sd, enc["num_hidden_layers"])
    # the JAX conversion in Flax's layout, moved into the port's keys by
    # params_from_jax inside a whole sequencer tree
    jc = jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig(**enc),
                               hierarchical_version="v1", max_seq_length=16)
    tc = tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig(**enc),
                               hierarchical_version="v1", max_seq_length=16)
    ids = np.zeros((1, 16), np.int32)
    params = jax.tree.map(np.asarray, JSequencingModel(jc).init(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    params = dict(params, encoder=jconvert.convert_hf_text_encoder(
        {k: v.numpy() for k, v in sd.items()}, enc["num_hidden_layers"]))
    from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
    want = {k[len("encoder."):]: v for k, v in
            params_from_jax(params, tc).items() if k.startswith("encoder.")}
    assert sorted(got) == sorted(want)
    for key in got:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)

    # the port's encoder on these weights against the HF forward
    model = TextEncoder(tcfg.EncoderConfig(**enc)).eval()
    model.load_state_dict(got)
    rng = np.random.RandomState(2)
    s = 16
    ids = rng.randint(3, enc["vocab_size"], (2, s))
    mask = np.ones((2, s), np.int64)
    types = (rng.randint(0, 2, (2, s)) if kind == "bert"
             else np.zeros((2, s), np.int64))
    if kind == "bert":  # the HF BERT takes pad-masked keys as the port
        mask[:, 12:] = 0
    with torch.no_grad():
        out = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
                 token_type_ids=torch.tensor(types))
        seq, pooled = model(torch.tensor(ids), torch.tensor(mask),
                            torch.tensor(types))
    keep = 12 if kind == "bert" else s
    np.testing.assert_allclose(seq.numpy()[:, :keep],
                               out.last_hidden_state.numpy()[:, :keep],
                               atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                               atol=3e-4, rtol=1e-3)


def test_convert_keeps_the_file_s_optional_tables():
    hf, enc = _hf_model("roberta", seed=3)
    sd = {k: v for k, v in hf.state_dict().items()
          if not k.startswith(("pooler.", "embeddings.token_type"))}
    got = tconvert.convert_hf_text_encoder(sd, 2)
    want = jconvert.convert_hf_text_encoder(sd, 2)
    assert not any(k.startswith("pooler") for k in got) and "pooler" not in want
    assert "token_type_embeddings" not in want["embeddings"]
    assert "embeddings.token_type_embeddings.weight" not in got
    del sd["encoder.layer.1.output.dense.bias"]
    for convert in (tconvert.convert_hf_text_encoder,
                    jconvert.convert_hf_text_encoder):
        with pytest.raises(KeyError):
            convert(sd, 2)


@pytest.mark.parametrize("layout", ["flat", "under_state_dict"])
def test_load_torch_state_dict_matches_jax(tmp_path, layout):
    hf, _ = _hf_model("bert", seed=4)
    sd = hf.state_dict()
    path = tmp_path / "pytorch_model.bin"
    torch.save(sd if layout == "flat" else {"state_dict": sd}, path)
    got = tconvert.load_torch_state_dict(str(path))
    want = jconvert.load_torch_state_dict(str(path))
    assert sorted(got) == sorted(want) == sorted(sd)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), want[key])


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    return write_bpe_tokenizer(tmp_path_factory.mktemp("bpe"))


def test_hf_tokenizer_ids_match_jax(bpe_dir):
    jt, tt = jtok.load_tokenizer(bpe_dir), ttok.load_tokenizer(bpe_dir)
    assert type(tt).__name__ == "RobertaTokenizerFast"
    assert (tt.cls_token_id, tt.pad_token_id, tt.sep_token_id,
            tt.mask_token_id) == (0, 1, 2, 4) == (
        jt.cls_token_id, jt.pad_token_id, jt.sep_token_id, jt.mask_token_id)
    assert len(tt) == len(jt)
    texts = CORPUS + ["An unseen sentence, with ünïcode and 123 digits."]
    for kw in (dict(), dict(max_length=12, padding="max_length",
                            truncation=True)):
        assert tt(texts, **kw)["input_ids"] == jt(texts, **kw)["input_ids"]


@pytest.mark.parametrize("max_len,per_seq", [(96, 12), (48, 12), (320, 60)])
def test_hf_tokenizer_packs_match_jax(bpe_dir, max_len, per_seq):
    jp = jpack.StoryPacker(jtok.load_tokenizer(bpe_dir), max_len, per_seq)
    tp = tpack.StoryPacker(ttok.load_tokenizer(bpe_dir), max_len, per_seq)
    for k in range(len(CORPUS) - 2):
        story = CORPUS[k:k + 3] + CORPUS[:k]
        for got, want in zip(tp.pack_story(story), jp.pack_story(story)):
            np.testing.assert_array_equal(got, want)


def test_missing_tokenizer_raises_oserror_in_both(tmp_path):
    for load in (jtok.load_tokenizer, ttok.load_tokenizer):
        with pytest.raises(OSError, match="not available locally"):
            load(str(tmp_path / "no_such_tokenizer"))
