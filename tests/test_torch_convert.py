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


# ----- CLIP visual weights ----------------------------------------------------


def _openai_rn_state_dict(cfg, seed):
    """A random state dict in OpenAI CLIP's ModifiedResNet layout (the
    `visual.*` keys of a CLIP checkpoint) at `cfg`'s widths, with a text
    tower key beside it."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape):
        sd[f"visual.{key}"] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))

    def bn(key, n):
        for leaf in ("weight", "bias", "running_mean"):
            put(f"{key}.{leaf}", n)
        sd[f"visual.{key}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2, n).astype(np.float32))
        sd[f"visual.{key}.num_batches_tracked"] = torch.tensor(7)

    w = cfg.width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2),
                                     (w // 2, w)), 1):
        put(f"conv{i}.weight", cout, cin, 3, 3)
        bn(f"bn{i}", cout)
    inplanes = w
    for stage, blocks in enumerate(cfg.layers):
        planes = w * 2 ** stage
        for b in range(blocks):
            p = f"layer{stage + 1}.{b}"
            put(f"{p}.conv1.weight", planes, inplanes, 1, 1)
            bn(f"{p}.bn1", planes)
            put(f"{p}.conv2.weight", planes, planes, 3, 3)
            bn(f"{p}.bn2", planes)
            put(f"{p}.conv3.weight", 4 * planes, planes, 1, 1)
            bn(f"{p}.bn3", 4 * planes)
            if b == 0:
                put(f"{p}.downsample.0.weight", 4 * planes, inplanes, 1, 1)
                bn(f"{p}.downsample.1", 4 * planes)
            inplanes = 4 * planes
    c = cfg.embed_dim
    put("attnpool.positional_embedding", cfg.grid ** 2 + 1, c)
    for proj, out in (("q_proj", c), ("k_proj", c), ("v_proj", c),
                      ("c_proj", cfg.output_dim)):
        put(f"attnpool.{proj}.weight", out, c)
        put(f"attnpool.{proj}.bias", out)
    sd["transformer.resblocks.0.ln_1.weight"] = torch.ones(4)
    return sd


def _openai_vit_state_dict(cfg, seed):
    rng = np.random.default_rng(seed)
    sd = {}
    w, p = cfg.vit_width, cfg.patch_size

    def put(key, *shape):
        sd[f"module.visual.{key}"] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))

    put("conv1.weight", w, 3, p, p)
    put("class_embedding", w)
    put("positional_embedding", cfg.grid ** 2 + 1, w)
    for ln in ("ln_pre", "ln_post"):
        put(f"{ln}.weight", w)
        put(f"{ln}.bias", w)
    put("proj", w, cfg.output_dim)
    for i in range(cfg.vit_layers):
        q = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            put(f"{q}.{ln}.weight", w)
            put(f"{q}.{ln}.bias", w)
        put(f"{q}.attn.in_proj_weight", 3 * w, w)
        put(f"{q}.attn.in_proj_bias", 3 * w)
        put(f"{q}.attn.out_proj.weight", w, w)
        put(f"{q}.attn.out_proj.bias", w)
        put(f"{q}.mlp.c_fc.weight", 4 * w, w)
        put(f"{q}.mlp.c_fc.bias", 4 * w)
        put(f"{q}.mlp.c_proj.weight", w, 4 * w)
        put(f"{q}.mlp.c_proj.bias", w)
    return sd


def _mm_cfgs(clip):
    from multimodal_sequencing_tpu.models.clip_visual import (
        CLIPVisionConfig as JV)
    kw = dict(hierarchical_version="v1", max_story_length=3, multimodal=True,
              clip_model_name=clip, max_seq_length=64)
    enc = dict(vocab_size=50265)  # the tiny HF model's (test_torch_train)
    jc = jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc), **kw)
    tc = tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc), **kw)
    if clip == "RN50":
        return jc, tc, JV.tiny_rn(), tcfg.CLIPVisionConfig.tiny_rn()
    return jc, tc, JV.tiny_vit(), tcfg.CLIPVisionConfig.tiny_vit()


@pytest.mark.parametrize("clip", ["RN50", "ViT-B/32"])
def test_clip_converters_match_jax(clip):
    # the port's conversion of OpenAI weights equals the JAX conversion
    # moved by params_from_jax's leaf rules, entry for entry, and loads
    # into the port's tower as it is
    from multimodal_sequencing_tpu_torch.models.clip_visual import (
        CLIPVisualTower)
    _, _, jv, tv = _mm_cfgs(clip)
    if clip == "RN50":
        raw = _openai_rn_state_dict(tv, 0)
        filtered = tconvert.filter_visual_state_dict(raw)
        jfilt = jconvert.filter_visual_state_dict(raw)
        conv = jconvert.convert_clip_rn50(jfilt, tv.layers)
        want = tconvert.tree_to_state_dict(conv["params"],
                                           conv["batch_stats"])
        got = tconvert.convert_clip_rn50(filtered, tv.layers)
    else:
        raw = _openai_vit_state_dict(tv, 1)
        filtered = tconvert.filter_visual_state_dict(raw)
        jfilt = jconvert.filter_visual_state_dict(raw)
        want = tconvert.tree_to_state_dict(jconvert.convert_clip_vit(jfilt))
        got = tconvert.convert_clip_vit(filtered)
    assert sorted(filtered) == sorted(jfilt)
    assert not any(k.startswith("transformer.") and "resblocks.0.ln_1" in k
                   and clip == "RN50" for k in filtered)
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
    tower = CLIPVisualTower(tv)
    tower.load_state_dict(got)  # strict: every weight and statistic


@pytest.mark.parametrize("clip", ["RN50", "ViT-B/32"])
def test_pretrained_weights_load_as_in_jax(tmp_path, clip):
    # a local HF text model and --clip_visual_model_weights (a file of
    # OpenAI weights) into the multimodal encoder: the result equals
    # params_from_jax of the JAX load_pretrained_weights, with the RN50
    # BatchNorm statistics merged as apply_pretrained_to_state merges them.
    # (The JAX loader converts RN50 files at RN50's published depth only,
    # so the tiny tower's file goes through its converter with the tiny
    # depth; the port's loader reads the depth from the tower.)
    import argparse
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel as TSequencingModel, init_weights)
    from multimodal_sequencing_tpu_torch.train.checkpoint import save_model
    from test_torch_train import _hf_state_dict
    jc, tc, jv, tv = _mm_cfgs(clip)
    hf = tmp_path / "hf"
    hf.mkdir()
    torch.save(_hf_state_dict("roberta."), hf / "pytorch_model.bin")
    weights = tmp_path / "clip.pt"
    raw = (_openai_rn_state_dict(tv, 2) if clip == "RN50"
           else _openai_vit_state_dict(tv, 3))
    torch.save(raw, weights)
    args = argparse.Namespace(model_name_or_path=str(hf),
                              clip_visual_model_weights=str(weights))
    ids = np.zeros((1, 64), np.int32)
    res = tv.image_resolution
    variables = jax.tree.map(np.asarray, jax.jit(JSequencingModel(jc, jv).init)(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        images=jnp.zeros((1, 3, 3, res, res), jnp.float32)))
    stats = variables.get("batch_stats")
    if clip == "RN50":
        loaded = jconvert.load_pretrained_weights(
            dict(variables["params"]), argparse.Namespace(
                model_name_or_path=str(hf), clip_visual_model_weights=None),
            jc)
        conv = jconvert.convert_clip_rn50(
            jconvert.filter_visual_state_dict(raw), tv.layers)
        loaded["encoder"] = {**loaded["encoder"],
                             "visual_model": conv["params"]}
        stats = {"encoder": {"visual_model": conv["batch_stats"]}}
    else:
        loaded = jconvert.load_pretrained_weights(
            dict(variables["params"]), args, jc)
    want = tconvert.params_from_jax(loaded, tc, stats, tv)
    model = init_weights(TSequencingModel(tc, tv), 0)
    assert tconvert.load_pretrained_weights(model, args)
    got = model.state_dict()
    keys = [k for k in got if k.startswith((
        "encoder.visual_model.", "encoder.layer_", "encoder.embeddings."))]
    assert len(keys) > 40
    for key in keys:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
    # a checkpoint of the port as --clip_visual_model_weights: its tower,
    # statistics included, into a fresh model, and nothing else
    save_model(model, tc, str(tmp_path / "ckpt"))
    fresh = init_weights(TSequencingModel(tc, tv), 1)
    assert tconvert.load_pretrained_weights(fresh, argparse.Namespace(
        model_name_or_path="simple",
        clip_visual_model_weights=str(tmp_path / "ckpt")))
    for key, val in fresh.state_dict().items():
        if key.startswith("encoder.visual_model."):
            assert torch.equal(val, got[key]), key
    assert not torch.equal(fresh.state_dict()[
        "encoder.layer_0.attention.query.weight"],
        got["encoder.layer_0.attention.query.weight"])
