"""The port's models against the JAX package's on the same weights: the
tiny `TextEncoder` and the whole tiny `SequencingModel` (v1/v2/v3), with
weights moved by `params_from_jax`, plus configs, GELU and LayerNorm."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.encoder import TextEncoder as JTextEncoder
from multimodal_sequencing_tpu.models.heads import (
    gather_step_cls as j_gather_step_cls)
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.ops.gelu import gelu as j_gelu
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
from multimodal_sequencing_tpu_torch.models.encoder import TextEncoder
from multimodal_sequencing_tpu_torch.models.heads import gather_step_cls
from multimodal_sequencing_tpu_torch.models.sequencer import (
    SequencingModel, init_weights)
from multimodal_sequencing_tpu_torch.ops.gelu import gelu

torch.set_num_threads(1)

ATOL = 1e-4  # f32 through 2 post-LN layers; sums run in another order
N_STEPS, SEQ = 5, 48


def _cfgs(version="v1", type_vocab_size=1, **mm):
    enc = dict(gelu_impl="erf", type_vocab_size=type_vocab_size)
    j = jcfg.MultimodalConfig(encoder=jcfg.EncoderConfig.tiny(**enc),
                              hierarchical_version=version,
                              max_story_length=N_STEPS, max_seq_length=SEQ,
                              **mm)
    t = tcfg.MultimodalConfig(encoder=tcfg.EncoderConfig.tiny(**enc),
                              hierarchical_version=version,
                              max_story_length=N_STEPS, max_seq_length=SEQ,
                              **mm)
    return j, t


def _batch(seed=0, steps=(5, 5, 3, 5), pad_to=SEQ):
    """Packed stories: each step is CLS + words + SEP, token type = step
    index, pad (id 1) after the last step; `steps` gives each story's step
    count, so a story may have fewer CLS than max_story_length."""
    rng = np.random.RandomState(seed)
    ids = np.ones((len(steps), pad_to), np.int32)
    types = np.zeros_like(ids)
    for b, n in enumerate(steps):
        pos = 0
        for s in range(n):
            length = rng.randint(4, 9)
            ids[b, pos] = 0
            ids[b, pos + 1:pos + length - 1] = rng.randint(5, 1000, length - 2)
            ids[b, pos + length - 1] = 2
            types[b, pos:pos + length] = s
            pos += length
    mask = (ids != 1).astype(np.int32)
    return ids, mask, types


def _jax_model(jc, seed, ids, mask, types):
    model = JSequencingModel(jc)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                           jnp.asarray(mask), jnp.asarray(types))
    out = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                      jnp.asarray(types))
    return jax.tree.map(np.asarray, variables), out


def _port_model(tc, variables):
    model = SequencingModel(tc)
    model.load_state_dict(params_from_jax(variables, tc))
    return model.eval()


def _run(model, ids, mask, types):
    with torch.inference_mode():
        return model(*(torch.from_numpy(x).long() for x in (ids, mask, types)))


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
@pytest.mark.parametrize("steps", [(5, 5, 5), (5, 3, 1, 4)])
def test_sequencing_model_matches_jax(version, steps):
    jc, tc = _cfgs(version, type_vocab_size=N_STEPS)
    ids, mask, types = _batch(seed=len(steps), steps=steps)
    variables, want = _jax_model(jc, 1, ids, mask, types)
    got = _run(_port_model(tc, variables), ids, mask, types)
    for key in ("heatmap", "step_reprs", "sequence_output", "pooled_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    np.testing.assert_array_equal(got["present"].numpy(),
                                  np.asarray(want["present"]))
    if version == "v3":
        assert got["heatmap"].min() < 0  # tanh range, not sigmoid
    assert not got["present"].all() or min(steps) == N_STEPS


@pytest.mark.parametrize("type_vocab_size", [1, N_STEPS])
@pytest.mark.parametrize("padded", [False, True])
def test_text_encoder_matches_jax(type_vocab_size, padded):
    # type_vocab_size 1: step indices 1..4 are clamped to the one row
    jc, tc = _cfgs(type_vocab_size=type_vocab_size)
    ids, mask, types = _batch(seed=3, steps=(5, 2, 4))
    if not padded:
        ids, mask, types = ids[:, :24], np.ones_like(mask[:, :24]), types[:, :24]
    variables, _ = _jax_model(jc, 2, ids, mask, types)
    enc_params = variables["params"]["encoder"]
    want_seq, want_pooled = JTextEncoder(jc.encoder).apply(
        {"params": enc_params}, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(types))
    state = params_from_jax(variables, tc)
    enc = TextEncoder(tc.encoder)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in state.items()
                         if k.startswith("encoder.")})
    with torch.inference_mode():
        seq, pooled = enc.eval()(*(torch.from_numpy(x).long()
                                   for x in (ids, mask, types)))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_step_cls_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 4, (3, 20)).astype(np.int32)  # many / few CLS (0)
    ids[-1] = 3                                         # a row with none
    hidden = rng.randn(3, 20, 8).astype(np.float32)
    want, want_present = j_gather_step_cls(jnp.asarray(hidden),
                                           jnp.asarray(ids), 0, N_STEPS)
    got, present = gather_step_cls(torch.from_numpy(hidden),
                                   torch.from_numpy(ids).long(), 0, N_STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(present.numpy(), np.asarray(want_present))


@pytest.mark.parametrize("impl", ["erf", "tanh"])
def test_gelu_matches_jax_f32(impl):
    x = np.linspace(-12, 12, 20001, dtype=np.float32)
    want = np.asarray(j_gelu(jnp.asarray(x), impl))
    got = gelu(torch.from_numpy(x), impl).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _bf16_order(x: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers ordered like the values they encode,
    so a difference of 1 is one ulp (also across zero)."""
    bits = x.view(np.int16).astype(np.int32) & 0xFFFF
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


@pytest.mark.parametrize("impl", ["logit_erf", "fast_erf"])
def test_gelu_erf_forms_within_one_bf16_ulp(impl):
    # The port runs the JAX package's erf forms as exact erf. In bf16 the
    # two agree to one ulp, except in the negative tail (x < -4): torch
    # forms 0.5*x*(1 + erf(x/sqrt 2)) in f32, so its absolute error there
    # is about |x| * 2^-25 (values below ~1e-7 become -0), while the JAX
    # forms keep relative accuracy (ROADMAP queue C records both gaps).
    x = np.linspace(-12, 12, 20001, dtype=np.float32)
    want = np.asarray(j_gelu(jnp.asarray(x, jnp.bfloat16), impl))
    got = gelu(torch.from_numpy(x).bfloat16(), impl)
    ulp = np.abs(_bf16_order(want)
                 - _bf16_order(got.view(torch.int16).numpy()))
    tail = np.abs(want.astype(np.float32) - got.float().numpy()) <= 1e-6
    assert np.all((ulp <= 1) | tail)


def test_gelu_logit_erf_f32_gap():
    # in f32 the JAX default, logit_erf, is an approximation fitted to bf16
    # resolution; the port's exact erf differs from it by up to this bound
    # on [-12, 12] (ROADMAP queue C)
    x = np.linspace(-12, 12, 200001, dtype=np.float32)
    want = np.asarray(j_gelu(jnp.asarray(x), "logit_erf"))
    got = gelu(torch.from_numpy(x), "logit_erf").numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_out_of_vocab_ids_raise_in_the_port():
    # the JAX encoder's embedding gather fills an id >= vocab_size with NaN
    # (the heat map then fails the decoder's range check); the port's
    # nn.Embedding raises at once (ROADMAP queue C)
    jc, tc = _cfgs()
    ids, mask, types = _batch(steps=(5,))
    variables, _ = _jax_model(jc, 0, ids, mask, types)
    ids[0, 1] = jc.encoder.vocab_size
    out = JSequencingModel(jc).apply(variables, jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(types))
    assert np.isnan(np.asarray(out["heatmap"])).any()
    with pytest.raises(IndexError):
        _run(_port_model(tc, variables), ids, mask, types)


@pytest.mark.parametrize("mean,atol", [(0.0, 1e-5), (3.0, 1e-3),
                                       (30.0, 1e-1)])
def test_layer_norm_gap_to_flax(mean, atol):
    # Flax computes var = E[x^2] - E[x]^2 (use_fast_variance), torch a
    # two-pass variance. Rows of std 0.1 around `mean`: at mean 0 the two
    # agree to f32 rounding; the fast form loses digits as mean/std grows
    # (ROADMAP queue C records these bounds)
    from flax import linen as nn
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 1024) * 0.1 + mean).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-5)
    params = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ln.apply(params, jnp.asarray(x)))
    got = torch.nn.LayerNorm(1024, eps=1e-5)(
        torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_config_json_round_trip(direction):
    jc, tc = _cfgs("v2", type_vocab_size=N_STEPS)
    if direction == "jax_to_port":
        back = tcfg.MultimodalConfig.from_json(jc.to_json())
        src = jc
    else:
        back = jcfg.MultimodalConfig.from_json(tc.to_json())
        src = tc
    assert json.loads(back.to_json()) == json.loads(src.to_json())
    assert dataclasses.asdict(back.encoder) == dataclasses.asdict(src.encoder)
    assert tc.encoder.compute_dtype == torch.float32
    assert tcfg.EncoderConfig().compute_dtype == torch.bfloat16


@pytest.mark.parametrize("fault", ["missing", "shape", "leaf"])
def test_params_from_jax_rejects_a_mismatched_tree(fault):
    jc, tc = _cfgs()
    ids, mask, types = _batch()
    variables, _ = _jax_model(jc, 0, ids, mask, types)
    params = jax.tree.map(lambda x: x, variables["params"])
    head = dict(params["heatmap_head"])
    if fault == "missing":
        head.pop("pair_out")
    elif fault == "shape":
        head["pair_out"] = {"kernel": np.zeros((3, 1), np.float32),
                            "bias": np.zeros((1,), np.float32)}
    else:
        head["pair_out"] = {"kernel_q": np.zeros((32, 1), np.float32)}
    params["heatmap_head"] = head
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(params, tc)


@pytest.mark.parametrize("change", [dict(hierarchical_version="v0"),
                                    dict(hierarchical_version="p1"),
                                    dict(multimodal=True),
                                    dict(hl_include_objectives=["head"])])
def test_later_slices_raise(change):
    _, tc = _cfgs()
    with pytest.raises(NotImplementedError):
        SequencingModel(dataclasses.replace(tc, **change))


def test_init_weights_is_seeded():
    _, tc = _cfgs()
    a = init_weights(SequencingModel(tc), 5).state_dict()
    b = init_weights(SequencingModel(tc), 5).state_dict()
    c = init_weights(SequencingModel(tc), 6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layer_0.attention.query.weight"],
                           c["encoder.layer_0.attention.query.weight"])
