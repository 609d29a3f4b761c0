"""The port's models against the JAX package's on the same weights: the
tiny `TextEncoder` and the whole tiny `SequencingModel` (v1/v2/v3), with
weights moved by `params_from_jax`, plus configs, GELU, LayerNorm and the
fresh init."""

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
from multimodal_sequencing_tpu_torch.models.encoder import LayerNorm
from multimodal_sequencing_tpu_torch.ops import layer_norm as tln
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


def _j_gelu_and_grad(x, impl):
    want = j_gelu(x, impl)
    grad = jax.grad(lambda v: jnp.sum(j_gelu(v, impl).astype(jnp.float32)))(x)
    return np.asarray(want), np.asarray(grad)


def _port_gelu_and_grad(x, impl):
    t = x.clone().requires_grad_()
    y = gelu(t, impl)
    y.float().sum().backward()
    return y.detach(), t.grad


@pytest.mark.parametrize("impl", ["logit_erf", "fast_erf"])
def test_gelu_erf_forms_within_one_bf16_ulp(impl):
    # The port computes the JAX package's erf forms with the same formulas,
    # custom backwards and denormal flush. In bf16, forward and gradient
    # agree to one ulp; only values below 1e-30, where XLA also flushes the
    # f32 intermediates to zero, may differ (by less than 1e-30).
    x = np.linspace(-20, 20, 40001, dtype=np.float32)
    want, want_g = _j_gelu_and_grad(jnp.asarray(x, jnp.bfloat16), impl)
    got, got_g = _port_gelu_and_grad(torch.from_numpy(x).bfloat16(), impl)
    for w, g in ((want, got), (want_g, got_g)):
        ulp = np.abs(_bf16_order(w) - _bf16_order(g.view(torch.int16).numpy()))
        tiny = np.abs(w.astype(np.float32) - g.float().numpy()) < 1e-30
        assert np.all((ulp <= 1) | tiny)


def test_gelu_logit_erf_f32_gap():
    # The JAX default, logit_erf, in f32 on [-20, 20]: the forward agrees
    # within 1e-6; the gradient within 2e-6, since XLA's exp and its fused
    # multiply-adds round sigma and u' an ulp away from the port's, and
    # x sigma (1 - sigma) u' scales that by up to ~10 near |x| ~ 3.
    x = np.linspace(-20, 20, 200001, dtype=np.float32)
    want, want_g = _j_gelu_and_grad(jnp.asarray(x), "logit_erf")
    got, got_g = _port_gelu_and_grad(torch.from_numpy(x), "logit_erf")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=2e-6, rtol=0)


def test_out_of_vocab_ids_raise_in_the_port():
    # a deliberate difference (ROADMAP): the JAX encoder's embedding gather
    # fills an id >= vocab_size with NaN (the heat map then fails the
    # decoder's range check); the port's embedding raises at once
    jc, tc = _cfgs()
    ids, mask, types = _batch(steps=(5,))
    variables, _ = _jax_model(jc, 0, ids, mask, types)
    ids[0, 1] = jc.encoder.vocab_size
    out = JSequencingModel(jc).apply(variables, jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(types))
    assert np.isnan(np.asarray(out["heatmap"])).any()
    with pytest.raises(IndexError):
        _run(_port_model(tc, variables), ids, mask, types)


@pytest.mark.parametrize("mean", [0.0, 3.0, 30.0])
def test_layer_norm_gap_to_flax(mean):
    # The port's LayerNorm computes Flax's form: f32 E[x^2] - E[x]^2
    # clamped at 0, output in the compute dtype. Rows of std 0.1 around
    # `mean`. Both sum E[x^2] in f32 in their own order, and the fast form
    # turns a few ulps of that sum into a variance error of
    # ulps * 2^-24 * E[x^2] / var; 16 ulps bound it here. At mean 0 (the
    # encoder's residual sums) f32 agrees to 1e-6 and bf16 exactly; at
    # means 3 and 30, rows whose sums no order can change tell the fast
    # form from the two-pass one.
    from flax import linen as nn
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 1024) * 0.1 + mean).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-5)
    params = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax.jit(ln.apply)(params, jnp.asarray(x)))
    got = LayerNorm(1024, 1e-5)(torch.from_numpy(x)).detach().numpy()
    ratio = float(np.mean(x.astype(np.float64) ** 2) / np.var(x))
    atol = 1e-6 + 16 * 2.0 ** -24 * ratio * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if mean != 0.0:
        # Rows whose sums are exact in f32 in any order: values on a grid of
        # 2^(floor(log2 mean) - 6), so |x| < 128 grid units, x^2 < 2^14 and
        # 1024 of them < 2^24. Then mean and E[x^2] are the same on both
        # sides, the fast form differs from the true variance only by the
        # rounding of mean^2, and the port must agree with Flax to 2 f32
        # ulps of |y| <= 8, while the two-pass form (torch's layer_norm)
        # misses by far more.
        unit = 2.0 ** (np.floor(np.log2(mean)) - 6)
        x = (np.round(x / unit) * unit).astype(np.float32)
        want = np.asarray(jax.jit(ln.apply)(params, jnp.asarray(x)))
        got = LayerNorm(1024, 1e-5)(torch.from_numpy(x)).detach().numpy()
        two_pass = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (1024,), eps=1e-5).numpy()
        tol = 1e-6
        assert np.abs(got - want).max() <= tol
        assert np.abs(two_pass - want).max() > 20 * tol
    else:
        assert np.abs(got - want).max() <= 1e-6
        want_bf16 = jax.jit(nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
                            .apply)(params, jnp.asarray(x, jnp.bfloat16))
        got_bf16 = LayerNorm(1024, 1e-5, torch.bfloat16)(
            torch.from_numpy(x).bfloat16())
        np.testing.assert_array_equal(got_bf16.detach().float().numpy(),
                                      np.asarray(want_bf16, np.float32))


@pytest.mark.parametrize("mean", [0.0, 3.0])
def test_layer_norm_backward_matches_flax_grad(mean):
    # The plain backward (autograd of `layer_norm_reference`: dx, dw, db),
    # which the card's one-launch kernel is held to, against jax.grad of
    # Flax's LayerNorm on the same numpy rows, scale, bias and output
    # gradient. Both are f32 with sums in their own order: |err| <= 2e-6
    # of the largest entry plus, for dx and dw, the fast variance's
    # rounding (16 ulps of E[x^2] over var, as in
    # test_layer_norm_gap_to_flax) of their largest entry.
    from flax import linen as nn
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 1024) * 0.5 + mean).astype(np.float32)
    dy = rng.randn(64, 1024).astype(np.float32)
    w = (1 + 0.1 * rng.randn(1024)).astype(np.float32)
    b = (0.1 * rng.randn(1024)).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-5)

    def loss(x, w, b):
        y = ln.apply({"params": {"scale": w, "bias": b}}, x)
        return jnp.sum(y * jnp.asarray(dy))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (x, w, b)))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = tln.layer_norm_reference(xt, wt, bt, 1e-5, torch.float32)
    got = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(dy))
    ratio = float(np.mean(x.astype(np.float64) ** 2) / np.var(x))
    for name, g, w_ in zip(("dx", "dw", "db"), got, want):
        w_ = np.asarray(w_)
        var_err = 0.0 if name == "db" else 16 * 2.0 ** -24 * ratio
        atol = (2e-6 + var_err) * np.abs(w_).max()
        np.testing.assert_allclose(g.numpy(), w_, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("rows,dtype,sms", [
    (2560, torch.bfloat16, 132), (10240, torch.bfloat16, 132),
    (2560, torch.float32, 132), (7, torch.float32, 132),
    (1, torch.bfloat16, 8), (100, torch.bfloat16, 132)])
def test_layer_norm_bwd_grid(rows, dtype, sms):
    # the backward kernel's grid: one block an SM (16 warps in bf16, 8 in
    # f32), so that a cooperative launch holds them all, but no more blocks
    # than give every warp a row; each block an equal contiguous share
    # (floor or ceil of rows / blocks)
    blocks = tln.bwd_grid(rows, dtype, sms)
    warps = 16 if dtype == torch.bfloat16 else 8
    assert 1 <= blocks <= sms
    assert blocks == sms or (blocks - 1) * warps < rows <= blocks * warps
    shares = [(b + 1) * rows // blocks - b * rows // blocks
              for b in range(blocks)]
    assert sum(shares) == rows and max(shares) - min(shares) <= 1
    assert tln.bwd_partial_bytes(rows, 64, dtype, sms) == blocks * 2 * 64 * 4


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


@pytest.mark.parametrize("change", [dict(hierarchical_version="p0"),
                                    dict(hierarchical_version="p1"),
                                    dict(multimodal=True,
                                         multimodal_model_type="visualbert"),
                                    dict(hl_include_objectives=["head"])])
def test_later_slices_raise(change):
    # the pointer heads, the auxiliary heads and (ROADMAP A5e) the
    # VisualBERT encoder are ported and build
    _, tc = _cfgs()
    cfg = dataclasses.replace(tc, **change)
    if cfg.multimodal:
        from multimodal_sequencing_tpu_torch.models.visualbert import (
            VisualBERTEncoder)
        model = SequencingModel(cfg)
        assert isinstance(model.encoder, VisualBERTEncoder)
        assert hasattr(model.encoder, "vision_model")
        assert model.vision_cfg is None
        return
    model = SequencingModel(cfg)
    assert hasattr(model, "pointer_head") == (
        cfg.hierarchical_version in ("p0", "p1"))
    assert hasattr(model, "aux_heads") == bool(cfg.hl_include_objectives)


def test_init_weights_is_seeded():
    _, tc = _cfgs()
    a = init_weights(SequencingModel(tc), 5).state_dict()
    b = init_weights(SequencingModel(tc), 5).state_dict()
    c = init_weights(SequencingModel(tc), 6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layer_0.attention.query.weight"],
                           c["encoder.layer_0.attention.query.weight"])


def test_init_weights_follows_flax_defaults():
    # each leaf's std against the JAX package's model.init (Flax defaults:
    # lecun_normal Dense kernels, 1/sqrt(features) Embed tables, zero
    # biases, unit LayerNorm scales); the bits differ, so the stds are held
    # within sampling tolerance: 4 standard errors of a std estimate,
    # 4 / sqrt(2 n), plus the truncation's share
    jc, tc = _cfgs(type_vocab_size=N_STEPS)
    ids, mask, types = _batch()
    variables, _ = _jax_model(jc, 0, ids, mask, types)
    want = params_from_jax(variables, tc)
    got = init_weights(SequencingModel(tc), 0).state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if w.unique().numel() == 1:
            assert torch.equal(g, w), key  # zero biases, unit scales
            continue
        n = w.numel()
        tol = 4 / np.sqrt(2 * n) + 0.02
        assert abs(g.std().item() / w.std().item() - 1) < tol, key
        assert abs(g.mean().item()) < 4 * w.std().item() / np.sqrt(n), key


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
# what a 16-byte vector kernel can get wrong: n = 1, 7 and 8k + 3 (a scalar
# tail), x and g at a storage offset that is not a multiple of 8 elements
# (a scalar head), and x and g on different 16-byte phases (all scalar)
@pytest.mark.parametrize("n,x_off,g_off", [(333 * 129, 0, 0), (1, 0, 0),
                                           (7, 0, 0), (8 * 4099 + 3, 0, 0),
                                           (8005, 3, 3), (8005, 3, 0)])
def test_gelu_kernels_match_plain_on_card(n, x_off, g_off):
    _cuda_or_skip()
    from multimodal_sequencing_tpu_torch.ops import gelu as tgelu
    gen = torch.Generator().manual_seed(n)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(n + x_off, generator=gen) * 6).to("cuda", dtype)[x_off:]
        g = torch.randn(n + g_off, generator=gen).to("cuda", dtype)[g_off:]
        got = (tgelu.gelu_logit_erf_fwd(x), tgelu.gelu_logit_erf_bwd(x, g))
        want = (tgelu.gelu_logit_erf_reference(x),
                tgelu.gelu_logit_erf_bwd_reference(x, g))
        for a, e in zip(got, want):
            if dtype == torch.float32:
                # the same formula rounded in other places, with ex2.approx
                # and rcp.approx (see chip_smoke.py)
                torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-5)
            else:  # one bf16 ulp, or below 1e-30
                ulp = (_bf16_order(a.cpu().view(torch.int16).numpy())
                       - _bf16_order(e.cpu().view(torch.int16).numpy()))
                tiny = (a.float() - e.float()).abs().cpu().numpy() < 1e-30
                assert np.all((np.abs(ulp) <= 1) | tiny)


@pytest.mark.cuda
# 1000 features are not whole 16-byte vectors: the backward's scalar version
@pytest.mark.parametrize("n", [1024, 1000])
def test_layer_norm_kernels_match_plain_on_card(n):
    _cuda_or_skip()
    from multimodal_sequencing_tpu_torch.ops import layer_norm as tln
    x = torch.randn(37, n, device="cuda", requires_grad=True)
    w = torch.randn(n, device="cuda", requires_grad=True)
    b = torch.randn(n, device="cuda", requires_grad=True)
    dy = torch.randn(37, n, device="cuda")
    before = (tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches)
    y = tln.layer_norm(x, w, b, 1e-5, torch.float32)
    got = torch.autograd.grad(y, (x, w, b), dy)
    # one launch each way: dw and db come out of the backward's launch
    assert (tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    y_ref = tln.layer_norm_reference(x, w, b, 1e-5, torch.float32)
    want = torch.autograd.grad(y_ref, (x, w, b), dy)
    # f32, sums in another order
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)
    # dw and db are summed in a fixed order: a rerun gives the same bits,
    # in both dtypes
    for dtype in (torch.float32, torch.bfloat16):
        xd, dyd = x.detach().to(dtype), dy.to(dtype)
        first = tln.layer_norm_bwd(xd, dyd, w.detach(), 1e-5)
        again = tln.layer_norm_bwd(xd, dyd, w.detach(), 1e-5)
        assert all(torch.equal(a, e) for a, e in zip(first, again))


@pytest.mark.cuda
# x one element past a 16-byte boundary takes both kernels' scalar path
@pytest.mark.parametrize("offset", [0, 1])
def test_layer_norm_kernels_share_row_statistics_on_card(offset):
    _cuda_or_skip()
    from multimodal_sequencing_tpu_torch.ops import layer_norm as tln
    rows, n = 300, 1024
    flat = torch.randn(rows * n + offset, device="cuda") + 0.5
    x = flat[offset:].view(rows, n)
    one, zero = torch.ones(n, device="cuda"), torch.zeros(n, device="cuda")
    # f32, w = 1, b = 0: y = (x - mean) * rstd rounded once; the backward's
    # dw over a dy that is 1 on row r alone is the same product, added to
    # zeros only: bit-equal when both kernels saw the same mean and rstd
    y = tln.layer_norm_fwd(x, one, zero, 1e-5)
    for r in (0, 137, rows - 1):
        dy = torch.zeros(rows, n, device="cuda")
        dy[r] = 1.0
        assert torch.equal(tln.layer_norm_bwd(x, dy, one, 1e-5)[1], y[r])
    # the scalar path agrees with the plain version as the vector path does
    w, b = torch.randn(n, device="cuda"), torch.randn(n, device="cuda")
    torch.testing.assert_close(
        tln.layer_norm_fwd(x, w, b, 1e-5),
        tln.layer_norm_reference(x, w, b, 1e-5, torch.float32),
        atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_constant_rows_on_card(dtype):
    _cuda_or_skip()
    from multimodal_sequencing_tpu_torch.ops import layer_norm as tln
    rows, n = 64, 1024
    # values of 7 significant bits: every sum of them and of their squares
    # is exact, so the variance is 0 in any order and y = b
    k = torch.randint(64, 128, (rows, 1), device="cuda")
    x = (k / 32.0).expand(rows, n).to(dtype)
    dy = torch.randn(rows, n, device="cuda").to(dtype)
    w, b = torch.randn(n, device="cuda"), torch.randn(n, device="cuda")
    y = tln.layer_norm_fwd(x, w, b, 1e-5)
    assert torch.equal(y, b.to(dtype).expand(rows, n))
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    tln.layer_norm_reference(xr, wr, br, 1e-5, dtype).backward(dy)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2 ** -7)
    # chip_smoke.py's LN_TOLERANCE: dw and db's atol relative to their
    # largest entry
    for name, got, want in zip(("dx", "dw", "db"),
                               tln.layer_norm_bwd(x, dy, w, 1e-5),
                               (xr.grad, wr.grad, br.grad)):
        scale = 1.0 if name == "dx" else want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=atol * scale, rtol=rtol)
