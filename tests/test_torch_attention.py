"""The port's attention (`multimodal_sequencing_tpu_torch/ops/attention.py`)
against the JAX package's: the plain version against `attention_reference`
and the Pallas flash kernel in interpret mode (O and lse), with padded key
tails and fully masked batch rows. The Hopper kernel itself runs only on a
card (`-m cuda`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.ops import attention as jatt
from multimodal_sequencing_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)

ATOL = 1e-5  # f32 on both sides; the sums run in another order


def _inputs(b, h, s, d, seed=0, mask_kind="tail"):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) * 0.5
               for _ in range(3))
    mask = np.ones((b, s), np.int32)
    if mask_kind in ("tail", "tail_and_empty"):
        mask[:, int(0.75 * s):] = 0   # padded key tail
        mask[-1, int(0.5 * s):] = 0
    if mask_kind == "tail_and_empty":
        mask[0] = 0                   # a batch row with every key masked
    return q, k, v, mask


def _port(q, k, v, mask):
    o, lse = tatt.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(mask))
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (2, 4, 40, 16),
                                   (1, 2, 96, 32), (2, 2, 130, 64)])
@pytest.mark.parametrize("mask_kind", ["none", "tail", "tail_and_empty"])
def test_plain_matches_jax_reference(shape, mask_kind):
    q, k, v, mask = _inputs(*shape, mask_kind=mask_kind)
    want = jatt.attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                    mask=jnp.asarray(mask))
    got, _ = _port(q, k, v, mask)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,block", [(40, None), (128, None), (256, 64),
                                     (192, 64)])
@pytest.mark.parametrize("mask_kind", ["tail", "tail_and_empty"])
def test_plain_matches_pallas_interpret(s, block, mask_kind):
    # block None: one whole-row block; 64: several q and kv blocks
    q, k, v, mask = _inputs(2, 2, s, 16, seed=s, mask_kind=mask_kind)
    kw = {} if block is None else {"block_q": block, "block_k": block}
    want = jatt.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(mask), interpret=True, **kw)
    got, _ = _port(q, k, v, mask)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,block", [(64, 64), (256, 64), (192, 96)])
def test_lse_matches_pallas_interpret(s, block):
    q, k, v, mask = _inputs(2, 2, s, 16, seed=7, mask_kind="tail_and_empty")
    o, lse = jatt._fwd_pallas(*(jnp.asarray(x) for x in (q, k, v)),
                              jnp.asarray(mask), block, block, True)
    got_o, got_lse = _port(q, k, v, mask)
    np.testing.assert_allclose(got_o, np.asarray(o), atol=ATOL, rtol=0)
    # lse is ~log(S) for live rows and -1e9 (+log S, lost to f32) for the
    # fully masked row: compare live rows at ATOL, the dead row exactly
    want = np.asarray(lse).reshape(2 * 2, s)
    live = mask.repeat(2, axis=0).any(axis=1)
    np.testing.assert_allclose(got_lse[live], want[live], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_lse[~live], want[~live])


def test_fully_masked_row_is_uniform_over_real_keys():
    q, k, v, mask = _inputs(2, 2, 40, 16, mask_kind="tail_and_empty")
    got, _ = _port(q, k, v, mask)
    np.testing.assert_allclose(got[0], np.broadcast_to(
        v[0].mean(axis=1, keepdims=True), got[0].shape), atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 40, 16))
    before = tatt.flash_attention.launches
    o, lse = tatt.flash_attention(q, k, v, mask)
    want_o, want_lse = tatt.attention_reference_lse(q, k, v, mask)
    assert tatt.flash_attention.launches == before
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert torch.equal(tatt.multihead_attention(q, k, v, mask),
                       tatt.attention_reference(q, k, v, mask))


@pytest.mark.parametrize("case", ["head_dim", "dtype", "stride", "shape",
                                  "mask", "align"])
def test_kernel_argument_checks(case):
    # the bf16 forward reads q, k, v through TMA tensor maps: a contiguous
    # head dim, strides of whole 16 bytes and a 16-byte aligned base
    x = torch.zeros(2, 2, 40, 16)
    q = k = v = x
    mask = torch.ones(2, 40, dtype=torch.int32)
    if case == "head_dim":
        q = k = v = torch.zeros(2, 2, 40, 48)
    elif case == "dtype":
        q = k = v = x.half()
    elif case == "stride":
        q = torch.zeros(2, 2, 40, 17)[..., :16]
    elif case == "shape":
        k = torch.zeros(2, 2, 41, 16)
    elif case == "mask":
        mask = torch.ones(2, 41, dtype=torch.int32)
    else:  # data not 16-byte aligned
        v = torch.zeros(2 * 2 * 40 * 16 + 1)[1:].view(2, 2, 40, 16)
    with pytest.raises((ValueError, TypeError)):
        tatt._check(q, k, v, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_argument_checks_pass_the_head_split_layout(dtype):
    # the encoder's head-split views of (B, S, H*D) projections: row stride
    # H*D, head stride D, taken as they are
    x = torch.zeros(2, 40, 4 * 16, dtype=dtype).view(2, 40, 4, 16).transpose(1, 2)
    tatt._check(x, x, x, torch.ones(2, 40, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, mask = (torch.from_numpy(x).cuda()
                     for x in _inputs(2, 4, 566, 64, mask_kind="tail_and_empty"))
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    atol, rtol = (1e-4, 0.0) if dtype == "float32" else (2e-2, 1e-2)
    for p in (0.0, 0.1):
        before = tatt.flash_attention.launches
        o, lse = tatt.flash_attention(q, k, v, mask, p, 5)
        assert tatt.flash_attention.launches == before + 1
        want_o, want_lse = tatt.attention_reference_lse(q, k, v, mask, p, 5)
        torch.testing.assert_close(o.float(), want_o.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    # each row's sums run in a fixed order: a rerun gives the same bits
    o2, lse2 = tatt.flash_attention(q, k, v, mask, 0.1, 5)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


# ----- the backward -------------------------------------------------------


def _bwd_case(s, seed=0, p=0.0):
    """q, k, v, a (B, S) mask with a padded tail and a fully masked row, dO,
    and the port's plain forward O and lse (f32 numpy)."""
    q, k, v, mask = _inputs(2, 2, s, 16, seed=seed, mask_kind="tail_and_empty")
    g = np.random.RandomState(seed + 1).randn(*q.shape).astype(np.float32)
    o, lse = tatt.attention_reference_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask), p,
        777)
    return q, k, v, mask, g, o.numpy(), lse.numpy()


@pytest.mark.parametrize("case", ["head_dim", "dtype", "stride", "shape",
                                  "mask", "o_shape", "do_dtype", "align"])
def test_bwd_argument_checks(case):
    x = torch.zeros(2, 2, 40, 16)
    q = k = v = o = do = x
    mask = torch.ones(2, 40, dtype=torch.int32)
    if case == "head_dim":
        q = k = v = o = do = torch.zeros(2, 2, 40, 48)
    elif case == "dtype":
        q = k = v = o = do = x.half()
    elif case == "stride":  # a row stride the tensor maps cannot take
        k = torch.zeros(2, 2, 40, 17)[..., :16]
    elif case == "shape":
        v = torch.zeros(2, 2, 41, 16)
    elif case == "mask":
        mask = torch.ones(2, 41, dtype=torch.int32)
    elif case == "o_shape":
        o = torch.zeros(2, 2, 40, 32)
    elif case == "do_dtype":
        do = x.bfloat16()
    else:  # data not 16-byte aligned
        q = torch.zeros(2 * 2 * 40 * 16 + 1)[1:].view(2, 2, 40, 16)
    with pytest.raises((ValueError, TypeError)):
        tatt._check_bwd(q, k, v, o, do, mask)


@pytest.mark.parametrize("case", ["ok", "shape", "dtype", "strided",
                                  "device"])
def test_bwd_buffer_checks(case):
    # lse2, delta and the dq accumulator as flash_bwd_prep makes them
    like = torch.zeros(2, 2, 40, 16)
    lse2, delta = torch.zeros(4, 64), torch.zeros(4, 64)
    acc = torch.zeros(4, 64, 16)
    if case == "shape":
        acc = torch.zeros(4, 40, 16)
    elif case == "dtype":
        delta = delta.bfloat16()
    elif case == "strided":  # bulk reduce-adds would land on wrong rows
        acc = torch.zeros(4, 64, 32)[..., :16]
    elif case == "device":
        lse2 = torch.zeros(4, 64, device="meta")
    rows = dict(lse2=(lse2, (4, 64)), delta=(delta, (4, 64)),
                acc=(acc, (4, 64, 16)))
    if case == "ok":
        tatt._check_f32_rows("flash_bwd_main", like, **rows)
        tatt._check_bf16("flash_bwd_post", like.bfloat16())
        return
    with pytest.raises(ValueError):
        tatt._check_f32_rows("flash_bwd_main", like, **rows)
    with pytest.raises(TypeError):  # the post-pass writes bf16 into `like`'s
        tatt._check_bf16("flash_bwd_post", like)  # layout


@pytest.mark.parametrize("offset", [0, 7 * 64 * 16])
def test_bwd_main_needs_the_turn_counters(offset):
    # the main kernel fixes the order of its dq adds with int32 turn
    # counters that flash_bwd_prep allocates in a vector of their own, one a
    # (batch*head, group of key tiles, q tile), and nothing else (its lanes
    # take their items by a fixed stride, with no work counter): a vector
    # of that length is taken at any storage offset, any other is refused,
    # as is an accumulator that is not a whole number of S_pad slices
    b, h, s_pad, d = 2, 2, 128, 16
    n_qt, groups = s_pad // 64, 2
    n = tatt.bwd_schedule_words(b, h, groups, n_qt)
    assert n == b * h * groups * n_qt
    turns = torch.zeros(offset + n, dtype=torch.int32)[offset:]
    acc = torch.zeros(b * h, groups * s_pad, d)
    assert tatt._acc_groups("flash_bwd_main", acc, b, h, s_pad) == groups
    tatt._check_turns("flash_bwd_main", turns, b, h, groups, n_qt)
    with pytest.raises(ValueError, match="turn counters"):
        tatt._check_turns("flash_bwd_main", turns, b, h, 1, n_qt)
    with pytest.raises(ValueError, match="turn counters"):
        tatt._check_turns("flash_bwd_main", turns.long(), b, h, groups, n_qt)
    with pytest.raises(ValueError, match="turn counters"):
        tatt._check_turns("flash_bwd_main", turns[:-1], b, h, groups, n_qt)
    with pytest.raises(ValueError):
        tatt._acc_groups("flash_bwd_main", acc[:, :s_pad + 64], b, h, s_pad)


def test_bwd_argument_checks_pass_the_head_split_layout():
    # the encoder's head-split views of (B, S, H*D) projections
    x = torch.zeros(2, 40, 2 * 16).view(2, 40, 2, 16).transpose(1, 2)
    tatt._check_bwd(x, x, x, x, x, torch.ones(2, 40, dtype=torch.int32))


@pytest.mark.parametrize("s", [40, 130])
def test_attention_delta_matches_jax_formula(s):
    _, _, _, _, g, o, _ = _bwd_case(s, seed=s)
    bh = o.shape[0] * o.shape[1]
    # `flash_attention_bwd`'s delta in the JAX package
    want = jnp.sum(jnp.asarray(g).reshape(bh, s, 16).astype(jnp.float32)
                   * jnp.asarray(o).reshape(bh, s, 16).astype(jnp.float32), -1)
    got = tatt.attention_delta(torch.from_numpy(o), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("s", [40, 64, 130])
def test_bwd_prep_pads_to_whole_tiles(s):
    _, _, _, _, g, o, lse = _bwd_case(s, seed=s)
    o_t, g_t, lse_t = (torch.from_numpy(x) for x in (o, g, lse))
    delta, lse2, acc = tatt.attention_bwd_prep_reference(o_t, g_t, lse_t)
    s_pad = -(-s // 64) * 64
    assert delta.shape == lse2.shape == (4, s_pad)
    assert acc.shape == (4, s_pad, 16) and not acc.any()
    assert torch.equal(delta[:, :s], tatt.attention_delta(o_t, g_t))
    assert not delta[:, s:].any() and torch.isinf(lse2[:, s:]).all()
    np.testing.assert_allclose(lse2[:, :s].numpy(), lse * np.log2(np.e),
                               rtol=1e-6)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_bwd_post_undoes_the_accumulator_chunk_swizzle(d):
    # the main kernel stores chunk c of row r at chunk c ^ (r & m)
    b, h, s = 1, 2, 70
    dq = torch.randn(b, h, s, d)
    m = min(8, d // 4) - 1
    acc = torch.zeros(b * h, 128, d // 4, 4)
    for r in range(s):
        for c in range(d // 4):
            acc[:, r, c ^ (r & m)] = dq[0, :, r, 4 * c:4 * c + 4]
    got = tatt.attention_bwd_post_reference(acc.view(b * h, 128, d), dq)
    torch.testing.assert_close(got, dq / np.sqrt(d), atol=1e-6, rtol=0)


@pytest.mark.parametrize("s", [40, 130])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_bwd_on_cpu_matches_pallas_backward_interpret(s, p):
    q, k, v, mask, g, o, lse = _bwd_case(s, seed=s, p=p)
    seed = 777
    want = jatt.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, mask, o)),
        jnp.asarray(lse.reshape(4, 1, s)), jnp.asarray(g), interpret=True,
        dropout_p=p, seed=jnp.int32(seed), bits_hw=False)
    got = tatt.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, mask, o, lse, g)), p, seed)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)
    for grad in got:  # the fully masked batch row
        assert torch.all(grad[0] == 0)


@pytest.mark.cuda
def test_hopper_bwd_launches_and_deterministic_dk_dv_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, mask = (torch.from_numpy(x).cuda()
                     for x in _inputs(2, 4, 566, 64, mask_kind="tail_and_empty"))
    q, k, v = (x.bfloat16() for x in (q, k, v))
    o, lse = tatt.flash_attention(q, k, v, mask, 0.1, 5)
    do = torch.randn_like(q)
    fns = (tatt.flash_bwd_prep, tatt.flash_bwd_main, tatt.flash_bwd_post,
           tatt.flash_attention_bwd_dq, tatt.flash_attention_bwd_dkv)
    before = [f.launches for f in fns]
    first = tatt.flash_attention_bwd(q, k, v, mask, o, lse, do, 0.1, 5)
    again = tatt.flash_attention_bwd(q, k, v, mask, o, lse, do, 0.1, 5)
    assert [f.launches - n for f, n in zip(fns, before)] == [2, 2, 2, 0, 0]
    # dq's partials are reduce-added in a fixed order: dq is bit-equal too
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = tatt.attention_bwd_reference(q, k, v, mask, o, lse, do, 0.1, 5)
    for a, w in zip(first, want):
        lim = 2e-2 * w.float().abs().max() + 2e-2 * w.float().abs()
        assert ((a.float() - w.float()).abs() <= lim).all()
