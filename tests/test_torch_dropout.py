"""The port's fused attention dropout against the JAX package's: the murmur3
keep bits against `_keep_bits`/`_seed_for_bh` and the numpy oracle of
`tests/test_attention.py`, the plain forward and all three gradients against
`jax.vjp` of `_flash_attention_ad(..., interpret=True, bits_hw=False)` with
a fully masked batch row at S not a multiple of 64, the `FlashAttention`
function and the bit dumps on the CPU, the dumped-bits check of
`tools/verify_dropout_bits`, and the hidden dropout. The Hopper kernels
themselves run only on a card (`-m cuda`)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.ops import attention as jatt
from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng, dropout
from multimodal_sequencing_tpu_torch.ops import attention as tatt
from multimodal_sequencing_tpu_torch.tools import verify_dropout_bits

sys.path.insert(0, os.path.dirname(__file__))
from test_attention import _host_keep_bits  # noqa: E402

torch.set_num_threads(1)

# f32 on both sides; the sums run in another order
ATOL = 1e-5
SEEDS = [0, 1234, -7, 2**31 - 1, -2**31]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("s,p", [(40, 0.1), (130, 0.25), (1024, 0.1)])
def test_keep_bits_match_jax_and_numpy_oracle(seed, s, p):
    # (B*H) = 3 rows; seq_len * seq_len wraps int32 at S = 1024 with the
    # multiplier, and negative seeds wrap as uint32
    got = tatt.keep_bits(seed, 1, 3, s, p)[0].numpy()
    thresh = tatt.keep_threshold(p)
    assert thresh == int((1.0 - p) * 2147483647)
    rows = jnp.arange(s, dtype=jnp.int32)
    for bh in range(3):
        want = np.asarray(jatt._keep_bits(
            jatt._seed_for_bh(jnp.int32(seed), jnp.int32(bh)), rows, rows, s,
            thresh))
        np.testing.assert_array_equal(got[bh], want)
        np.testing.assert_array_equal(
            got[bh], _host_keep_bits(seed & 0xFFFFFFFF, bh, s, p))
    assert abs(got.mean() - (1 - p)) < 0.02


def test_mix32_wraps_like_int32():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 123456789],
                 np.uint32)
    want = np.asarray(jatt._mix32(jnp.asarray(x.view(np.int32))))
    got = tatt._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want.view(np.uint32))


def _inputs(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) * 0.5
               for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[:, int(0.75 * s):] = 0
    mask[0] = 0  # a batch row with every key masked
    g = rng.randn(b, h, s, d).astype(np.float32)
    return q, k, v, mask, g


@pytest.mark.parametrize("s", [40, 130])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fwd_and_grads_match_jax_flash_interpret(s, p):
    q, k, v, mask, g = _inputs(2, 2, s, 16, seed=s)
    seed = 777

    def f(q, k, v):
        return jatt._flash_attention_ad(q, k, v, jnp.asarray(mask),
                                        jnp.int32(seed), p, True, False)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = (o,) + vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tatt.multihead_attention(tq, tk, tv, torch.from_numpy(mask), p,
                                   seed)
    out.backward(torch.from_numpy(g))
    got = (out.detach(), tq.grad, tk.grad, tv.grad)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=name)
    # the fully masked batch row: uniform forward, zero gradient (the
    # kernels' p = where(mask, exp(s - lse), 0))
    for grad in got[1:]:
        assert torch.all(grad[0] == 0)


def test_flash_attention_function_on_cpu():
    q, k, v, mask, g = _inputs(1, 2, 40, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    m = torch.from_numpy(mask)
    counted = (tatt.flash_attention, tatt.flash_bwd_prep, tatt.flash_bwd_main,
               tatt.flash_bwd_post, tatt.flash_attention_bwd_dq,
               tatt.flash_attention_bwd_dkv)
    before = [f.launches for f in counted]
    o = tatt.FlashAttention.apply(tq, tk, tv, m, 99, 0.1)
    o.backward(torch.from_numpy(g))
    with torch.no_grad():
        want_o, lse = tatt.attention_reference_lse(tq, tk, tv, m, 0.1, 99)
        want = tatt.attention_bwd_reference(tq, tk, tv, m, want_o, lse,
                                            torch.from_numpy(g), 0.1, 99)
    assert torch.equal(o.detach(), want_o)
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(a, b)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert before == [f.launches for f in counted]


def test_dropout_needs_a_seed_and_a_valid_rate():
    q, k, v, mask, _ = (torch.from_numpy(x) for x in _inputs(1, 1, 8, 16, 0))
    with pytest.raises(ValueError):
        tatt.multihead_attention(q, k, v, mask, dropout_p=0.1)
    with pytest.raises(ValueError):
        tatt.flash_attention(q, k, v, mask, dropout_p=1.0)
    with pytest.raises(ValueError):  # the backward kernels take CUDA tensors
        tatt.flash_attention_bwd_dq(q, k, v, mask, None, None, q)
    with pytest.raises(ValueError):
        tatt.flash_bwd_main(q, k, v, mask, None, None, None, q, 0.1, 3)
    with pytest.raises(ValueError):
        tatt.flash_bwd_prep(q, q, None)
    with pytest.raises(ValueError):
        tatt.flash_bwd_post(torch.zeros(1, 64, 16), q)


@pytest.mark.parametrize("order", ["fwd", "dkv"])
def test_dump_keep_bits_on_cpu_is_the_plain_bits(order):
    before = tatt.dump_keep_bits.launches
    got = tatt.dump_keep_bits(order, 5, 2, 3, 70, 0.1, device="cpu")
    assert got.shape == (2, 3, 70, 70) and got.dtype == torch.bool
    assert torch.equal(got, tatt.keep_bits(5, 2, 3, 70, 0.1))
    assert tatt.dump_keep_bits.launches == before
    with pytest.raises(ValueError):
        tatt.dump_keep_bits("bwd", 5, 2, 3, 70, 0.1, device="cpu")


def test_verify_dropout_bits_tool_on_cpu():
    res = verify_dropout_bits.verify(b=1, h=2, s=96, d=16, device="cpu")
    assert res["fwd_bwd_oracle"] == "ok" and res["bits_order_invariant"]
    assert res["fwd_err_vs_bits"] * 10 < res["fwd_err_vs_nobits"]


def test_hidden_dropout_is_flax_dropout():
    x = torch.randn(64, 256)
    rng = DropoutRng(3, 7, "cpu")
    y = dropout(x, 0.1, rng)
    kept = y != 0
    # kept entries are x / keep; the keep rate is 0.9 within 5 standard
    # deviations of 16384 draws
    torch.testing.assert_close(y[kept], x[kept] / 0.9, rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.9) < 5 * (0.09 / x.numel()) ** .5
    # the same (seed, step) gives the same mask; another step another one
    assert torch.equal(dropout(x, 0.1, DropoutRng(3, 7, "cpu")), y)
    assert not torch.equal(dropout(x, 0.1, DropoutRng(3, 8, "cpu")), y)
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, rng) is x


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_dropout_kernels_match_plain_on_card(dtype):
    _cuda_or_skip()
    q, k, v, mask, g = (torch.from_numpy(x).cuda()
                        for x in _inputs(2, 4, 566, 64, seed=1))
    q, k, v, g = (x.to(getattr(torch, dtype)) for x in (q, k, v, g))
    o, lse = tatt.flash_attention(q, k, v, mask, 0.1, 42)
    want_o, want_lse = tatt.attention_reference_lse(q, k, v, mask, 0.1, 42)
    atol, rtol = (1e-4, 0.0) if dtype == "float32" else (2e-2, 1e-2)
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    got = tatt.flash_attention_bwd(q, k, v, mask, o, lse, g, 0.1, 42)
    want = tatt.attention_bwd_reference(q, k, v, mask, o, lse, g, 0.1, 42)
    for a, b in zip(got, want):
        scale = 1e-5 if dtype == "float32" else 2e-2
        assert ((a.float() - b.float()).abs()
                <= scale * b.float().abs().max() + scale * b.float().abs()).all()
    # dk and dv are summed in a fixed order: a rerun is bit-equal
    again = tatt.flash_attention_bwd(q, k, v, mask, o, lse, g, 0.1, 42)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    for order in ("fwd", "dkv"):
        assert torch.equal(tatt.dump_keep_bits(order, 42, 2, 4, 566, 0.1),
                           tatt.keep_bits(42, 2, 4, 566, 0.1, "cuda"))
