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


def test_dropout_is_the_training_slice():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(1, 1, 8, 16))
    with pytest.raises(NotImplementedError):
        tatt.flash_attention(q, k, v, mask, dropout_p=0.1)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "stride", "shape",
                                  "mask"])
def test_kernel_argument_checks(case):
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
    else:
        mask = torch.ones(2, 41, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        tatt._check(q, k, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, mask = (torch.from_numpy(x).cuda()
                     for x in _inputs(2, 4, 566, 64, mask_kind="tail_and_empty"))
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    before = tatt.flash_attention.launches
    o, lse = tatt.flash_attention(q, k, v, mask)
    assert tatt.flash_attention.launches == before + 1
    want_o, want_lse = tatt.attention_reference_lse(q, k, v, mask)
    atol, rtol = (1e-4, 0.0) if dtype == "float32" else (2e-2, 1e-2)
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
