"""The logit_erf GELU's plain versions, which are the oracle of the card's
kernels (`ops/csrc/gelu.cu`), against the JAX package's `gelu_logit_erf`
over every finite bf16 input, forward and gradient; and the wrappers' host
side that runs without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.ops.gelu import gelu_logit_erf as j_gelu_logit_erf
from multimodal_sequencing_tpu_torch.ops import gelu as tgelu

torch.set_num_threads(1)

# The plain versions and JAX round the same f32 formula in other places
# (exp, fused multiply-adds), so a bf16 result may flip by one ulp where its
# f32 value sits within a few f32 ulps of a rounding tie: 1 forward and 4
# gradient flips over all inputs today. Many more would mean a changed
# formula.
MAX_FLIPS = 16


def _all_finite_bf16() -> np.ndarray:
    """The 65,280 finite bf16 values, as f32 (exact), from their bit
    patterns."""
    f32 = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    return f32[np.isfinite(f32)]


def _bf16_order(x: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers ordered like the values they encode,
    so a difference of 1 is one ulp (also across zero)."""
    bits = x.view(np.uint16).astype(np.int32)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _ulp_rule(want: np.ndarray, got: torch.Tensor):
    """Bf16 results at most one ulp apart, or less than 1e-30 apart (where
    f32 intermediates sit near the denormal range and XLA flushes them).
    Returns the count of one-ulp flips."""
    got_np = got.view(torch.int16).numpy().view(np.uint16)
    ulp = np.abs(_bf16_order(want.view(np.uint16)) - _bf16_order(got_np))
    tiny = np.abs(want.astype(np.float32) - got.float().numpy()) < 1e-30
    bad = (ulp > 1) & ~tiny
    assert not bad.any(), (f"{bad.sum()} results beyond one ulp, e.g. at "
                           f"{np.flatnonzero(bad)[:5]}")
    return int((ulp == 1).sum())


def test_plain_forward_matches_jax_on_every_bf16_input():
    x = _all_finite_bf16()
    assert x.size == 65280
    assert np.array_equal(torch.from_numpy(x).bfloat16().float().numpy(), x)
    want = np.asarray(j_gelu_logit_erf(jnp.asarray(x, jnp.bfloat16)))
    got = tgelu.gelu_logit_erf_reference(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _ulp_rule(want, got) <= MAX_FLIPS


@pytest.mark.parametrize("g", ["ones", "random"])
def test_plain_backward_matches_jax_on_every_bf16_input(g):
    # g = 1 is jax.grad of the sum; a random g (bf16, from a seed) goes
    # through jax.vjp, as the encoder's backward hands the GELU its g
    x = _all_finite_bf16()
    rng = np.random.default_rng(0)
    gv = (np.ones_like(x) if g == "ones"
          else rng.standard_normal(x.size).astype(np.float32))
    xj = jnp.asarray(x, jnp.bfloat16)
    gj = jnp.asarray(gv, jnp.bfloat16)
    if g == "ones":
        want = jax.grad(lambda v: jnp.sum(
            j_gelu_logit_erf(v).astype(jnp.float32)))(xj)
    else:
        _, vjp = jax.vjp(j_gelu_logit_erf, xj)
        (want,) = vjp(gj)
    got = tgelu.gelu_logit_erf_bwd_reference(
        torch.from_numpy(x).bfloat16(),
        torch.from_numpy(np.array(gj.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _ulp_rule(np.asarray(want), got) <= MAX_FLIPS


def test_cpu_wrappers_take_the_plain_versions():
    # a CPU tensor never reaches the kernel: no launch is counted
    x = torch.from_numpy(_all_finite_bf16()[::97].copy()).bfloat16()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    before = (tgelu.gelu_logit_erf_fwd.launches,
              tgelu.gelu_logit_erf_bwd.launches)
    assert torch.equal(tgelu.gelu_logit_erf_fwd(x),
                       tgelu.gelu_logit_erf_reference(x))
    assert torch.equal(tgelu.gelu_logit_erf_bwd(x, g),
                       tgelu.gelu_logit_erf_bwd_reference(x, g))
    assert (tgelu.gelu_logit_erf_fwd.launches,
            tgelu.gelu_logit_erf_bwd.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 3, 5, 8])
def test_output_shares_the_input_phase(dtype, offset):
    # the kernel's 16-byte vectors line up in input and output only when
    # both start at the same offset from a 16-byte boundary
    base = torch.zeros(4 * 37 + 16, dtype=dtype)
    x = base[offset:offset + 4 * 37].view(4, 37)
    out = tgelu._empty_on_phase(x)
    assert out.shape == x.shape and out.dtype == dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16


@pytest.mark.parametrize("fault", ["dtype", "mixed_dtypes", "shape"])
def test_launch_checks_raise_before_the_card(fault):
    x = torch.zeros(5, 7)
    if fault == "dtype":
        with pytest.raises(TypeError):
            tgelu._launch("gelu_logit_erf_fwd", x.double())
    elif fault == "mixed_dtypes":
        with pytest.raises(TypeError):
            tgelu._launch("gelu_logit_erf_bwd", x, x.bfloat16())
    else:
        with pytest.raises(ValueError):
            tgelu._launch("gelu_logit_erf_bwd", x, torch.zeros(7, 5))
