"""Ring attention through the port (`parallel/ring_attention.py`) against
the JAX package's on its virtual 8-device mesh and against the plain
attention, with `tests/test_ring_attention.py`'s inputs.

* One process holding every position of rings of 2, 4 and 8: the forward
  (2e-5; ring 8 has blocks whose keys are all masked), a row whose keys
  are all masked (uniform, as JAX's recurrence makes it), the backward at
  ring 4 (dq, dk, dv at 5e-5 absolute / 5e-4 relative) and the error for a
  sequence that does not divide.
* One spawn of four gloo ranks: rings of 2 and 4 across ranks, each rank
  passing its own block of the sequence, forward and backward, against
  the one-process ring and JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.ops.attention import (
    attention_reference as j_attention_reference)
from multimodal_sequencing_tpu.parallel.mesh import make_mesh
from multimodal_sequencing_tpu.parallel.ring_attention import (
    ring_attention as j_ring_attention)
from multimodal_sequencing_tpu_torch.ops.attention import attention_reference
from multimodal_sequencing_tpu_torch.parallel.mesh import Ring
from multimodal_sequencing_tpu_torch.parallel.ring_attention import (
    ring_attention)

from torch_parallel_ranks import run_case, run_ranks

torch.set_num_threads(1)


def _inputs(b=2, h=2, s=64, d=16, seed=0):
    """`tests/test_ring_attention.py`'s inputs, as numpy."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) * 0.5
               for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[:, int(0.8 * s):] = 0
    mask[-1, int(0.4 * s):] = 0
    return q, k, v, mask


def _jax_ring(ring, q, k, v, mask):
    mesh = make_mesh(n_data=8 // ring, n_model=ring)
    return np.asarray(jax.jit(lambda *a: j_ring_attention(
        *a, mesh=mesh, axis_name="model"))(q, k, v, mask))


def _jax_grads(ring, q, k, v, mask):
    mesh = make_mesh(n_data=8 // ring, n_model=ring)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(j_ring_attention(q, k, v, mask, mesh=mesh,
                                                axis_name="model")))

    return [np.asarray(g) for g in jax.jit(jax.grad(
        loss, argnums=(0, 1, 2)))(q, k, v)]


def _port(ring, q, k, v, mask):
    return ring_attention(*map(torch.tensor, (q, k, v)), torch.tensor(mask),
                          ring=Ring(ring)).numpy()


@pytest.mark.parametrize("ring", [2, 4, 8])
def test_ring_forward_matches_jax_and_reference(ring):
    q, k, v, mask = _inputs()
    got = _port(ring, q, k, v, mask)
    np.testing.assert_allclose(got, _jax_ring(ring, q, k, v, mask),
                               atol=2e-5, rtol=2e-5)
    plain = attention_reference(*map(torch.tensor, (q, k, v)),
                                torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=2e-5)
    blocks = mask.reshape(mask.shape[0], ring, -1)
    # ring 8: the last row's last five blocks have no live key
    assert (ring == 8) <= bool((blocks.sum(-1) == 0).any())


def test_ring_row_without_live_keys_is_uniform_as_in_jax():
    # every key of the first row masked: each block's lse is -1e9 and the
    # merge weighs them alike, as JAX's -1e9 / -inf recurrence does
    q, k, v, mask = _inputs()
    mask[0] = 0
    got = _port(4, q, k, v, mask)
    np.testing.assert_allclose(got, _jax_ring(4, q, k, v, mask), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got[0], np.broadcast_to(
        v[0].mean(1, keepdims=True), v[0].shape), atol=2e-6)
    np.testing.assert_allclose(
        got, np.asarray(j_attention_reference(q, k, v, mask=mask)),
        atol=2e-5, rtol=2e-5)


def test_ring_backward_matches_jax():
    q, k, v, mask = _inputs(s=32, seed=3)
    want = _jax_grads(4, q, k, v, mask)
    got = run_case({"kind": "ring", "ring": 4, "q": q, "k": k, "v": v,
                    "mask": mask})["grads"]
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4,
                                   err_msg=f"d{name}")


def test_ring_rejects_indivisible_seq():
    q, k, v, mask = _inputs(s=30)
    with pytest.raises(ValueError, match="not divisible by ring size 4"):
        _port(4, q, k, v, mask)


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    """Rings of 2 and 4 positions across four gloo ranks (one spawn)."""
    q, k, v, mask = _inputs(s=32, seed=3)
    cases = {f"ring{r}": {"kind": "ring", "ring": r, "q": q, "k": k, "v": v,
                          "mask": mask} for r in (2, 4)}
    got = run_ranks(4, 4, cases, str(tmp_path_factory.mktemp("ring")))
    return got, cases


@pytest.mark.parametrize("ring", [2, 4])
def test_ring_across_ranks_matches_one_process_and_jax(ring_ranks, ring):
    got, cases = ring_ranks
    spec = cases[f"ring{ring}"]
    want = run_case(spec)
    np.testing.assert_allclose(got[f"ring{ring}"]["out"], want["out"],
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        got[f"ring{ring}"]["out"],
        _jax_ring(ring, spec["q"], spec["k"], spec["v"], spec["mask"]),
        atol=2e-5, rtol=2e-5)
    jax_grads = _jax_grads(ring, spec["q"], spec["k"], spec["v"],
                           spec["mask"])
    for g, w, j, name in zip(got[f"ring{ring}"]["grads"], want["grads"],
                             jax_grads, "qkv"):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(g, j, atol=5e-5, rtol=5e-4,
                                   err_msg=f"d{name}")
