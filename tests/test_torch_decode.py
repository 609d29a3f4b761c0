"""The port's batched order decoders (`ops/order_decode.py`) and the
`--device_decode` route of `SortEvaluator.decode_heatmap` against the JAX
package's, on the same seeded heat maps: random ones (32 a case) and clean
total-order ones. Orders must be equal; range assertions must fire on the
same inputs.

One exception, which the tail v3 makes by construction: its closing term
hm[p_last, p_0] closes the chain into a cycle, so the n rotations of an
order score the same multiset of terms and tie exactly. f32 rounding then
picks among them, and XLA's log and torch's differ in the last bit on some
inputs. Where the two packages' orders differ under v3, they must be
rotations of each other whose scores, in f64, agree within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.ops import order_decode as jod
from multimodal_sequencing_tpu.train.evaluation import (
    SortEvaluator as JSortEvaluator)
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.ops import order_decode as tod
from multimodal_sequencing_tpu_torch.train.evaluation import (
    SortEvaluator as TSortEvaluator)

torch.set_num_threads(1)

B = 32
NS = [2, 3, 4, 5, 6, 7]
DECODE_METHODS = ["super_naive", "naive", "naive_v2", "naive_v3",
                  "naive_sum", "naive_v2_sum", "naive_v3_sum",
                  "topological", "mst"]


def _clean(n, size, rng, count=4, soft=0.1):
    """Heat maps of random total orders, as the training targets draw them:
    1 for the next step, `soft` for later ones, 0 for earlier ones; padded
    to `size` with random entries outside the leading n x n block."""
    out = rng.uniform(0, 1, (count, size, size)).astype(np.float32)
    orders = [rng.permutation(n) for _ in range(count)]
    for hm, order in zip(out, orders):
        pos = np.argsort(order)
        for i in range(n):
            for j in range(n):
                hm[i, j] = (1.0 if pos[j] == pos[i] + 1
                            else soft if pos[j] > pos[i] else 0.0)
    return out, np.stack(orders)


def _heatmaps(n, signed, seed, soft=0.1):
    """(B + 4, n + 1, n + 1) f32: B random maps in [0, 1] (or [-1, 1] when
    `signed`) then 4 clean ones; the extra row and column check that only
    the leading n x n block is read."""
    rng = np.random.default_rng(seed)
    lo = -1.0 if signed else 0.0
    rand = rng.uniform(lo, 1.0, (B, n + 1, n + 1)).astype(np.float32)
    clean, orders = _clean(n, n + 1, rng, soft=soft)
    return np.concatenate([rand, clean]), orders


def _port(fn, hm, *args, **kw):
    return fn(torch.from_numpy(hm), *args, **kw).numpy()


def _score(hm, order, mode, tail):
    """The decode objective of one order, in f64."""
    hm = np.abs(hm.astype(np.float64)) if tail == "v3" else hm.astype(
        np.float64)
    f = (lambda x: x) if mode == "chain_sum" else (
        lambda x: np.log(x + 1e-8))
    n = len(order)
    pairs = ([(order[i], order[j]) for i in range(n) for j in range(i + 1, n)]
             if mode == "allpairs" else list(zip(order[:-1], order[1:])))
    total = sum(f(hm[i, j]) for i, j in pairs)
    if tail == "v2":
        total += f(1.0 - hm[order[-1], order[0]])
    elif tail == "v3":
        total += f(hm[order[-1], order[0]])
    return total


def _assert_same_or_tied(got, want, hms, mode, tail):
    """Equal orders, or under v3 rotations of one cycle that tie."""
    for g, w, hm in zip(np.asarray(got).tolist(), np.asarray(want).tolist(),
                        hms):
        if g == w:
            continue
        assert tail == "v3", (g, w)
        k = w.index(g[0])
        assert w[k:] + w[:k] == g, (g, w)
        a, b = _score(hm, g, mode, tail), _score(hm, w, mode, tail)
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), (g, w, a, b)


def test_all_permutations_and_the_cached_table():
    for n in NS:
        np.testing.assert_array_equal(tod.all_permutations(n),
                                      jod.all_permutations(n))
        table = tod.permutation_table(n, torch.device("cpu"))
        assert table.dtype == torch.int64
        np.testing.assert_array_equal(table.numpy(), jod.all_permutations(n))
        # one table per (n, device): a second batch copies nothing
        assert tod.permutation_table(n, torch.device("cpu")) is table


@pytest.mark.parametrize("tail", ["none", "v2", "v3"])
@pytest.mark.parametrize("mode", ["chain_logprob", "chain_sum", "allpairs"])
@pytest.mark.parametrize("n", NS)
def test_exhaustive_order_decode_matches_jax(n, mode, tail):
    hm, orders = _heatmaps(n, signed=tail == "v3",
                           seed=100 * n + len(mode) + len(tail))
    want = np.asarray(jod.exhaustive_order_decode(jnp.asarray(hm), n,
                                                  mode=mode, tail=tail))
    got = _port(tod.exhaustive_order_decode, hm, n, mode=mode, tail=tail)
    assert got.dtype == np.int32 and got.shape == (len(hm), n)
    _assert_same_or_tied(got, want, hm, mode, tail)
    if tail in ("none", "v2"):  # the clean maps decode to their own orders
        np.testing.assert_array_equal(got[B:], orders)


@pytest.mark.parametrize("method", [m for m in DECODE_METHODS
                                    if "naive" in m and m != "super_naive"])
def test_exhaustive_naive_decode_matches_jax(method):
    for n in NS:
        hm, _ = _heatmaps(n, signed="v3" in method, seed=n + len(method))
        _assert_same_or_tied(
            _port(tod.exhaustive_naive_decode, hm, n, method),
            np.asarray(jod.exhaustive_naive_decode(jnp.asarray(hm), n,
                                                   method)), hm,
            "chain_sum" if "sum" in method else "chain_logprob",
            "v3" if "v3" in method else "none")


@pytest.mark.parametrize("n", NS)
def test_greedy_order_decode_matches_jax(n):
    hm, _ = _heatmaps(n, signed=False, seed=7 * n)
    got = _port(tod.greedy_order_decode, hm, n)
    np.testing.assert_array_equal(
        got, np.asarray(jod.greedy_order_decode(jnp.asarray(hm), n)))
    assert all(sorted(o) == list(range(n)) for o in got.tolist())


@pytest.mark.parametrize("n", NS)
def test_topological_decode_batch_matches_jax(n):
    # clean maps above the threshold for every later step
    hm, orders = _heatmaps(n, signed=True, seed=11 * n, soft=1.0)
    got = _port(tod.topological_decode_batch, hm, n)
    np.testing.assert_array_equal(
        got, np.asarray(jod.topological_decode_batch(jnp.asarray(hm), n)))
    np.testing.assert_array_equal(got[B:], orders)
    assert all(sorted(o) == list(range(n)) for o in got.tolist())


def test_pairs_to_heatmap_matches_jax():
    n = 5
    idx = np.array([(i, j) for i in range(n) for j in range(n) if i != j],
                   np.int32)
    scores = np.random.default_rng(0).normal(size=(3, len(idx))).astype(
        np.float32)
    want = np.asarray(jod.pairs_to_heatmap(jnp.asarray(scores),
                                           jnp.asarray(idx), n))
    got = tod.pairs_to_heatmap(torch.from_numpy(scores),
                               torch.from_numpy(idx), n).numpy()
    np.testing.assert_array_equal(got, want)


def _evaluators(method):
    kw = dict(heatmap_decode_method=method, device_decode=True)
    return (JSortEvaluator(jcfg.MultimodalConfig(**kw), None),
            TSortEvaluator(tcfg.MultimodalConfig(**kw), None, device="cpu"))


def _outcome(fn, hm):
    try:
        return fn(hm)
    except AssertionError as e:
        return ("AssertionError", str(e))


@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("method", DECODE_METHODS)
def test_device_decode_heatmap_matches_jax(method, n):
    jev, tev = _evaluators(method)
    rng = np.random.default_rng(n + len(method))
    valid = np.concatenate([
        rng.uniform(0, 1, (B, n, n)).astype(np.float32),
        _clean(n, n, rng)[0]])
    cases = {"valid": valid,
             "negative": valid - np.float32(0.5),
             "above_one": valid * np.float32(1.5)}
    outcomes = {}
    for name, hm in cases.items():
        want = _outcome(jev.decode_heatmap, hm)
        got = _outcome(tev.decode_heatmap, hm)
        assert type(got) is type(want), name
        if isinstance(got, tuple) or not ("v3" in method and n <= 7):
            assert got == want, name
        else:  # the exhaustive v3 decode: see the module docstring
            _assert_same_or_tied(
                got, want, hm,
                "chain_sum" if "sum" in method else "chain_logprob", "v3")
        outcomes[name] = got
    orders = outcomes["valid"]
    assert isinstance(orders, list) and len(orders) == B + 4
    if method != "super_naive":  # which may revisit a step, as in JAX
        assert all(sorted(o) == list(range(n)) for o in orders)
    # the ranges the host decoders assert
    raises = {"negative": "v3" not in method and method != "topological",
              "above_one": "v2" in method or "v3" in method}
    for name, expect in raises.items():
        assert isinstance(outcomes[name], tuple) == expect, name


def test_device_decode_keeps_the_finite_check():
    _, tev = _evaluators("naive_v2_sum")
    hm = np.full((2, 5, 5), 0.5, np.float32)
    hm[1, 2, 3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tev.decode_heatmap(hm)
