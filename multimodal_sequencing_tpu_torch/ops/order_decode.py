"""Batched order decoding on the heat map's own device (counterpart of
`ops/order_decode.py`).

Stories are short (N <= 7 on the exhaustive path), so every candidate order
is scored at once: an exact argmax over the n! permutations, plus a greedy
chain decoder and a batched Kahn decode of the thresholded precedence
graph. These are gathers, logs, sums and argmaxes over at most 5040 x 6
terms a story, written as plain torch ops. The host decoders in
`utils/heatmap.py` stay the reference; `train/evaluation.py` routes here
under `--device_decode`.

Semantics follow the JAX package to the letter: f32 arithmetic, `EPS`
inside the log, the leading n x n block of the heat map, argmax ties to the
first permutation in lexicographic order (`torch.argmax` returns the first
maximal index on every device), and the topological decode's threshold,
reversed lower edges and lowest-index choice.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

EPS = 1e-8


def all_permutations(n: int) -> np.ndarray:
    """(n!, n) int32 permutation table in lexicographic order."""
    return np.asarray(list(itertools.permutations(range(n))), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def permutation_table(n: int, device: torch.device) -> torch.Tensor:
    """`all_permutations(n)` as an int64 tensor on `device`, made once per
    (n, device), so a batch copies no table from the host. Callers only
    read it."""
    return torch.from_numpy(all_permutations(n)).long().to(device)


def pairs_to_heatmap(pair_scores: torch.Tensor, pair_idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Scatter per-pair scores into (B, N, N) heat maps.

    pair_scores: (B, P) score for 'i precedes j' per ordered pair.
    pair_idx: (P, 2) the (i, j) of each pair (shared across the batch).
    """
    b = pair_scores.shape[0]
    hm = torch.zeros((b, n, n), dtype=pair_scores.dtype,
                     device=pair_scores.device)
    idx = pair_idx.long().to(pair_scores.device)
    hm[:, idx[:, 0], idx[:, 1]] = pair_scores
    return hm


def exhaustive_order_decode(heatmap: torch.Tensor, n: int,
                            mode: str = "chain_logprob",
                            tail: str = "none") -> torch.Tensor:
    """Exact MAP order over all n! permutations. heatmap: (B, N, N) with
    rows = parent, cols = child (N >= n; only the leading n x n block is
    used).

    mode:
      chain_logprob: sum_t log(hm[p_t, p_{t+1}]) (the host beam's objective).
      chain_sum:     sum_t hm[p_t, p_{t+1}] (the `_sum` variants).
      allpairs:      sum_{i<j} log hm[p_i, p_j]: the exact MAP linear order
        under independent pairwise precedence probabilities.

    tail (chain modes; the closing term of the host naive-beam family,
    `utils/heatmap.py::_decode_naive_beam`):
      none: the plain chain score.
      v2:   + f(1 - hm[p_last, p_0]) (reversed-head correction).
      v3:   chain terms score |hm|, and + f(|hm[p_last, p_0]|).
    f = log(x + EPS) for the log modes, the identity for chain_sum.
    Returns the (B, n) int32 best order of each batch element.
    """
    perms = permutation_table(n, heatmap.device)  # (K, n)
    hm = heatmap[:, :n, :n].float()
    if mode == "allpairs":
        iu, ju = np.triu_indices(n, k=1)
        terms = hm[:, perms[:, iu], perms[:, ju]]  # (B, K, P)
    elif mode in ("chain_logprob", "chain_sum"):
        hm_eff = hm.abs() if tail == "v3" else hm
        terms = hm_eff[:, perms[:, :-1], perms[:, 1:]]  # (B, K, n - 1)
    else:
        raise ValueError(f"unknown decode mode {mode}")
    if tail == "v2":
        tail_vals = 1.0 - hm[:, perms[:, -1], perms[:, 0]]  # (B, K)
    elif tail == "v3":
        tail_vals = hm[:, perms[:, -1], perms[:, 0]].abs()
    elif tail == "none":
        tail_vals = None
    else:
        raise ValueError(f"unknown decode tail {tail}")
    if mode != "chain_sum":
        terms = torch.log(terms + EPS)
        if tail_vals is not None:
            tail_vals = torch.log(tail_vals + EPS)
    scores = terms.sum(-1)
    if tail_vals is not None:
        scores = scores + tail_vals
    return perms[scores.argmax(-1)].int()


def exhaustive_naive_decode(heatmap: torch.Tensor, n: int,
                            decode_method: str = "naive_v2_sum"
                            ) -> torch.Tensor:
    """Exact argmax under the host `naive`/`naive_v2`/`naive_v3` (± `_sum`)
    beam scoring: a method-string adapter over `exhaustive_order_decode`.
    The host beam searches a pruned subset of the permutations with the
    same score, so the two agree wherever the beam finds the global argmax
    (every clean total-order heat map); elsewhere this one is exact.
    Returns (B, n)."""
    tail = ("v2" if "v2" in decode_method
            else "v3" if "v3" in decode_method else "none")
    mode = "chain_sum" if "sum" in decode_method else "chain_logprob"
    return exhaustive_order_decode(heatmap, n, mode=mode, tail=tail)


def greedy_order_decode(heatmap: torch.Tensor, n: int) -> torch.Tensor:
    """Greedy chain decode for large N: start from the row with the highest
    total precedence mass, then take the best unvisited successor, n - 1
    times. (B, n) int32."""
    hm = heatmap[:, :n, :n].float()
    b = hm.shape[0]
    rows = torch.arange(b, device=hm.device)
    curr = hm.sum(-1).argmax(-1)  # (B,)
    visited = torch.zeros((b, n), dtype=torch.bool, device=hm.device)
    visited[rows, curr] = True
    out = torch.zeros((b, n), dtype=torch.int32, device=hm.device)
    out[:, 0] = curr
    for t in range(1, n):
        row = hm[rows, curr].masked_fill(visited, float("-inf"))
        curr = row.argmax(-1)
        visited[rows, curr] = True
        out[:, t] = curr
    return out


def topological_decode_batch(heatmap: torch.Tensor, n: int,
                             thres: float = 0.2) -> torch.Tensor:
    """Batched Kahn-style decode of the thresholded precedence graph:
    repeatedly emit the lowest-index vertex with no unemitted predecessor
    (falling back to the lowest unemitted vertex when a cycle leaves none
    ready). On a clean total order this recovers it exactly. (B, n) int32."""
    hm = heatmap[:, :n, :n]
    b = hm.shape[0]
    rows = torch.arange(b, device=hm.device)
    # adj[i, j]: i precedes j. Upper entries above the threshold keep their
    # edge; upper entries at or below it give the reversed edge j -> i.
    iu = torch.ones((n, n), dtype=torch.bool, device=hm.device).triu(1)
    above = hm > thres
    adj = (above & iu) | (~above & iu).transpose(1, 2)
    emitted = torch.zeros((b, n), dtype=torch.bool, device=hm.device)
    out = torch.zeros((b, n), dtype=torch.int32, device=hm.device)
    for t in range(n):
        indeg = (adj & ~emitted[:, :, None]).sum(1)  # from unemitted vertices
        ready = (indeg == 0) & ~emitted
        pick = torch.where(ready.any(-1), ready.to(torch.uint8).argmax(-1),
                           (~emitted).to(torch.uint8).argmax(-1))
        emitted[rows, pick] = True
        out[:, t] = pick
    return out
