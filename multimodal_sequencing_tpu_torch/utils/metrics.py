"""Sequencing metrics.

Semantics-parity reimplementation of the reference metric suite
(the original system's `trainers/metrics.py:58-296`; copy of the JAX
package's `utils/metrics.py`). All metrics operate on
predicted / ground-truth orderings (lists of step indices) and are averaged
over the batch. Multi-reference ground truths take the lexicographic-max
metric tuple over references (`metrics.py:21-55`).

Pure python/numpy: these are host-side scoring functions.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence

import numpy as np

# Canonical metric order used for multi-reference lexicographic max
# (reference `trainers/metrics.py:15-18`).
METRICS = [
    "partial_match", "exact_match", "lcs_substr", "lcs",
    "tau", "ms", "wms", "distance_based",
]


def make_same_len(pred, label):
    """Truncate both sequences to the shorter length (`metrics.py:189-195`)."""
    if not isinstance(label, list):
        label = list(label)
    if not isinstance(pred, list):
        pred = list(pred)
    min_len = min(len(pred), len(label))
    return pred[:min_len], label[:min_len]


def kendall_tau(pred: Sequence[int], label: Sequence[int]) -> float:
    """Pair-set Kendall tau (`metrics.py:70-80`).

    tau = 1 - 2 * (# ordered pairs of pred not in label's pair set) / C(n,2).
    For true permutations of the same items this equals standard Kendall tau.
    """
    p, t = make_same_len(pred, label)
    s_t = set(itertools.combinations(t, 2))
    s_p = set(itertools.combinations(p, 2))
    cn_2 = len(p) * (len(p) - 1) / 2
    pairs = len(s_p) - len(s_p & s_t)
    return 1 - 2 * pairs / cn_2


def partial_match(pred, label) -> float:
    """Position-wise accuracy, a.k.a. Acc / PM (`metrics.py:81-89`)."""
    p, t = make_same_len(pred, label)
    return float((np.asarray(p) == np.asarray(t)).mean())


def exact_match(pred, label) -> float:
    """Perfect-match ratio contribution, a.k.a. PMR / EM (`metrics.py:90-97`)."""
    p, t = make_same_len(pred, label)
    return float(np.array_equal(np.asarray(p), np.asarray(t)))


def distance_based(pred, label, max_story_length: int = 5) -> float:
    """Sum of absolute position displacements (`metrics.py:100-114`).

    Keeps the reference's quirk: when a ground-truth index is missing from the
    prediction the running distance is *reset* to `max_story_length` (plain
    assignment at `metrics.py:110`), not incremented.
    """
    p, t = make_same_len(pred, label)
    p = list(p)
    dist = 0
    for j, gt_idx in enumerate(t):
        if gt_idx not in p:
            dist = max_story_length
        else:
            dist += abs(j - p.index(gt_idx))
    return float(dist)


def lcs(pred, label) -> int:
    """Longest common subsequence length (`metrics.py:231-237`), via DP."""
    p, t = make_same_len(pred, label)
    m, n = len(p), len(t)
    dp = np.zeros((m + 1, n + 1), dtype=np.int64)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if p[i - 1] == t[j - 1]:
                dp[i, j] = dp[i - 1, j - 1] + 1
            else:
                dp[i, j] = max(dp[i - 1, j], dp[i, j - 1])
    return int(dp[m, n])


def lcs_substr(pred, label) -> int:
    """Longest common substring length (`metrics.py:198-228`)."""
    p, t = make_same_len(pred, label)
    m, n = len(p), len(t)
    best = 0
    dp = np.zeros((m + 1, n + 1), dtype=np.int64)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if p[i - 1] == t[j - 1]:
                dp[i, j] = dp[i - 1, j - 1] + 1
                best = max(best, int(dp[i, j]))
    return best


def min_swaps(pred, label, weighted: bool = False) -> float:
    """Cycle-decomposition minimum swaps MS / weighted WMS
    (`metrics.py:240-296`). `pred`/`label` must contain the same items."""
    p, t = make_same_len(pred, label)
    p = list(p)
    n = len(p)
    pred_pos = [p.index(x) for x in t]
    vis = [False] * n
    ans = 0.0
    for i in range(n):
        if vis[i] or pred_pos[i] == i:
            continue
        cycle_size = 0
        j = i
        while not vis[j]:
            vis[j] = True
            j = pred_pos[j]
            cycle_size += 1
        if cycle_size > 0:
            if weighted:
                ans += (cycle_size - 1) * abs(pred_pos[i] - i)
            else:
                ans += cycle_size - 1
    return float(ans)


def head_prediction(pred, label) -> float:
    """First-element accuracy (`metrics.py:154-162`)."""
    p, t = make_same_len(pred, label)
    return float(p[0] == t[0])


def pairwise_prediction(pred, label) -> float:
    """Fraction of ordered (i<j) pairs of the prediction that agree with the
    ground truth's pair set (`metrics.py:163-181`)."""
    p, t = make_same_len(pred, label)
    gt_pairs = set()
    for j in range(len(t)):
        for k in range(j + 1, len(t)):
            gt_pairs.add((t[j], t[k]))
    hit = 0.0
    for j in range(len(p)):
        for k in range(j + 1, len(p)):
            if (p[j], p[k]) in gt_pairs:
                hit += 1.0
    return hit / float(len(gt_pairs))


_SINGLE = {
    "tau": kendall_tau,
    "partial_match": partial_match,
    "exact_match": exact_match,
    "longest_common_subsequence": lcs,
    "lcs": lcs,
    "longest_common_substring": lcs_substr,
    "lcs_substr": lcs_substr,
    "ms": lambda p, t: min_swaps(p, t, weighted=False),
    "wms": lambda p, t: min_swaps(p, t, weighted=True),
    "head_prediction": head_prediction,
    "pairwise_prediction": pairwise_prediction,
}


def compute_metrics(args, metric: str, preds: List, labels: List):
    """Batch-mean metric dispatch (`metrics.py:58-186`).

    `args` only needs `.max_story_length` (distance_based) and
    `.multiref_metrics` (multi-reference labels); pass None otherwise.
    Multi-reference labels (ndim > 1) route through `multiref_metrics`.
    """
    assert len(preds) == len(labels), (
        f"Predictions and labels have mismatched lengths "
        f"{len(preds)} and {len(labels)}")

    if np.asarray(labels[0]).ndim > 1:
        res = multiref_metrics(args, preds, labels)
        return res[metric]

    if metric == "distance_based":
        msl = getattr(args, "max_story_length", 5) if args is not None else 5
        fn = lambda p, t: distance_based(p, t, max_story_length=msl)
    else:
        try:
            fn = _SINGLE[metric]
        except KeyError:
            raise NotImplementedError(
                f"Metric {metric} is not implemented yet.")
    acc = sum(float(fn(preds[i], labels[i])) for i in range(len(preds)))
    return acc / len(preds)


def multiref_metrics(args, preds, labels):
    """Lexicographic-max multi-reference scoring (`metrics.py:21-55`).

    For each prediction, score the METRICS tuple against every reference,
    sort tuples descending, keep the max tuple; average per-metric over the
    batch. Only mode "max" exists in the reference.
    """
    mode = getattr(args, "multiref_metrics", "max") if args is not None else "max"
    if mode != "max":
        raise NotImplementedError(
            f"Can't deal with multiref metric: {mode} yet!")
    res = {m: 0.0 for m in METRICS}
    for i in range(len(preds)):
        pred = preds[i]
        metric_list = []
        for ref in labels[i]:
            p, t = make_same_len(list(pred), list(ref))
            tup = [compute_metrics(args, m, [p], [t]) for m in METRICS]
            metric_list.append(tup)
        metric_list.sort(reverse=True)
        best = metric_list[0]
        for k, m in enumerate(METRICS):
            res[m] += best[k]
    for m in METRICS:
        res[m] /= len(preds)
    return res
