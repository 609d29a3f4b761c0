"""The sort evaluation in plain PyTorch and NumPy: heat maps of packed
stories in eval mode (no dropout, BatchNorm on its running statistics),
the `naive_v2_sum` order of a heat map (over every permutation: the chain
sum of hm[p_t, p_t+1] plus 1 - hm[p_last, p_0]), and the eight ordering
metrics of the sequencing papers (partial and exact match, longest common
substring and subsequence, Kendall's tau over pair sets, minimum swaps
plain and weighted, and the displacement distance with its reset to the
story length where a gold step is missing).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import model as M

METRICS = ("partial_match", "exact_match", "lcs_substr", "lcs", "tau", "ms",
           "wms", "distance_based")


@torch.no_grad()
def heatmaps(weights: Dict[str, torch.Tensor], cfg: Dict,
             batch: Dict[str, np.ndarray], block_rows: int = 8,
             quant=M._id) -> np.ndarray:
    """(B, N, N) f32 heat maps of the packed rows of `batch`."""
    vcfg = cfg.get("vision")
    device = next(iter(weights.values())).device
    out = []
    n = batch["input_ids"].shape[0]
    for r0 in range(0, n, block_rows):
        rows = {k: torch.from_numpy(np.asarray(v[r0:r0 + block_rows]))
                .to(device) for k, v in batch.items() if k != "labels"}
        vis = None
        if vcfg is not None:
            feats = M.rn50_tower(weights, rows["images"], vcfg, False, quant)
            vis = M.visual_tokens(weights, feats, rows["images"].shape[1],
                                  vcfg["grid"], cfg["encoder"], None, quant)
        hm, _ = M.heatmaps(weights, rows, cfg, vis, None, None, quant)
        out.append(hm.float().cpu().numpy())
    return np.concatenate(out)


def _perms(n: int) -> np.ndarray:
    return np.asarray(list(itertools.permutations(range(n))))


def naive_v2_sum_scores(hm: np.ndarray) -> np.ndarray:
    """(B, n!) scores of every order, permutations in lexicographic order."""
    n = hm.shape[-1]
    perms = _perms(n)
    hm = hm.astype(np.float64)
    chain = hm[:, perms[:, :-1], perms[:, 1:]].sum(-1)
    return chain + 1.0 - hm[:, perms[:, -1], perms[:, 0]]


def order_faults(hm: np.ndarray, orders: Sequence[Sequence[int]],
                 tol: float = 1e-5) -> int:
    """How many `orders` are not a permutation whose naive_v2_sum score on
    its heat map is within `tol` of the best."""
    n = hm.shape[-1]
    perms = _perms(n)
    index = {tuple(p): i for i, p in enumerate(perms.tolist())}
    scores = naive_v2_sum_scores(hm)
    best = scores.max(-1)
    bad = 0
    for b, o in enumerate(orders):
        i = index.get(tuple(int(x) for x in o))
        if i is None or scores[b, i] < best[b] - tol:
            bad += 1
    return bad


def _lcs(p, t):
    dp = np.zeros((len(p) + 1, len(t) + 1), dtype=np.int64)
    for i in range(1, len(p) + 1):
        for j in range(1, len(t) + 1):
            dp[i, j] = (dp[i - 1, j - 1] + 1 if p[i - 1] == t[j - 1]
                        else max(dp[i - 1, j], dp[i, j - 1]))
    return int(dp[-1, -1])


def _lcs_substr(p, t):
    best = 0
    dp = np.zeros((len(p) + 1, len(t) + 1), dtype=np.int64)
    for i in range(1, len(p) + 1):
        for j in range(1, len(t) + 1):
            if p[i - 1] == t[j - 1]:
                dp[i, j] = dp[i - 1, j - 1] + 1
                best = max(best, int(dp[i, j]))
    return best


def _tau(p, t):
    s_t = set(itertools.combinations(t, 2))
    s_p = set(itertools.combinations(p, 2))
    return 1 - 2 * (len(s_p) - len(s_p & s_t)) / (len(p) * (len(p) - 1) / 2)


def _swaps(p, t, weighted):
    pos = [p.index(x) for x in t]
    seen = [False] * len(p)
    ans = 0.0
    for i in range(len(p)):
        if seen[i] or pos[i] == i:
            continue
        size, j = 0, i
        while not seen[j]:
            seen[j] = True
            j = pos[j]
            size += 1
        ans += (size - 1) * (abs(pos[i] - i) if weighted else 1)
    return ans


def _distance(p, t, n):
    dist = 0
    for j, g in enumerate(t):
        dist = n if g not in p else dist + abs(j - p.index(g))
    return float(dist)


def metrics(preds: List[List[int]], golds: List[List[int]],
            story_length: int) -> Dict[str, float]:
    fns = {
        "partial_match": lambda p, t: float(np.mean(np.asarray(p)
                                                    == np.asarray(t))),
        "exact_match": lambda p, t: float(p == t),
        "lcs_substr": _lcs_substr, "lcs": _lcs, "tau": _tau,
        "ms": lambda p, t: _swaps(p, t, False),
        "wms": lambda p, t: _swaps(p, t, True),
        "distance_based": lambda p, t: _distance(p, t, story_length),
    }
    out = {}
    for name in METRICS:
        acc = sum(float(fns[name](list(p)[:min(len(p), len(t))],
                                  list(t)[:min(len(p), len(t))]))
                  for p, t in zip(preds, golds))
        out[name] = acc / len(preds)
    return out
