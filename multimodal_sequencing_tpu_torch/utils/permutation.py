"""Permutation label codec for pure-classification ordering (copy of
`utils/permutation.py`).

A permutation's class id is its lexicographic rank among the n!
permutations of 0..n-1 (the order a next-permutation loop from the
identity enumerates them in). Rank and unrank use the factorial number
system; `build_permutation_label_maps` builds the explicit maps.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Sequence, Tuple


def permutation_rank(perm: Sequence[int]) -> int:
    """Lexicographic rank of a permutation of 0..n-1."""
    perm = list(perm)
    n = len(perm)
    rank = 0
    remaining = sorted(perm)
    for i, x in enumerate(perm):
        idx = remaining.index(x)
        rank += idx * math.factorial(n - 1 - i)
        remaining.pop(idx)
    return rank


def permutation_unrank(rank: int, n: int) -> List[int]:
    """Inverse of `permutation_rank` over permutations of 0..n-1."""
    remaining = list(range(n))
    out = []
    for i in range(n):
        idx, rank = divmod(rank, math.factorial(n - 1 - i))
        out.append(remaining.pop(idx))
    return out


def build_permutation_label_maps(
        n: int) -> Tuple[Dict[str, int], Dict[int, List[int]]]:
    """label2id ('0_1_2' -> 0) and id2label (0 -> [0, 1, 2]) over all n!
    permutations in lexicographic order."""
    label2id: Dict[str, int] = {}
    id2label: Dict[int, List[int]] = {}
    for i, perm in enumerate(itertools.permutations(range(n))):
        label2id["_".join(str(x) for x in perm)] = i
        id2label[i] = list(perm)
    return label2id, id2label
