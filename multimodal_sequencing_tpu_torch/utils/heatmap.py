"""Order heatmap decoding (copy of `utils/heatmap.py::heatmap2order` and
the decoders it dispatches to): `super_naive`, `naive`/`naive_v2`/
`naive_v3` (± `_sum`), `topological`, `mst`.

The heatmap is an N x N "who-precedes-whom" score matrix: row = parent step,
col = child step. These numpy decoders run on the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .topo import Graph
from .mst import mst


def heatmap2order(heat_map, decode_method: str = "naive_v2_sum",
                  beam_size: int = 2,
                  max_story_length: Optional[int] = None) -> List[int]:
    """Decode a predicted order from an N x N heatmap
    (`train_utils.py:112-332`).

    decode_method in {super_naive, naive, naive_v2, naive_v3, naive_sum,
    naive_v2_sum, naive_v3_sum, topological, mst}. v2 replaces the last step
    probability with 1 - P(last row -> chosen head) (reversed-head
    correction); v3 takes absolute values (signed heatmaps allowed).
    """
    heat_map = np.asarray(heat_map)
    if "v3" not in decode_method:
        assert np.min(heat_map) >= 0, "heat map cannot have negative values."
    len_seq = len(heat_map)

    if decode_method == "super_naive":
        return _decode_super_naive(heat_map, len_seq)
    if "naive" in decode_method:
        return _decode_naive_beam(heat_map, len_seq, decode_method, beam_size)
    if decode_method == "topological":
        return _decode_topological(heat_map, len_seq)
    if decode_method == "mst":
        return _decode_mst(heat_map, len_seq)
    raise NotImplementedError(
        f"Heatmap decoding method: {decode_method} not found.")


def _decode_super_naive(heat_map, len_seq):
    """Greedy row-max chaining from the highest-contrast row
    (`train_utils.py:121-137`). May revisit nodes (reference behavior)."""
    max_diff = 0
    start_idx = 0
    for i in range(len_seq):
        curr_diff = np.max(heat_map[i]) - np.min(heat_map[i])
        if curr_diff > max_diff:
            max_diff = max(curr_diff, max_diff)
            start_idx = i
    pred = [start_idx]
    curr_idx = start_idx
    while len(pred) < len_seq:
        largest_idx = int(np.argsort(heat_map[curr_idx])[-1])
        pred.append(largest_idx)
        curr_idx = largest_idx
    return pred


def _decode_naive_beam(heat_map, len_seq, decode_method, beam_size):
    """Recursive beam over all start rows maximizing sum(log p) (or plain sum
    with `_sum`), reversed-head correction for v2/v3
    (`train_utils.py:139-252`)."""
    is_v2 = "v2" in decode_method
    is_v3 = "v3" in decode_method
    use_sum = "sum" in decode_method

    def recurse(curr_row, order_lists, order_curr, probs, prob_curr):
        curr_repr = heat_map[curr_row].copy()
        if len(order_curr) >= len_seq:
            if order_curr not in order_lists:
                order_lists.append(order_curr)
                if is_v2 or is_v3:
                    prob_curr = prob_curr + [curr_repr]
                probs.append(prob_curr)
            return
        visited = []
        for _beam in range(beam_size):
            init_idx = -1
            largest_idx = int(np.argsort(curr_repr)[init_idx])
            to_next = True
            while largest_idx == curr_row or largest_idx in order_curr:
                init_idx -= 1
                if init_idx * -1 > len_seq:
                    to_next = False
                    break
                largest_idx = int(np.argsort(curr_repr)[init_idx])
                if largest_idx in visited:
                    continue
            if to_next:
                next_row = largest_idx
                visited.append(next_row)
                prob_val = heat_map[curr_row][next_row]
                curr_repr[next_row] = -1.0
                recurse(next_row, order_lists, order_curr + [next_row],
                        probs, prob_curr + [prob_val])

    max_prob = None
    pred = None
    eps = 1e-8
    for i in range(len_seq):
        order_lists, probs = [], []
        recurse(i, order_lists, [i], probs, [])
        assert len(order_lists) == len(probs)
        for order_list, prob in zip(order_lists, probs):
            prob = list(prob)
            if is_v2:
                reversed_row = prob.pop()
                rp = reversed_row[order_list[0]]
                assert rp <= 1.0, "prob is > 1, sigmoid applied?"
                prob.append(1 - rp)
            elif is_v3:
                reversed_row = prob.pop()
                rp = abs(reversed_row[order_list[0]])
                assert rp <= 1.0, "prob is > 1, sigmoid applied?"
                prob.append(rp)
            if is_v3:
                prob = [abs(x) for x in prob]
            prob = np.asarray(prob, dtype=np.float64)
            if not use_sum:
                prob = np.log(prob + eps)
            total = float(np.sum(prob))
            if max_prob is None or total > max_prob:
                max_prob = total
                pred = order_list

    if len(set(pred)) != len_seq:
        raise ValueError(f"The decoded order is not valid: {pred}")
    return pred


def _decode_topological(heat_map, len_seq, thres: float = 0.2):
    """Threshold upper-triangle entries into directed edges, topo-sort
    (`train_utils.py:254-274`)."""
    graph = Graph(len_seq)
    for i in range(len_seq):
        for j in range(len_seq):
            if i < j:
                if heat_map[i][j] > thres:
                    graph.addEdge(i, j)
                else:
                    graph.addEdge(j, i)
    pred = graph.topologicalSort()
    if len(set(pred)) != len_seq:
        raise ValueError(f"The decoded order is not valid: {pred}")
    return pred


def _decode_mst(heat_map, len_seq):
    """Chu-Liu-Edmonds arborescence, then topo-sort its edges
    (`train_utils.py:276-299`)."""
    graph = {i: {j: heat_map[i][j] for j in range(len_seq) if j != i}
             for i in range(len_seq)}
    tree = mst(graph)
    g = Graph(len_seq)
    for u in range(len_seq):
        for v in tree[u]:
            g.addEdge(u, v)
    return g.topologicalSort()
