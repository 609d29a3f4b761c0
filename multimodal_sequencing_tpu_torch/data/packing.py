"""Story packing (copy of `data/packing.py`: story packs, step pairs and
BERSON's pair expansion).

Each step is tokenized separately up to `per_seq_max_length`, pad tokens are
stripped, and the remaining ids are concatenated into ONE sequence of at most
`max_seq_length`, keeping every step's own CLS/SEP. `token_type_ids[t]` is
the step index of token t; `attention_mask = input_ids != pad_id`. Per-step
CLS positions are later recovered by `input_ids == cls_id`. The native
packer (`data/_native.py`) packs when it is built; `pack_numpy` otherwise,
with the same outputs.

`pack_all_pairs` packs every ordered pair (i, j), i != j, of a story's
steps, i-major, as one (P, L) batch (the pairwise sort methods' queries).
`pack_berson_story` expands a story into BERSON's N(N-1) ordered step
pairs at the static layout of `berson_pairs`: every (i < j), then their
reverses, each pair [steps_i ; steps_j] cut at L = 2 * per_seq_max_length.
A story shorter than `max_story_length` keeps the same layout: a pair that
touches a dead step is an all-pad row with label 0, and `ground_truth` is
padded with the dead step indices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import _native


def pack_numpy(step_ids: Sequence[np.ndarray], L: int, pad_id: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(input_ids, token_type_ids) of length L: the steps' ids concatenated
    and cut at L, each token typed by its step index, then pad_id / 0."""
    input_ids = np.full(L, pad_id, dtype=np.int32)
    token_type_ids = np.zeros(L, dtype=np.int32)
    if step_ids:
        cat = np.concatenate(step_ids)
        types = np.concatenate([
            np.full(len(s), i, dtype=np.int32)
            for i, s in enumerate(step_ids)])
        n = min(L, len(cat))
        input_ids[:n] = cat[:n]
        token_type_ids[:n] = types[:n]
    return input_ids, token_type_ids


def berson_pairs(n: int) -> np.ndarray:
    """BERSON's static pair list: all (i < j) combinations, then their
    reverses."""
    one = [[i, j] for i in range(n) for j in range(i + 1, n)]
    return np.asarray(one + [[j, i] for i, j in one], dtype=np.int32).reshape(
        -1, 2)


def pack_berson_numpy(step_ids: Sequence[np.ndarray], order_label: List[int],
                      n: int, L: int, pad_id: int):
    """(input_ids (P, L), sep_positions (P, 2), pairwise_labels (P,),
    true_pairs) of a story of len(step_ids) <= n steps over the pairs of
    `berson_pairs(n)`. sep_positions = [len_i - 1, len_pair - 1] ([0, 1]
    for a dead pair); the label of (i, j) is 1 iff i comes before j in the
    chain `order_label`."""
    m = len(step_ids)
    pairs = berson_pairs(n)
    pos = {s: order_label.index(s) for s in range(m)}
    P = len(pairs)
    input_ids = np.full((P, L), pad_id, dtype=np.int32)
    sep_positions = np.zeros((P, 2), dtype=np.int32)
    pairwise_labels = np.zeros((P,), dtype=np.int32)
    true_pairs = 0
    for p, (i, j) in enumerate(pairs.tolist()):
        if i >= m or j >= m:
            sep_positions[p] = [0, 1]  # harmless span for dead pairs
            continue
        true_pairs += 1
        a, b_ = step_ids[i], step_ids[j]
        cat = np.concatenate([a, b_])[:L]
        input_ids[p, :len(cat)] = cat
        sep_positions[p] = [len(a) - 1, min(len(a) + len(b_), L) - 1]
        pairwise_labels[p] = int(pos[i] < pos[j])
    return input_ids, sep_positions, pairwise_labels, true_pairs


class StoryPacker:
    def __init__(self, tokenizer, max_seq_length: int,
                 per_seq_max_length: int = 32, cache_size: int = 1 << 20):
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.per_seq_max_length = per_seq_max_length
        self.pad_id = tokenizer.pad_token_id
        self.cls_id = tokenizer.cls_token_id
        self.sep_id = tokenizer.sep_token_id
        self._cache: Dict[str, np.ndarray] = {}
        self._cache_size = cache_size

    def encode_step(self, text: str) -> np.ndarray:
        """Unpadded token ids for one step, truncated to per_seq_max_length."""
        ids = self._cache.get(text)
        if ids is None:
            enc = self.tokenizer(
                text, max_length=self.per_seq_max_length,
                padding="max_length", truncation=True)
            arr = np.asarray(enc["input_ids"], dtype=np.int32)
            ids = arr[arr != self.pad_id]
            if len(self._cache) < self._cache_size:
                self._cache[text] = ids
        return ids

    def encode_steps(self, texts: Sequence[str]) -> List[np.ndarray]:
        return [self.encode_step(t) for t in texts]

    def pack(self, step_ids: Sequence[np.ndarray],
             max_seq_length: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenate per-step id arrays into (input_ids, attention_mask,
        token_type_ids) of fixed length, with the native packer when it is
        built."""
        L = max_seq_length or self.max_seq_length
        nat = _native.pack_story(step_ids, L, self.pad_id) if step_ids \
            else None
        input_ids, token_type_ids = nat if nat is not None else pack_numpy(
            step_ids, L, self.pad_id)
        attention_mask = (input_ids != self.pad_id).astype(np.int32)
        return input_ids, attention_mask, token_type_ids

    def pack_story(self, texts: Sequence[str],
                   max_seq_length: Optional[int] = None):
        return self.pack(self.encode_steps(texts), max_seq_length)

    def pack_pair(self, text_a: str, text_b: str,
                  max_seq_length: Optional[int] = None):
        """A two-step pack (pairwise training and the all-pairs queries)."""
        return self.pack([self.encode_step(text_a), self.encode_step(text_b)],
                         max_seq_length)

    def pack_all_pairs(self, texts: Sequence[str],
                       max_pair_len: Optional[int] = None):
        """All n (n - 1) ordered pairs of a story as (input_ids,
        attention_mask, token_type_ids) of (P, L) and the (i, j) index list
        (P, 2), i-major, skipping i == j; natively when the packer is
        built."""
        n = len(texts)
        step_ids = self.encode_steps(texts)
        L = max_pair_len or self.max_seq_length
        nat = _native.pack_all_pairs(step_ids, L, self.pad_id)
        if nat is not None:
            input_ids, types, idx = nat
            return (input_ids, (input_ids != self.pad_id).astype(np.int32),
                    types, idx)
        idx = [(i, j) for i in range(n) for j in range(n) if i != j]
        packs = [self.pack([step_ids[i], step_ids[j]], L) for i, j in idx]
        return (np.stack([p[0] for p in packs]),
                np.stack([p[1] for p in packs]),
                np.stack([p[2] for p in packs]),
                np.asarray(idx, dtype=np.int32).reshape(-1, 2))

    def pack_berson_story(self, texts: Sequence[str],
                          order_label: Sequence[int],
                          max_story_length: Optional[int] = None
                          ) -> Dict[str, np.ndarray]:
        """BERSON's pair expansion of one story (`texts` in the order of
        its step indices, `order_label` the chain) at P = N(N-1) pairs of
        L = 2 * per_seq_max_length tokens, N = `max_story_length` (default:
        the story's length). Token types are all 0 (RoBERTa). A whole story
        packs natively when the packer is built."""
        m = len(texts)
        n = max_story_length or m
        if m > n:
            raise ValueError(f"berson packing: a story of {m} steps is "
                             f"longer than max_story_length {n}")
        step_ids = self.encode_steps(texts)
        L = 2 * self.per_seq_max_length
        order_label = list(order_label)
        nat = (_native.pack_berson(step_ids, order_label, L, self.pad_id)
               if m == n else None)
        if nat is not None:
            input_ids, sep_positions, pairwise_labels, _ = nat
            true_pairs = len(input_ids)
        else:
            input_ids, sep_positions, pairwise_labels, true_pairs = \
                pack_berson_numpy(step_ids, order_label, n, L, self.pad_id)
        mask_cls = np.zeros((n,), dtype=np.int32)
        mask_cls[:m] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": (input_ids != self.pad_id).astype(np.int32),
            "token_type_ids": np.zeros_like(input_ids),
            "sep_positions": sep_positions,
            "pairs_list": berson_pairs(n),
            "pairwise_labels": pairwise_labels,
            "ground_truth": np.asarray(order_label + list(range(m, n)),
                                       dtype=np.int32),
            "mask_cls": mask_cls,
            "passage_length": np.int32(m),
            "pairs_num": np.int32(true_pairs),
        }
