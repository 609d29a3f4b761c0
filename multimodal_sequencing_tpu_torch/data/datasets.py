"""Sort dataset and batching, text only (copy of `data/datasets.py`:
`SortDataset`, `collate`, `data_loader`).

Every example draws its scramble from a counter-based Philox key
(seed, epoch, index), so the port scrambles exactly as the JAX package.
Batches collate into dense numpy dicts with a `valid` mask, so the final
partial batch is padded instead of dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from .packing import StoryPacker


def _example_rng(seed: Optional[int], epoch: int, idx: int
                 ) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=np.uint64(((seed or 0) << 32)
                                       ^ (epoch << 20) ^ idx)))


class SortDataset:
    """Decode-time dataset: raw step texts + order labels."""

    def __init__(self, examples, tokenizer, max_length=None,
                 per_seq_max_length=32, max_story_length=5, seed=None):
        self.examples = examples
        self.seed = seed
        self.max_story_length = max(1, max_story_length)
        self.packer = StoryPacker(tokenizer, max_length or 512,
                                  per_seq_max_length)

    def __len__(self):
        return len(self.examples)

    def _story(self, idx: int, epoch: int = 0):
        """Return (texts, idx_seq) after clamp + scramble."""
        ex = self.examples[idx]
        texts = list(ex.text_seq[:self.max_story_length])
        n = len(texts)
        idx_seq = np.arange(n)
        _example_rng(self.seed, epoch, idx).shuffle(idx_seq)
        return [texts[i] for i in idx_seq], idx_seq

    def __getitem__(self, idx, epoch: int = 0):
        texts, idx_seq = self._story(idx, epoch)
        ex = self.examples[idx]
        return {
            "texts": texts,
            "labels": _decode_labels(ex, idx_seq, self.max_story_length),
            "guid": ex.guid,
        }


def _decode_labels(ex, idx_seq, max_story_length):
    """Order label(s) for decode: argsort of the scramble, or the scrambled
    multiref list."""
    if getattr(ex, "multiref_gt", None) is not None:
        multiref = ex.multiref_gt
        assert len(multiref) >= 1 and isinstance(multiref, list)
        offset = min(multiref[0])
        multiref = [[x - offset for x in y] for y in multiref]
        assert list(range(max_story_length)) in multiref, (
            f"Forgot the original 12345 GT for data: {ex.guid}?")
        multiref = sorted(multiref)
        assert list(range(max_story_length)) == multiref[0]
        scrambled = [[x[i] for i in idx_seq] for x in multiref]
        return np.asarray([np.argsort(np.asarray(x)) for x in scrambled],
                          dtype=np.int32)
    return np.argsort(np.asarray(idx_seq)).astype(np.int32)


_ARRAY_KEYS = ("input_ids", "attention_mask", "token_type_ids", "labels")


def collate(items: Sequence[Dict[str, Any]], pad_to: Optional[int] = None
            ) -> Dict[str, Any]:
    """Stack example dicts into a dense batch. `pad_to` pads the batch to a
    static size by repeating the last example and marks them invalid in the
    returned `valid` mask."""
    n = len(items)
    total = pad_to or n
    valid = np.zeros(total, dtype=bool)
    valid[:n] = True
    padded = list(items) + [items[-1]] * (total - n)
    batch: Dict[str, Any] = {"valid": valid}
    for key in padded[0]:
        vals = [it[key] for it in padded]
        stackable = key in _ARRAY_KEYS and (
            isinstance(vals[0], np.ndarray) or np.isscalar(vals[0])
            or isinstance(vals[0], (np.integer, np.floating)))
        if stackable:
            shapes = {np.asarray(v).shape for v in vals}
            if len(shapes) == 1:
                batch[key] = np.stack([np.asarray(v) for v in vals])
            else:  # ragged (e.g. multiref labels) stays a list
                batch[key] = vals
        else:
            batch[key] = vals
    return batch


def data_loader(dataset, batch_size: int):
    """Deterministic host loader yielding collated numpy batches in dataset
    order, the last one padded to `batch_size`."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i]
                 for i in range(start, min(start + batch_size, len(dataset)))]
        yield collate(items, pad_to=batch_size)
