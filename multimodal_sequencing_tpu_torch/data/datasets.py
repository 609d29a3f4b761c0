"""Datasets and batching, text only (copy of `data/datasets.py`:
`SortDataset`, `PureClassDataset` in decode mode, `collate`, `data_loader`,
`prefetch`).

Every example draws its scramble from a counter-based Philox key
(seed, epoch, index), and the loader its shuffle from (seed, epoch), so the
port scrambles and orders exactly as the JAX package. Batches collate into
dense numpy dicts with a `valid` mask, so the final partial batch is padded
instead of dropped.
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


class PureClassDataset:
    """Scrambled, packed stories with order labels (the JAX package's
    `PureClassDataset(decode=True)`, which the heat-map heads train on):
    input_ids / attention_mask / token_type_ids, labels = argsort of the
    scramble (or the scrambled multiref list), guid."""

    def __init__(self, examples, tokenizer, max_length=None,
                 per_seq_max_length=32, max_story_length=5, scramble=True,
                 seed=None):
        self.examples = examples
        self.scramble = scramble
        self.seed = seed
        self.max_story_length = max(1, max_story_length)
        if examples:
            self.max_story_length = min(self.max_story_length,
                                        len(examples[0].text_seq))
        self.packer = StoryPacker(tokenizer, max_length or 512,
                                  per_seq_max_length)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx, epoch: int = 0):
        ex = self.examples[idx]
        texts = list(ex.text_seq[:self.max_story_length])
        idx_seq = np.arange(len(texts))
        if self.scramble:
            _example_rng(self.seed, epoch, idx).shuffle(idx_seq)
            texts = [texts[i] for i in idx_seq]
        ii, am, tt = self.packer.pack_story(texts)
        return {"input_ids": ii, "attention_mask": am, "token_type_ids": tt,
                "labels": _decode_labels(ex, idx_seq, self.max_story_length),
                "guid": ex.guid}


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


def data_loader(dataset, batch_size: int, shuffle: bool = False,
                seed: Optional[int] = None, epoch: int = 0,
                drop_last: bool = False, pad_final: bool = True):
    """Deterministic host loader yielding collated numpy batches; with
    `shuffle` the order is a Philox permutation keyed by (seed, epoch)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.Generator(
            np.random.Philox(key=np.uint64(((seed or 0) << 32) ^ epoch))
        ).shuffle(order)
    for start in range(0, len(order), batch_size):
        sel = order[start:start + batch_size]
        if len(sel) < batch_size and drop_last:
            return
        items = [dataset.__getitem__(int(i), epoch=epoch) for i in sel]
        yield collate(items, pad_to=batch_size if pad_final else None)


def prefetch(iterator, size: int = 2):
    """Background-thread prefetcher: prepares the next host batches
    (tokenize, pack) while the device runs the current step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    err = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surface loader errors to the consumer
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item
