"""The inputs of a step or an eval batch, worked out again from the raw
stories: which stories a batch holds, how each is scrambled, its tokens,
its packed row, its gold order and its heat-map target.

These follow the published conventions of the sequencer's data path:
  * the word tokenizer: words and punctuation (`\\w+|[^\\w\\s]`), each word
    an id of a hash vocabulary (blake2s of the lowercased word, modulo the
    vocabulary past the five special ids), RoBERTa's special ids (cls 0,
    pad 1, sep 2);
  * a step is `[cls] words [sep]`, cut to `per_seq_max_length` with its
    sep kept; a story is its steps concatenated, cut to `max_seq_length`
    and padded, each token typed by its step index;
  * the loader's order of an epoch is a Philox permutation keyed by
    (seed, epoch); a story's scramble a Philox shuffle keyed by
    (seed, epoch, index); the gold order is the argsort of the scramble.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence

import numpy as np

CLS_ID, PAD_ID, SEP_ID = 0, 1, 2
NUM_SPECIAL = 5
_WORD_RE = re.compile(r"\w+|[^\w\s]")


def word_id(word: str, vocab_size: int) -> int:
    h = int.from_bytes(hashlib.blake2s(word.lower().encode(),
                                       digest_size=8).digest(), "little")
    return NUM_SPECIAL + h % (vocab_size - NUM_SPECIAL)


def step_ids(text: str, per_seq_max_length: int, vocab_size: int
             ) -> np.ndarray:
    ids = [CLS_ID] + [word_id(w, vocab_size)
                      for w in _WORD_RE.findall(text)] + [SEP_ID]
    if len(ids) > per_seq_max_length:
        ids = ids[:per_seq_max_length - 1] + [SEP_ID]
    return np.asarray(ids, dtype=np.int64)


def pack(texts: Sequence[str], max_seq_length: int, per_seq_max_length: int,
         vocab_size: int):
    """(input_ids, attention_mask, token_type_ids) of one story."""
    steps = [step_ids(t, per_seq_max_length, vocab_size) for t in texts]
    ids = np.full(max_seq_length, PAD_ID, dtype=np.int64)
    types = np.zeros(max_seq_length, dtype=np.int64)
    cat = np.concatenate(steps)
    typ = np.concatenate([np.full(len(s), i) for i, s in enumerate(steps)])
    n = min(max_seq_length, len(cat))
    ids[:n], types[:n] = cat[:n], typ[:n]
    return ids, (ids != PAD_ID).astype(np.int64), types


def _philox(key: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=np.uint64(key)))


def epoch_order(n_stories: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n_stories)
    _philox((seed << 32) ^ epoch).shuffle(order)
    return order


def scramble(n_steps: int, seed: int, epoch: int, idx: int) -> np.ndarray:
    perm = np.arange(n_steps)
    _philox((seed << 32) ^ (epoch << 20) ^ idx).shuffle(perm)
    return perm


def story_inputs(stories: List[List[str]], picks, seed: int, cfg: Dict,
                 images=None) -> Dict[str, np.ndarray]:
    """The packed rows of the stories `picks` = [(epoch, index), ...], each
    scrambled as the loader scrambles it, with the gold orders (`labels`)
    and, given the pool's (stories, steps, H, W, 3) uint8 `images`, each
    story's step images in its scrambled order."""
    rows = {"input_ids": [], "attention_mask": [], "token_type_ids": [],
            "labels": []}
    imgs = []
    n = cfg["max_story_length"]
    for epoch, idx in picks:
        texts = stories[idx][:n]
        perm = scramble(len(texts), seed, epoch, idx)
        ids, am, tt = pack([texts[i] for i in perm], cfg["max_seq_length"],
                           cfg["per_seq_max_length"], cfg["vocab_size"])
        rows["input_ids"].append(ids)
        rows["attention_mask"].append(am)
        rows["token_type_ids"].append(tt)
        rows["labels"].append(np.argsort(perm))
        if images is not None:
            imgs.append(images[idx][perm])
    out = {k: np.stack(v) for k, v in rows.items()}
    if images is not None:
        out["images"] = np.stack(imgs)
    return out


def batch_picks(n_stories: int, batch: int, seed: int, first: int,
                count: int):
    """[(epoch, index), ...] of the loader's batches `first` .. `first +
    count - 1` (each epoch a fresh order of the whole pool, the pool a
    multiple of the batch)."""
    per_epoch = n_stories // batch
    out = []
    for b in range(first, first + count):
        epoch, k = divmod(b, per_epoch)
        order = epoch_order(n_stories, seed, epoch)
        out.append([(epoch, int(i)) for i in order[k * batch:(k + 1) * batch]])
    return out


def heatmap_targets(labels: np.ndarray, soft: float = 0.1) -> np.ndarray:
    """(B, N, N): 1 for a step's immediate successor, `soft` for its later
    ones, 0 elsewhere and on the diagonal."""
    pos = np.argsort(labels, axis=1)
    pi, pj = pos[:, :, None], pos[:, None, :]
    t = np.where(pj == pi + 1, 1.0, np.where(pj > pi, soft, 0.0))
    n = labels.shape[1]
    t[:, np.arange(n), np.arange(n)] = 0.0
    return t.astype(np.float32)
