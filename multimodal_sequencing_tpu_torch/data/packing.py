"""Story packing (copy of `data/packing.py`, numpy path only).

Each step is tokenized separately up to `per_seq_max_length`, pad tokens are
stripped, and the remaining ids are concatenated into ONE sequence of at most
`max_seq_length`, keeping every step's own CLS/SEP. `token_type_ids[t]` is
the step index of token t; `attention_mask = input_ids != pad_id`. Per-step
CLS positions are later recovered by `input_ids == cls_id`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


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
        token_type_ids) of fixed length."""
        L = max_seq_length or self.max_seq_length
        input_ids = np.full(L, self.pad_id, dtype=np.int32)
        token_type_ids = np.zeros(L, dtype=np.int32)
        if step_ids:
            cat = np.concatenate(step_ids)
            types = np.concatenate([
                np.full(len(s), i, dtype=np.int32)
                for i, s in enumerate(step_ids)])
            n = min(L, len(cat))
            input_ids[:n] = cat[:n]
            token_type_ids[:n] = types[:n]
        attention_mask = (input_ids != self.pad_id).astype(np.int32)
        return input_ids, attention_mask, token_type_ids

    def pack_story(self, texts: Sequence[str],
                   max_seq_length: Optional[int] = None):
        return self.pack(self.encode_steps(texts), max_seq_length)
