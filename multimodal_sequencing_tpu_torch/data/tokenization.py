"""Tokenizers (copy of `data/tokenization.py`): the built-in hash-vocab
word tokenizer, and HF tokenizers from local files.

`SimpleWordTokenizer` follows RoBERTa's special-id conventions (cls=0,
pad=1, sep=2), so the packing conventions (`attention_mask = ids != 1`,
CLS gather via `ids == cls_id`) behave as with the real tokenizer. Any
other name goes to `transformers.AutoTokenizer` with local files only,
imported when it is needed; where `transformers` is not installed, that
branch raises the same `OSError` as a tokenizer that is not found.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, List

_WORD_RE = re.compile(r"\w+|[^\w\s]")


class SimpleWordTokenizer:
    CLS_ID, PAD_ID, SEP_ID, UNK_ID, MASK_ID = 0, 1, 2, 3, 4
    _NUM_SPECIAL = 5

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size
        self.cls_token, self.pad_token = "<s>", "<pad>"
        self.sep_token, self.unk_token, self.mask_token = (
            "</s>", "<unk>", "<mask>")
        self._special = {
            self.cls_token: self.CLS_ID, self.pad_token: self.PAD_ID,
            self.sep_token: self.SEP_ID, self.unk_token: self.UNK_ID,
            self.mask_token: self.MASK_ID}

    @property
    def cls_token_id(self):
        return self.CLS_ID

    @property
    def pad_token_id(self):
        return self.PAD_ID

    @property
    def sep_token_id(self):
        return self.SEP_ID

    @property
    def mask_token_id(self):
        return self.MASK_ID

    def __len__(self):
        return self.vocab_size

    def _word_id(self, word: str) -> int:
        if word in self._special:
            return self._special[word]
        h = int.from_bytes(
            hashlib.blake2s(word.lower().encode(), digest_size=8).digest(),
            "little")
        return self._NUM_SPECIAL + h % (self.vocab_size - self._NUM_SPECIAL)

    def tokenize(self, text: str) -> List[str]:
        return _WORD_RE.findall(text)

    def _encode_one(self, text: str, max_length: int, padding: str,
                    truncation: bool) -> List[int]:
        ids = [self.CLS_ID] + [
            self._word_id(w) for w in self.tokenize(text)] + [self.SEP_ID]
        if truncation and max_length is not None and len(ids) > max_length:
            ids = ids[:max_length - 1] + [self.SEP_ID]
        if padding == "max_length" and max_length is not None:
            ids = ids + [self.PAD_ID] * (max_length - len(ids))
        return ids

    def __call__(self, text, max_length=None, padding=False, truncation=False,
                 return_token_type_ids=False, **kw) -> Dict[str, list]:
        if isinstance(text, str):
            ids = self._encode_one(text, max_length, padding, truncation)
            out = {"input_ids": ids,
                   "attention_mask": [int(i != self.PAD_ID) for i in ids]}
            if return_token_type_ids:
                out["token_type_ids"] = [0] * len(ids)
            return out
        encs = [self._encode_one(t, max_length, padding, truncation)
                for t in text]
        out = {"input_ids": encs,
               "attention_mask": [[int(i != self.PAD_ID) for i in e]
                                  for e in encs]}
        if return_token_type_ids:
            out["token_type_ids"] = [[0] * len(e) for e in encs]
        return out

    def save_pretrained(self, path):
        """Write `simple_tokenizer.json` into `path`, as the JAX package
        does, so that `load_tokenizer(path)` gives this tokenizer back."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "simple_tokenizer.json"), "w") as f:
            json.dump({"type": "SimpleWordTokenizer",
                       "vocab_size": self.vocab_size}, f)

    @classmethod
    def from_pretrained(cls, path):
        cfg = os.path.join(path, "simple_tokenizer.json")
        if os.path.exists(cfg):
            with open(cfg) as f:
                return cls(vocab_size=json.load(f)["vocab_size"])
        return cls()


def load_tokenizer(name_or_path: str):
    """A SimpleWordTokenizer for names starting with 'simple' or a
    directory holding `simple_tokenizer.json`; else an HF tokenizer from a
    local directory or cache (no download)."""
    if name_or_path.startswith("simple"):
        return SimpleWordTokenizer()
    if os.path.isdir(name_or_path) and os.path.exists(
            os.path.join(name_or_path, "simple_tokenizer.json")):
        return SimpleWordTokenizer.from_pretrained(name_or_path)
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(
            name_or_path, local_files_only=True)
    except Exception as e:
        raise OSError(
            f"Tokenizer '{name_or_path}' not available locally (offline "
            f"environment). Pass a local tokenizer directory or 'simple' "
            f"for the built-in word tokenizer.") from e
