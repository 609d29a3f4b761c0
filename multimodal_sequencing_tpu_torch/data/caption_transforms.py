"""Caption (step text) transformations (copy of `data/caption_transforms.py`).

`remove_1st` drops the first sentence (when there is more than one) and
`max_sentence_K` keeps the first K sentences. `select_caption_transforms`
picks the transformations of a split from `--caption_transformations`:
entries prefixed `train_` apply to the train split, `eval_` to the others,
unprefixed ones to every split.

Sentences are split by a regex (., !, ? followed by whitespace and an
upper-case letter, a digit, or an opening quote or bracket before one).
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Sequence, Union

logger = logging.getLogger(__name__)

_SENT_BOUNDARY = re.compile(r'(?<=[.!?])\s+(?=["\'(]?[A-Z0-9])')


def sent_split(text: str) -> List[str]:
    """Split text into sentences."""
    text = text.strip()
    if not text:
        return []
    return [s for s in _SENT_BOUNDARY.split(text) if s]


class CaptionTransformations:
    """An ordered pipeline of text transformations."""

    def __init__(self, args=None, task: Optional[str] = None,
                 caption_transformation_list: Optional[Sequence[str]] = None):
        if task is None:
            raise ValueError("CaptionTransformations needs a task")
        self.args = args
        self.task = task
        self.max_sentence = None
        self.transform_funcs = []
        caption_transformation_list = caption_transformation_list or []
        logger.info("Using caption transformations: %s",
                    caption_transformation_list)
        for method in caption_transformation_list:
            if method == "remove_1st":
                self.transform_funcs.append(self._remove_1st_func)
            elif "max_sentence" in method:
                self.max_sentence = int(method.split("max_sentence_")[-1])
                self.transform_funcs.append(self._cap_sentence_func)
            else:
                raise NotImplementedError(
                    f"Caption transformation method: {method} not done yet!")

    def transform(self, captions: Union[str, Sequence[str]]):
        if isinstance(captions, str):
            return self.transform_single_caption(captions)
        return [self.transform_single_caption(c) for c in captions]

    def transform_single_caption(self, caption: str) -> str:
        for fn in self.transform_funcs:
            caption = fn(caption)
        return caption

    def _cap_sentence_func(self, caption: str) -> str:
        return " ".join(sent_split(caption)[:self.max_sentence])

    def _remove_1st_func(self, caption: str) -> str:
        sents = sent_split(caption)
        if len(sents) > 1:
            return " ".join(sents[1:])
        return caption


def select_caption_transforms(args, task: str, split: str
                              ) -> Optional[CaptionTransformations]:
    """The transformations of `split` from `args.caption_transformations`
    (None when there are none)."""
    spec = getattr(args, "caption_transformations", None)
    if not spec:
        return None
    prefix = "train_" if split == "train" else "eval_"
    chosen = []
    for item in spec:
        if item.startswith("train_") or item.startswith("eval_"):
            if item.startswith(prefix):
                chosen.append(item[len(prefix):])
        else:
            chosen.append(item)
    if not chosen:
        return None
    return CaptionTransformations(
        args, task, caption_transformation_list=chosen)
