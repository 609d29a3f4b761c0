"""Processor registry keyed `{data_name}_{task_type}` (copy of
`data/registry.py`): data names {roc, vist, recipeqa, mpii_movie, wikihow}
x task types {pairwise, head, sort, abductive, pure_class, pure_decode,
pretrain, hl_v1, retrieve}. WikiHow and RecipeQA have processors; roc,
vist and mpii_movie have none, in the JAX package too, and raise."""

from __future__ import annotations

from .recipeqa import (RecipeQAAbductiveProcessor, RecipeQAGeneralProcessor,
                       RecipeQAPairWiseProcessor)
from .wikihow import (WikiHowAbductiveProcessor, WikiHowGeneralProcessor,
                      WikiHowPairWiseProcessor)

DATA_NAMES = ["roc", "vist", "recipeqa", "mpii_movie", "wikihow"]

TASK_TYPES = {
    "pairwise": "pairwise",
    "head": "general",
    "sort": "general",
    "abductive": "abductive",
    "pure_class": "general",
    "pure_decode": "general",
    "pretrain": "general",
    "hl_v1": "general",
    "retrieve": "general",
}

_PROCESSORS = {
    ("wikihow", "pairwise"): WikiHowPairWiseProcessor,
    ("wikihow", "abductive"): WikiHowAbductiveProcessor,
    ("wikihow", "general"): WikiHowGeneralProcessor,
    ("recipeqa", "pairwise"): RecipeQAPairWiseProcessor,
    ("recipeqa", "abductive"): RecipeQAAbductiveProcessor,
    ("recipeqa", "general"): RecipeQAGeneralProcessor,
}

data_processors = {f"{data}_{task}": _PROCESSORS.get((data, kind))
                   for data in DATA_NAMES for task, kind in TASK_TYPES.items()}


def get_processor(task_name: str, **kwargs):
    """The processor of `{data}_{tasktype}` with the processor keyword
    arguments (data_dir, order_criteria, story lengths, caption_transforms,
    version_text, pure_class, paired_with_image, ...)."""
    cls = data_processors.get(task_name)
    if cls is None:
        raise NotImplementedError(
            f"Task {task_name} has no shipped processor (available: "
            f"{sorted(k for k, v in data_processors.items() if v)})")
    return cls(**kwargs)
