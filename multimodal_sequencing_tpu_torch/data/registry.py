"""Processor registry keyed `{data_name}_{task_type}` (counterpart of
`data/registry.py`). The port ships the WikiHow whole-story processor, which
the sort evaluation, fine-tuning and pretraining read; the RecipeQA
processors and the pairwise and abductive ones come with a later slice
(ROADMAP A5) and raise."""

from __future__ import annotations

from .wikihow import WikiHowGeneralProcessor

data_processors = {"wikihow_sort": WikiHowGeneralProcessor,
                   "wikihow_pretrain": WikiHowGeneralProcessor}


def get_processor(task_name: str, **kwargs):
    cls = data_processors.get(task_name)
    if cls is None:
        raise NotImplementedError(
            f"Task {task_name} has no processor in the port yet: the "
            f"RecipeQA processors and the pairwise and abductive ones come "
            f"with a later slice (ROADMAP A5) (available: "
            f"{sorted(data_processors)})")
    return cls(**kwargs)
