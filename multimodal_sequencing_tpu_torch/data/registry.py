"""Processor registry keyed `{data_name}_{task_type}` (counterpart of
`data/registry.py`). The port ships the WikiHow whole-story processor that
the sort evaluation reads; other keys raise."""

from __future__ import annotations

from .wikihow import WikiHowGeneralProcessor

data_processors = {"wikihow_sort": WikiHowGeneralProcessor}


def get_processor(task_name: str, **kwargs):
    cls = data_processors.get(task_name)
    if cls is None:
        raise NotImplementedError(
            f"Task {task_name} has no processor in the port yet "
            f"(available: {sorted(data_processors)})")
    return cls(**kwargs)
