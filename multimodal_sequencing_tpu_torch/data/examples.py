"""Example dataclass and processor base (copy of `data/examples.py`,
whole-story examples only)."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Optional


class DataProcessor:
    """Base class for dataset processors."""

    def get_train_examples(self, data_dir=None):
        raise NotImplementedError()

    def get_dev_examples(self, data_dir=None):
        raise NotImplementedError()

    def get_test_examples(self, data_dir=None):
        raise NotImplementedError()

    def get_labels(self):
        raise NotImplementedError()


@dataclass
class HeadExample:
    """A whole story sequence."""
    guid: str
    text_seq: List[str]
    label: Optional[str] = None
    pairID: Optional[str] = None
    img_path_seq: Optional[List[Optional[str]]] = None
    task_id: Optional[int] = None
    multiref_gt: Optional[list] = None

    def to_json_string(self):
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"
