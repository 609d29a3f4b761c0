"""Example dataclasses and the processor base (copy of `data/examples.py`):
step pairs, step triples and whole stories."""

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
class PairWiseExample:
    """One ordered step pair."""
    guid: str
    text_a: str
    text_b: Optional[str] = None
    label: Optional[str] = None
    pairID: Optional[str] = None
    distance: Optional[int] = None
    img_path_a: Optional[str] = None
    img_path_b: Optional[str] = None
    task_id: Optional[int] = None
    multiref_gt: Optional[list] = None

    def to_json_string(self):
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"


@dataclass
class AbductiveExample:
    """A (h1, h2, h3) step triple."""
    guid: str
    text_h1: str
    text_h2: str
    text_h3: str
    label: Optional[str] = None
    pairID: Optional[str] = None
    img_path_h1: Optional[str] = None
    img_path_h2: Optional[str] = None
    img_path_h3: Optional[str] = None
    task_id: Optional[int] = None
    multiref_gt: Optional[list] = None

    def to_json_string(self):
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"


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
