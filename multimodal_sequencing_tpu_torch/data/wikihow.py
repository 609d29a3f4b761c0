"""WikiHow whole-story processor, text only (copy of the `sort` path of
`data/wikihow.py`): JSONL parsing, `human_annot_only_filtered` gating,
story length filters and multiref ground-truth passthrough."""

from __future__ import annotations

import json
import logging
import os
from typing import List

from .examples import DataProcessor, HeadExample

logger = logging.getLogger(__name__)

WIKIHOW_DATA_ROOT = "data/wikihow"


class WikiHowGeneralProcessor(DataProcessor):
    """Whole-story examples for the sort task."""

    def __init__(self, data_dir=None, max_story_length=5, min_story_length=5,
                 version_text=None, **kwargs):
        self.data_dir = data_dir or WIKIHOW_DATA_ROOT
        min_story_length = max(1, min_story_length)
        max_story_length = max(1, max_story_length)
        min_story_length = min(min_story_length, max_story_length)
        self.min_story_length = min_story_length
        self.max_story_length = max_story_length
        self.version_text = version_text
        self.multiref_gt = False

    def get_labels(self):
        return list(range(self.max_story_length))

    def _json_path(self, data_dir: str, split: str) -> str:
        if self.version_text is not None:
            path = os.path.join(
                data_dir, f"wikihow-{self.version_text}-{split}.json")
            if not os.path.exists(path):
                raise ValueError(f"File: {path} not found!")
            return path
        return os.path.join(data_dir, f"wikihow-{split}.json")

    def _read_json(self, data_dir=None, split="train"):
        """Read JSONL stories; each yielded story is
        [story_id, (text, None), ...] or a multiref dict wrapper."""
        data_dir = data_dir or self.data_dir
        json_path = self._json_path(data_dir, split)
        logger.info("Using %s", json_path)

        with open(json_path) as f:
            data = [json.loads(line.strip()) for line in f if line.strip()]

        human_check_dict = None
        if self.version_text == "human_annot_only_filtered":
            human_json = os.path.join(
                data_dir, "wikihow_human_studies_picked.jsonl")
            human_check_dict = {}
            with open(human_json) as hf:
                for line in hf:
                    dd = json.loads(line.strip())
                    key = dd["steps"][0]["text"].split(".")[0]
                    human_check_dict[key] = True

        story_seqs = []
        for data_raw in data:
            wikihow_url = data_raw["url"]
            if "multiref_gt" in data_raw and not self.multiref_gt:
                self.multiref_gt = True

            for section_id, section in enumerate(data_raw["sections"]):
                page_id = "###".join([wikihow_url, str(section_id)])
                story_seq = [page_id]
                include_data = human_check_dict is None

                for step in section["steps"]:
                    step_text = step["step_text"]["text"]
                    bullets = step["step_text"]["bullet_points"]
                    combined_text = " ".join([step_text] + bullets)
                    if human_check_dict is not None:
                        if combined_text.split(".")[0] in human_check_dict:
                            include_data = True
                    story_seq.append((combined_text, None))

                if len(story_seq) < self.min_story_length + 1 or not include_data:
                    continue
                story_seq = story_seq[:self.max_story_length + 1]
                curr_len = len(story_seq)
                if self.multiref_gt:
                    story_seq = {"story_seq": story_seq,
                                 "multiref_gt": data_raw["multiref_gt"]}
                if (self.min_story_length + 1 <= curr_len
                        <= self.max_story_length + 1):
                    story_seqs.append(story_seq)

        logger.info("There are %d valid story sequences in %s",
                    len(story_seqs), json_path)
        return story_seqs

    def _unwrap(self, story_seq):
        if self.multiref_gt:
            return story_seq["story_seq"], story_seq["multiref_gt"]
        return story_seq, None

    def _create_examples(self, lines) -> List[HeadExample]:
        examples = []
        for story_seq in lines:
            story_seq, multiref_gt = self._unwrap(story_seq)
            story_id, story_seq = story_seq[0], story_seq[1:]
            examples.append(HeadExample(
                guid=story_id,
                text_seq=[x[0] for x in story_seq],
                img_path_seq=[x[1] for x in story_seq],
                multiref_gt=multiref_gt))
        return examples

    def get_train_examples(self, data_dir=None):
        return self._create_examples(self._read_json(data_dir, "train"))

    def get_dev_examples(self, data_dir=None):
        return self._create_examples(self._read_json(data_dir, "dev"))

    def get_test_examples(self, data_dir=None):
        return self._create_examples(self._read_json(data_dir, "test"))
