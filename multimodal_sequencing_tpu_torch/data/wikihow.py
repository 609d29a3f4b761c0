"""WikiHow instructional-story processors (copy of `data/wikihow.py`):
JSONL parsing, step images resolved across the mirror directory layouts
with the missing ones logged to `missing_images_{split}.txt`,
`human_annot_only_filtered` gating, caption transformations, story length
filters, multiref ground-truth passthrough, and the three example kinds:
ordered step pairs (`WikiHowPairWiseProcessor`, labelled by
`order_criteria`: `tight` marks only j == i + 1 ordered, `loose` every
j > i), step triples (`WikiHowAbductiveProcessor`) and whole stories
(`WikiHowGeneralProcessor`).

With `paired_with_image` (the default, as in the JAX package; the CLIs pass
`--multimodal`) a step whose image cannot be resolved is dropped, and a
story left shorter than `min_story_length` with it."""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

from .examples import (AbductiveExample, DataProcessor, HeadExample,
                       PairWiseExample)

logger = logging.getLogger(__name__)

WIKIHOW_DATA_ROOT = "data/wikihow"

# the step-image fields, in order of preference
IMAGE_FIELD_NAMES = ["image-large", "image-src-1"]


class WikiHowPairWiseProcessor(DataProcessor):
    """Ordered and unordered step pairs; the base of the other two."""

    def __init__(self, data_dir=None, order_criteria="tight",
                 paired_with_image=True, min_story_length=5,
                 max_story_length=5, caption_transforms=None,
                 version_text=None, **kwargs):
        self.data_dir = data_dir or WIKIHOW_DATA_ROOT
        if order_criteria not in ("tight", "loose"):
            raise ValueError(f"order_criteria {order_criteria!r}: tight or "
                             f"loose")
        self.order_criteria = order_criteria
        self.paired_with_image = paired_with_image
        min_story_length = max(1, min_story_length)
        max_story_length = max(1, max_story_length)
        min_story_length = min(min_story_length, max_story_length)
        self.min_story_length = min_story_length
        self.max_story_length = max_story_length
        self.caption_transforms = caption_transforms
        self.version_text = version_text
        self.multiref_gt = False

    def get_labels(self):
        return ["unordered", "ordered"]  # 0: unordered, 1: ordered

    def _json_path(self, data_dir: str, split: str) -> str:
        if self.version_text is not None:
            path = os.path.join(
                data_dir, f"wikihow-{self.version_text}-{split}.json")
            if not os.path.exists(path):
                raise ValueError(f"File: {path} not found!")
            return path
        return os.path.join(data_dir, f"wikihow-{split}.json")

    def _resolve_image(self, data_dir: str, image_path: str) -> Optional[str]:
        """The step image's path in the `www.wikihow.com/images/` or
        `wikihow.com/images/` mirror layout, whichever exists; else None."""
        image_path = os.path.join(data_dir, image_path)
        if "wikihow.com" not in image_path:
            cand = image_path.replace("/images/", "/www.wikihow.com/images/")
        else:
            cand = image_path
        if os.path.exists(cand):
            return cand
        cand = image_path.replace("/images/", "/wikihow.com/images/")
        if os.path.exists(cand):
            return cand
        return None

    def _step_element(self, data_dir, step, text, key, missing):
        """(text, image path) of a step, or None when it is paired with an
        image that cannot be resolved (each failed field is logged in
        `missing`)."""
        if not self.paired_with_image:
            return (text, None)
        for name in IMAGE_FIELD_NAMES:
            if name not in step.get("step_assets", {}):
                continue
            raw = step["step_assets"][name]
            resolved = (self._resolve_image(data_dir, raw)
                        if raw is not None and len(raw) > 0 else None)
            if resolved is None:
                missing.append(key)
            else:
                return (text, resolved)
        return None

    def _read_json(self, data_dir=None, split="train"):
        """Read JSONL stories; each yielded story is
        [story_id, (text, img_path or None), ...] or a multiref dict
        wrapper."""
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
        missing_images = []
        for data_raw in data:
            wikihow_url = data_raw["url"]
            if "multiref_gt" in data_raw and not self.multiref_gt:
                self.multiref_gt = True

            for section_id, section in enumerate(data_raw["sections"]):
                page_id = "###".join([wikihow_url, str(section_id)])
                story_seq = [page_id]
                include_data = human_check_dict is None

                for step_id, step in enumerate(section["steps"]):
                    step_text = step["step_text"]["text"]
                    bullets = step["step_text"]["bullet_points"]
                    combined_text = " ".join([step_text] + bullets)
                    if human_check_dict is not None:
                        if combined_text.split(".")[0] in human_check_dict:
                            include_data = True
                    if self.caption_transforms is not None:
                        combined_text = self.caption_transforms.transform(
                            combined_text)
                    element = self._step_element(
                        data_dir, step, combined_text,
                        page_id + "###" + str(step_id), missing_images)
                    if element is not None:
                        story_seq.append(element)

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

        logger.warning("Number of missing images in %s: %d",
                       split, len(missing_images))
        try:
            miss_path = os.path.join(data_dir, f"missing_images_{split}.txt")
            with open(miss_path, "w") as mf:
                mf.writelines(p + "\n" for p in missing_images)
            logger.info("Missing-image log saved at: %s", miss_path)
        except OSError:
            pass  # read-only data dirs are fine
        logger.info("There are %d valid story sequences in %s",
                    len(story_seqs), json_path)
        return story_seqs

    def _unwrap(self, story_seq):
        if self.multiref_gt:
            return story_seq["story_seq"], story_seq["multiref_gt"]
        return story_seq, None

    def _create_examples(self, lines) -> List[PairWiseExample]:
        return pair_examples(self, lines)

    def get_train_examples(self, data_dir=None):
        return self._create_examples(self._read_json(data_dir, "train"))

    def get_dev_examples(self, data_dir=None):
        return self._create_examples(self._read_json(data_dir, "dev"))

    def get_test_examples(self, data_dir=None):
        return self._create_examples(self._read_json(data_dir, "test"))


class WikiHowAbductiveProcessor(WikiHowPairWiseProcessor):
    """(h1, h2, h3) step triples: for each window (i, i+1, i+2) of a story,
    one negative (i, k, i+1) for each step k outside it, then the window
    itself as the positive."""

    def __init__(self, data_dir=None, pred_method="binary",
                 paired_with_image=True, min_story_length=5,
                 max_story_length=5, caption_transforms=None,
                 version_text=None, **kwargs):
        super().__init__(data_dir=data_dir, order_criteria="tight",
                         paired_with_image=paired_with_image,
                         min_story_length=min_story_length,
                         max_story_length=max_story_length,
                         caption_transforms=caption_transforms,
                         version_text=version_text)
        if pred_method not in ("binary", "contrastive"):
            raise ValueError(f"pred_method {pred_method!r}: binary or "
                             f"contrastive")
        self.pred_method = pred_method

    def _create_examples(self, lines) -> List[AbductiveExample]:
        return abductive_examples(self, lines)


class WikiHowGeneralProcessor(WikiHowPairWiseProcessor):
    """Whole-story examples for the head, sort, pure_class, pretrain and
    hl_v1 tasks."""

    def __init__(self, data_dir=None, max_story_length=5, pure_class=False,
                 paired_with_image=True, min_story_length=5,
                 caption_transforms=None, version_text=None, **kwargs):
        super().__init__(data_dir=data_dir, order_criteria="tight",
                         paired_with_image=paired_with_image,
                         min_story_length=min_story_length,
                         max_story_length=max_story_length,
                         caption_transforms=caption_transforms,
                         version_text=version_text)
        self.pure_class = pure_class

    def get_labels(self):
        return general_labels(self)

    def _create_examples(self, lines) -> List[HeadExample]:
        return story_examples(self, lines)


def pair_examples(proc, lines) -> List[PairWiseExample]:
    """Every ordered pair (i, j), i != j, of each story of
    `proc._read_json`, i-major, labelled by `proc.order_criteria`."""
    examples = []
    for story_seq in lines:
        story_seq, multiref_gt = proc._unwrap(story_seq)
        story_id, story_seq = story_seq[0], story_seq[1:]
        n = len(story_seq)
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                if proc.order_criteria == "tight":
                    label = "ordered" if j == i + 1 else "unordered"
                else:
                    label = "ordered" if j > i else "unordered"
                examples.append(PairWiseExample(
                    guid=f"{story_id}_{i+1}{j+1}",
                    text_a=story_seq[i][0], text_b=story_seq[j][0],
                    label=label,
                    img_path_a=story_seq[i][1],
                    img_path_b=story_seq[j][1],
                    distance=abs(j - i), multiref_gt=multiref_gt))
    return examples


def general_labels(proc) -> list:
    """A whole-story processor's labels: one per permutation of
    `max_story_length` steps with `pure_class`, else one per step."""
    if proc.pure_class:
        fact = 1
        for i in range(1, proc.max_story_length + 1):
            fact *= i
        return [0] * fact
    return list(range(proc.max_story_length))


def story_examples(proc, lines) -> List[HeadExample]:
    """One `HeadExample` per story of `proc._read_json`."""
    examples = []
    for story_seq in lines:
        story_seq, multiref_gt = proc._unwrap(story_seq)
        story_id, story_seq = story_seq[0], story_seq[1:]
        examples.append(HeadExample(
            guid=story_id,
            text_seq=[x[0] for x in story_seq],
            img_path_seq=[x[1] for x in story_seq],
            multiref_gt=multiref_gt))
    return examples


def abductive_examples(proc, lines) -> List[AbductiveExample]:
    """The step triples of each story of `proc._read_json`: for each window
    (i, i+1, i+2), the negatives (i, k, i+1) for k outside it (in set
    order), then the window; unlabelled under `pred_method` contrastive."""
    examples = []
    for story_seq in lines:
        story_seq, multiref_gt = proc._unwrap(story_seq)
        story_id, story_seq = story_seq[0], story_seq[1:]
        n = len(story_seq)
        for i in range(n - 2):
            curr_idx = sorted(set(range(i, i + 3)))
            triples = [([curr_idx[0], k, curr_idx[1]], "unordered")
                       for k in list(set(range(n)) - set(curr_idx))]
            for abd, label in triples + [(curr_idx, "ordered")]:
                examples.append(AbductiveExample(
                    guid=f"{story_id}_{abd[0]}{abd[1]}{abd[2]}",
                    label=label if proc.pred_method == "binary" else None,
                    text_h1=story_seq[abd[0]][0],
                    text_h2=story_seq[abd[1]][0],
                    text_h3=story_seq[abd[2]][0],
                    img_path_h1=story_seq[abd[0]][1],
                    img_path_h2=story_seq[abd[1]][1],
                    img_path_h3=story_seq[abd[2]][1],
                    multiref_gt=multiref_gt))
    return examples
