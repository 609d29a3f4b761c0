"""RecipeQA story processors (copy of `data/recipeqa.py`).

Recipes come from `texts/{split}.json` (`{"data": [{"recipe_id",
"context": [{"id", "body"}, ...]}, ...]}`), or with a version from
`new_splits/{split}-{version}.json`; a recipe id seen twice in a file is
read once. Step images are `{recipe_id}_{step}[_{k}].jpg` under
`images/images-qa/*/images-qa/`, one pool for every split; a step's first
image is its image. With `paired_with_image` a step without an image is
dropped. A file whose records carry `multiref_gt` passes it through; then
every record of the file must carry it (one that mixes them fails, in the
JAX package too). The dev split is `val`.

`human_annotated_to_test` rewrites the splits with the human-annotated
recipes moved to test, and `output_to_tsv` dumps them as plain text.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import random
import re
from typing import List

from .examples import (AbductiveExample, DataProcessor, HeadExample,
                       PairWiseExample)
from .wikihow import (abductive_examples, general_labels, pair_examples,
                      story_examples)

logger = logging.getLogger(__name__)

RECIPEQA_DATA_ROOT = "data/recipeQA"


class RecipeQAPairWiseProcessor(DataProcessor):
    """Ordered and unordered recipe step pairs; the base of the other two."""

    def __init__(self, data_dir=None, order_criteria="tight",
                 paired_with_image=True, min_story_length=5,
                 max_story_length=5, version_text=None,
                 caption_transforms=None, **kwargs):
        self.data_dir = data_dir or RECIPEQA_DATA_ROOT
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
        return ["unordered", "ordered"]

    def _read_image_paths(self, data_dir=None, split="train"):
        """recipe_id -> step id -> [image paths], from the file names
        `{recipe_id}_{step}[_{k}].jpg` of every split's directory."""
        data_dir = data_dir or self.data_dir
        img_dir = os.path.join(
            data_dir, "images", "images-qa", "*", "images-qa")
        out = {}
        for img_path in sorted(glob.glob(os.path.join(img_dir, "*.jpg"))):
            img_name = img_path.strip().split("/")[-1].split(".")[0]
            parts = img_name.split("_")
            if len(parts) >= 2 and not (len(parts) >= 3
                                        and parts[-2].isdigit()):
                recipe_id = "_".join(parts[:-1])
                step_id = int(parts[-1])
            else:
                recipe_id = "_".join(parts[:-2])
                step_id = int(parts[-2])
            out.setdefault(recipe_id, {}).setdefault(step_id, []).append(
                img_path)
        return out

    def _read_json(self, data_dir=None, split="train"):
        """The recipes of a split, each [recipe_id, (text, img_path or
        None), ...] cut to `max_story_length` steps, or a multiref dict
        wrapper; recipes with fewer than `min_story_length` steps are
        skipped."""
        data_dir = data_dir or self.data_dir
        json_path = os.path.join(data_dir, "texts", split + ".json")
        if self.version_text is not None:
            json_path = os.path.join(
                data_dir, "new_splits", f"{split}-{self.version_text}.json")
            if not os.path.exists(json_path):
                raise ValueError(f"File: {json_path} not found!")
        logger.info("Using %s", json_path)

        image_paths = self._read_image_paths(data_dir=data_dir, split=split)
        with open(json_path) as f:
            data = json.load(f)["data"]

        story_seqs = []
        used_recipe_ids = set()
        for data_raw in data:
            recipe_id = data_raw["recipe_id"]
            if recipe_id in used_recipe_ids:
                continue
            used_recipe_ids.add(recipe_id)
            image_paths_curr = image_paths.get(recipe_id, {})
            story_seq = [recipe_id]
            if "multiref_gt" in data_raw and not self.multiref_gt:
                self.multiref_gt = True
            for step in data_raw["context"]:
                text = step["body"]
                if self.caption_transforms is not None:
                    text = self.caption_transforms.transform(text)
                step_id = int(step["id"])
                if step_id in image_paths_curr:
                    story_seq.append((text, image_paths_curr[step_id][0]))
                elif not self.paired_with_image:
                    story_seq.append((text, None))
            if len(story_seq) < self.min_story_length + 1:
                continue
            story_seq = story_seq[:self.max_story_length + 1]
            if self.multiref_gt:
                story_seq = {"story_seq": story_seq,
                             "multiref_gt": data_raw["multiref_gt"]}
            story_seqs.append(story_seq)

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
        return self._create_examples(self._read_json(data_dir, "val"))

    def get_test_examples(self, data_dir=None):
        return self._create_examples(self._read_json(data_dir, "test"))


class RecipeQAAbductiveProcessor(RecipeQAPairWiseProcessor):
    """(h1, h2, h3) step triples, as `WikiHowAbductiveProcessor` makes
    them."""

    def __init__(self, data_dir=None, pred_method="binary",
                 paired_with_image=True, min_story_length=5,
                 max_story_length=5, version_text=None,
                 caption_transforms=None, **kwargs):
        super().__init__(data_dir=data_dir, order_criteria="tight",
                         paired_with_image=paired_with_image,
                         min_story_length=min_story_length,
                         max_story_length=max_story_length,
                         version_text=version_text,
                         caption_transforms=caption_transforms)
        if pred_method not in ("binary", "contrastive"):
            raise ValueError(f"pred_method {pred_method!r}: binary or "
                             f"contrastive")
        self.pred_method = pred_method

    def _create_examples(self, lines) -> List[AbductiveExample]:
        return abductive_examples(self, lines)


class RecipeQAGeneralProcessor(RecipeQAPairWiseProcessor):
    """Whole-recipe examples for the head, sort, pure_class, pretrain and
    hl_v1 tasks."""

    def __init__(self, data_dir=None, max_story_length=5, pure_class=False,
                 paired_with_image=True, min_story_length=5,
                 version_text=None, caption_transforms=None, **kwargs):
        super().__init__(data_dir=data_dir, order_criteria="tight",
                         paired_with_image=paired_with_image,
                         min_story_length=min_story_length,
                         max_story_length=max_story_length,
                         version_text=version_text,
                         caption_transforms=caption_transforms)
        self.pure_class = pure_class

    def get_labels(self):
        return general_labels(self)

    def _create_examples(self, lines) -> List[HeadExample]:
        return story_examples(self, lines)


def human_annotated_to_test(data_dir, human_annotated_json_files,
                            out_dir=None, version="human_annot"):
    """Write `{train,val,test}-{version}.json` and `test-{version}_only.json`
    under `out_dir` (default `data_dir`): the recipes of `texts/*.json`,
    those whose id is a `guid` of the JSONL files
    `human_annotated_json_files` moved to the end of test (and alone in
    `_only`). A val or test recipe that is also in train raises."""
    random.seed(42)
    human = {}
    for path in human_annotated_json_files:
        with open(path) as f:
            for line in f:
                datum = json.loads(line.strip())
                human[datum["guid"]] = datum

    out_dir = out_dir or data_dir
    buckets = {"train": [], "val": [], "test": []}
    human_data = []
    for json_path in sorted(glob.glob(os.path.join(data_dir, "texts",
                                                   "*.json"))):
        with open(json_path) as f:
            data_curr = json.load(f)["data"]
        for data_raw in data_curr:
            if data_raw["recipe_id"] in human:
                human_data.append(data_raw)
            else:
                for split in buckets:
                    if split in os.path.basename(json_path):
                        buckets[split].append(data_raw)

    train_ids = {d["recipe_id"] for d in buckets["train"]}
    for split in ("val", "test"):
        for d in buckets[split]:
            if d["recipe_id"] in train_ids:
                raise ValueError(f"recipe_id: {d['recipe_id']} is in train!")

    buckets["test"] = buckets["test"] + human_data
    os.makedirs(out_dir, exist_ok=True)
    for split, data in buckets.items():
        with open(os.path.join(out_dir, f"{split}-{version}.json"), "w") as f:
            json.dump({"version": 0.9, "data": data}, f, indent=4)
    with open(os.path.join(out_dir, f"test-{version}_only.json"), "w") as f:
        json.dump({"version": 0.9, "data": human_data}, f, indent=4)


_WORD_RE = re.compile(r"\w+|[^\w\s]")


def _word_tokenize(text: str) -> List[str]:
    """Lower-case word and punctuation split."""
    return _WORD_RE.findall(text.lower())


def output_to_tsv(data_dir, out_dir):
    """The `human_annot` splits (train and human_test capped at five
    sentences a step) as plain-text TSVs under `out_dir`: one recipe a
    line, its steps lower-case word-tokenized and joined by " <eos> "; the
    test splits also get a `{split}_examples.json` JSONL of
    {"url": guid}."""
    from .caption_transforms import CaptionTransformations

    proc = RecipeQAGeneralProcessor(
        data_dir=data_dir, version_text="human_annot",
        caption_transforms=CaptionTransformations(
            None, "wikihow",
            caption_transformation_list=["train_max_sentence_5"]))
    proc_human = RecipeQAGeneralProcessor(
        data_dir=data_dir, version_text="human_annot_only",
        caption_transforms=CaptionTransformations(
            None, "wikihow",
            caption_transformation_list=["eval_max_sentence_5"]))

    os.makedirs(out_dir, exist_ok=True)
    all_examples = [
        ("train", proc.get_train_examples()),
        ("dev", proc.get_dev_examples()),
        ("test", proc.get_test_examples()),
        ("human_test", proc_human.get_test_examples()),
    ]
    for split, examples in all_examples:
        with open(os.path.join(out_dir, f"{split}.tsv"), "w") as out_tsv:
            out_json = (open(os.path.join(out_dir, f"{split}_examples.json"),
                             "w") if "test" in split else None)
            try:
                for example in examples:
                    sents = [" ".join(_word_tokenize(s))
                             for s in example.text_seq]
                    out_tsv.write(" <eos> ".join(sents) + "\n")
                    if out_json is not None:
                        out_json.write(json.dumps({"url": example.guid})
                                       + "\n")
            finally:
                if out_json is not None:
                    out_json.close()
