"""Datasets and batching (copy of `data/datasets.py`: `SortDataset`,
`PureClassDataset` in decode mode, `BersonDataset`, `PretrainDataset`,
their step images, `collate`, `data_loader`, `prefetch`).

Every example draws its scramble from a counter-based Philox key
(seed, epoch, index), and the loader its shuffle from (seed, epoch), so the
port scrambles and orders exactly as the JAX package. Batches collate into
dense numpy dicts with a `valid` mask, so the final partial batch is padded
instead of dropped; the padding repeats the last example, its images
included (in training they enter the BatchNorm statistics of that batch,
as in the JAX package).

With `multimodal`, each story carries its step images, the missing steps
up to `max_story_length` as zeros: (N, H, W, 3) uint8 for the device tail
(`uint8_images`, what the CLIs ship by default) or (N, 3, H, W) f32 from
the host pipeline, in the `imagenet` or `detectron2` transform
(`data/images.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from .packing import StoryPacker


def _example_rng(seed: Optional[int], epoch: int, idx: int
                 ) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=np.uint64(((seed or 0) << 32)
                                       ^ (epoch << 20) ^ idx)))


class _StoryDatasetBase:
    """Shared story handling: length clamp, scramble, packing, images."""

    def __init__(self, examples, tokenizer, max_length=None,
                 per_seq_max_length=32, max_story_length=5, scramble=True,
                 seed=None, multimodal=False, image_size=(224, 224),
                 uint8_images=False, image_transform="imagenet"):
        self.examples = examples
        self.scramble = scramble
        self.seed = seed
        self.multimodal = multimodal
        self.image_size = tuple(image_size)
        self.uint8_images = uint8_images
        self.image_transform = image_transform
        self.max_story_length = max(1, max_story_length)
        self.packer = StoryPacker(tokenizer, max_length or 512,
                                  per_seq_max_length)

    def __len__(self):
        return len(self.examples)

    def _story(self, idx: int, epoch: int = 0):
        """(texts, img_paths or None, idx_seq) after clamp + scramble."""
        ex = self.examples[idx]
        texts = list(ex.text_seq[:self.max_story_length])
        idx_seq = np.arange(len(texts))
        if self.scramble:
            _example_rng(self.seed, epoch, idx).shuffle(idx_seq)
            texts = [texts[i] for i in idx_seq]
        img_paths = None
        if self.multimodal and ex.img_path_seq is not None:
            img_paths = [ex.img_path_seq[i] for i in idx_seq]
        return texts, img_paths, idx_seq

    def _load_images(self, paths):
        from . import images
        if self.image_transform == "detectron2":
            if self.uint8_images:
                return images.load_image_stack_uint8_bgr(paths,
                                                         self.image_size)
            return images.load_image_stack_detectron2(paths, self.image_size)
        if self.uint8_images:
            return images.load_image_stack_uint8(paths, self.image_size)
        return images.load_image_stack(paths, self.image_size)

    def _images(self, img_paths, n_steps) -> Dict[str, Any]:
        """{"images": (max_story_length, ...) stack, zero-padded}, or {}
        without `multimodal`."""
        if not self.multimodal:
            return {}
        paths = list(img_paths or [None] * n_steps)
        paths += [None] * (self.max_story_length - len(paths))
        return {"images": self._load_images(paths)}


class SortDataset(_StoryDatasetBase):
    """Decode-time dataset: raw step texts + order labels (+ images)."""

    def __getitem__(self, idx, epoch: int = 0):
        texts, img_paths, idx_seq = self._story(idx, epoch)
        ex = self.examples[idx]
        item = {
            "texts": texts,
            "labels": _decode_labels(ex, idx_seq, self.max_story_length),
            "guid": ex.guid,
        }
        item.update(self._images(img_paths, len(texts)))
        return item


class PureClassDataset(_StoryDatasetBase):
    """Scrambled, packed stories with order labels (the JAX package's
    `PureClassDataset(decode=True)`, which the heat-map heads train on):
    input_ids / attention_mask / token_type_ids, labels = argsort of the
    scramble (or the scrambled multiref list), guid (+ images)."""

    def __init__(self, examples, tokenizer, **kw):
        super().__init__(examples, tokenizer, **kw)
        if examples:
            self.max_story_length = min(self.max_story_length,
                                        len(examples[0].text_seq))

    def __getitem__(self, idx, epoch: int = 0):
        texts, img_paths, idx_seq = self._story(idx, epoch)
        ex = self.examples[idx]
        ii, am, tt = self.packer.pack_story(texts)
        item = {"input_ids": ii, "attention_mask": am, "token_type_ids": tt,
                "labels": _decode_labels(ex, idx_seq, self.max_story_length),
                "guid": ex.guid}
        item.update(self._images(img_paths, len(texts)))
        return item


class BersonDataset(_StoryDatasetBase):
    """BERSON's pair-expanded stories (`StoryPacker.pack_berson_story`):
    the packed pairs and their relation metadata, `labels` = the chain
    padded with the dead step indices, guid (+ images)."""

    def __getitem__(self, idx, epoch: int = 0):
        texts, img_paths, idx_seq = self._story(idx, epoch)
        label = np.argsort(np.asarray(idx_seq)).astype(np.int32)
        item = self.packer.pack_berson_story(
            texts, label.tolist(), max_story_length=self.max_story_length)
        item["labels"] = np.concatenate(
            [label, np.arange(len(texts), self.max_story_length,
                              dtype=np.int32)])
        item["guid"] = self.examples[idx].guid
        item.update(self._images(img_paths, len(texts)))
        return item


class PretrainDataset(_StoryDatasetBase):
    """Whole unscrambled stories for MLM and the pretraining objectives:
    input_ids / attention_mask / token_type_ids, `labels` = the position
    of the first step (0 unscrambled), guid with `get_guid` (+ images)."""

    def __init__(self, examples, tokenizer, scramble=False, get_guid=False,
                 **kw):
        super().__init__(examples, tokenizer, scramble=scramble, **kw)
        self.get_guid = get_guid

    def __getitem__(self, idx, epoch: int = 0):
        texts, img_paths, idx_seq = self._story(idx, epoch)
        ii, am, tt = self.packer.pack_story(texts)
        item = {"input_ids": ii, "attention_mask": am, "token_type_ids": tt,
                "labels": np.int32(np.argwhere(idx_seq == 0)[0][0])}
        if self.get_guid:
            item["guid"] = self.examples[idx].guid
        item.update(self._images(img_paths, len(texts)))
        return item


def _decode_labels(ex, idx_seq, max_story_length):
    """Order label(s) for decode: argsort of the scramble, or the scrambled
    multiref list."""
    if getattr(ex, "multiref_gt", None) is not None:
        multiref = ex.multiref_gt
        assert len(multiref) >= 1 and isinstance(multiref, list)
        offset = min(multiref[0])
        multiref = [[x - offset for x in y] for y in multiref]
        assert list(range(max_story_length)) in multiref, (
            f"Forgot the original 12345 GT for data: {ex.guid}?")
        multiref = sorted(multiref)
        assert list(range(max_story_length)) == multiref[0]
        scrambled = [[x[i] for i in idx_seq] for x in multiref]
        return np.asarray([np.argsort(np.asarray(x)) for x in scrambled],
                          dtype=np.int32)
    return np.argsort(np.asarray(idx_seq)).astype(np.int32)


_ARRAY_KEYS = ("input_ids", "attention_mask", "token_type_ids", "labels",
               "images", "sep_positions", "pairs_list", "pairwise_labels",
               "ground_truth", "mask_cls", "passage_length", "pairs_num")


def collate(items: Sequence[Dict[str, Any]], pad_to: Optional[int] = None
            ) -> Dict[str, Any]:
    """Stack example dicts into a dense batch. `pad_to` pads the batch to a
    static size by repeating the last example and marks them invalid in the
    returned `valid` mask."""
    n = len(items)
    total = pad_to or n
    valid = np.zeros(total, dtype=bool)
    valid[:n] = True
    padded = list(items) + [items[-1]] * (total - n)
    batch: Dict[str, Any] = {"valid": valid}
    for key in padded[0]:
        vals = [it[key] for it in padded]
        stackable = key in _ARRAY_KEYS and (
            isinstance(vals[0], np.ndarray) or np.isscalar(vals[0])
            or isinstance(vals[0], (np.integer, np.floating)))
        if stackable:
            shapes = {np.asarray(v).shape for v in vals}
            if len(shapes) == 1:
                batch[key] = np.stack([np.asarray(v) for v in vals])
            else:  # ragged (e.g. multiref labels) stays a list
                batch[key] = vals
        else:
            batch[key] = vals
    return batch


def data_loader(dataset, batch_size: int, shuffle: bool = False,
                seed: Optional[int] = None, epoch: int = 0,
                drop_last: bool = False, pad_final: bool = True):
    """Deterministic host loader yielding collated numpy batches; with
    `shuffle` the order is a Philox permutation keyed by (seed, epoch)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.Generator(
            np.random.Philox(key=np.uint64(((seed or 0) << 32) ^ epoch))
        ).shuffle(order)
    for start in range(0, len(order), batch_size):
        sel = order[start:start + batch_size]
        if len(sel) < batch_size and drop_last:
            return
        items = [dataset.__getitem__(int(i), epoch=epoch) for i in sel]
        yield collate(items, pad_to=batch_size if pad_final else None)


def prefetch(iterator, size: int = 2):
    """Background-thread prefetcher: prepares the next host batches
    (tokenize, pack) while the device runs the current step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    err = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surface loader errors to the consumer
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item
