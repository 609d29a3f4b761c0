"""Datasets and batching (copy of `data/datasets.py`: `PairwiseDataset`,
`HeadPredDataset`, `AbductiveDataset`, `PureClassDataset`, `SortDataset`,
`PretrainDataset`, `RetrievalDataset`, `BersonDataset`, their step images,
`collate`, `data_loader`, `prefetch`).

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
from ..utils.permutation import build_permutation_label_maps


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

    def _pack(self, texts) -> Dict[str, Any]:
        ii, am, tt = self.packer.pack_story(texts)
        return {"input_ids": ii, "attention_mask": am, "token_type_ids": tt}

    def _images(self, img_paths, n_steps) -> Dict[str, Any]:
        """{"images": (max_story_length, ...) stack, zero-padded}, or {}
        without `multimodal`."""
        if not self.multimodal:
            return {}
        paths = list(img_paths or [None] * n_steps)
        paths += [None] * (self.max_story_length - len(paths))
        return {"images": self._load_images(paths)}


# the class of a pair's or a triple's label
ORDER_LABELS = {"unordered": 0, "ordered": 1}


class PairwiseDataset(_StoryDatasetBase):
    """Ordered / unordered step pairs (`PairWiseExample`), unscrambled: the
    pair packed to `max_length`, `labels` 1 for ordered, 0 for unordered,
    guid (+ the two step images)."""

    def __init__(self, examples, tokenizer, **kw):
        kw.setdefault("scramble", False)
        super().__init__(examples, tokenizer, **kw)

    def __getitem__(self, idx, epoch: int = 0):
        ex = self.examples[idx]
        item = self._pack([ex.text_a, ex.text_b])
        item["labels"] = np.int32(ORDER_LABELS[ex.label])
        item["guid"] = ex.guid
        if self.multimodal:
            item["images"] = self._load_images([ex.img_path_a, ex.img_path_b])
        return item


class HeadPredDataset(_StoryDatasetBase):
    """Scrambled, packed stories; `labels` = the scrambled position of the
    true first step (+ images)."""

    def __getitem__(self, idx, epoch: int = 0):
        texts, img_paths, idx_seq = self._story(idx, epoch)
        item = self._pack(texts)
        item["labels"] = np.int32(np.argwhere(idx_seq == 0)[0][0])
        item.update(self._images(img_paths, len(texts)))
        return item


class AbductiveDataset(_StoryDatasetBase):
    """(h1, h2, h3) step triples (`AbductiveExample`), unscrambled, packed
    to `max_length`; `labels` 1 for ordered, 0 for unordered; guid (+ the
    three step images)."""

    def __init__(self, examples, tokenizer, pred_method="binary", **kw):
        kw.setdefault("scramble", False)
        super().__init__(examples, tokenizer, **kw)
        self.pred_method = pred_method  # read by no loss, as in JAX

    def __getitem__(self, idx, epoch: int = 0):
        ex = self.examples[idx]
        item = self._pack([ex.text_h1, ex.text_h2, ex.text_h3])
        item["labels"] = np.int32(ORDER_LABELS[ex.label])
        item["guid"] = ex.guid
        if self.multimodal:
            item["images"] = self._load_images(
                [ex.img_path_h1, ex.img_path_h2, ex.img_path_h3])
        return item


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
    """Scrambled, packed stories: input_ids / attention_mask /
    token_type_ids, guid (+ images), and `labels`: with `decode` (the
    default here, the set the heat-map heads train on) the argsort of the
    scramble (or the scrambled multiref list); without it, as the v0
    pure_class head trains, the scramble's permutation id (its
    lexicographic rank). The JAX package's default is `decode=False`."""

    def __init__(self, examples, tokenizer, decode=True, **kw):
        super().__init__(examples, tokenizer, **kw)
        self.decode = decode
        if examples:
            self.max_story_length = min(self.max_story_length,
                                        len(examples[0].text_seq))
        self.label2id, _ = build_permutation_label_maps(
            self.max_story_length)

    def __getitem__(self, idx, epoch: int = 0):
        texts, img_paths, idx_seq = self._story(idx, epoch)
        ex = self.examples[idx]
        item = self._pack(texts)
        if self.decode:
            item["labels"] = _decode_labels(ex, idx_seq,
                                            self.max_story_length)
        else:
            item["labels"] = np.int32(
                self.label2id["_".join(str(x) for x in idx_seq)])
        item["guid"] = ex.guid
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
        item = self._pack(texts)
        item["labels"] = np.int32(np.argwhere(idx_seq == 0)[0][0])
        if self.get_guid:
            item["guid"] = self.examples[idx].guid
        item.update(self._images(img_paths, len(texts)))
        return item


class RetrievalDataset(_StoryDatasetBase):
    """Missing-step retrieval: each story packed with one step, drawn from
    the example's Philox key, left out; `labels` = the argsort of the kept
    step indices followed by the skipped one, guid `{guid}###{skip}`,
    `skip_idx` (+ the kept steps' images, zero-padded).
    `candidates_list()` lists every step of every story, the retrieval
    pool."""

    def __getitem__(self, idx, epoch: int = 0):
        ex = self.examples[idx]
        texts = list(ex.text_seq[:self.max_story_length])
        n = len(texts)
        skip = int(_example_rng(self.seed, epoch, idx).integers(0, n))
        kept = [i for i in range(n) if i != skip]
        item = self._pack([texts[i] for i in kept])
        item["labels"] = np.argsort(
            np.asarray(kept + [skip])).astype(np.int32)
        item["guid"] = f"{ex.guid}###{skip}"
        item["skip_idx"] = np.int32(skip)
        if self.multimodal and ex.img_path_seq is not None:
            item["images"] = self._load_images(
                [ex.img_path_seq[i] for i in kept]
                + [None] * (self.max_story_length - len(kept)))
        return item

    def candidates_list(self):
        """Every step of every story as a candidate: input_ids and
        attention_mask of `per_seq_max_length`, guid `{guid}###{step}`
        (+ its image)."""
        out = []
        for ex in self.examples:
            for j, text in enumerate(ex.text_seq[:self.max_story_length]):
                ids = self.packer.encode_step(text)
                padded = np.full(self.packer.per_seq_max_length,
                                 self.packer.pad_id, np.int32)
                padded[:len(ids)] = ids[:len(padded)]
                item = {"input_ids": padded,
                        "attention_mask": (padded != self.packer.pad_id
                                           ).astype(np.int32),
                        "guid": f"{ex.guid}###{j}"}
                if self.multimodal and ex.img_path_seq is not None:
                    item["images"] = self._load_images([ex.img_path_seq[j]])
                out.append(item)
        return out


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
