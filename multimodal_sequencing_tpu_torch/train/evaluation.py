"""Sort-decode evaluation harness, heat-map and BERSON methods (counterpart
of `train/evaluation.py`).

Each batch of stories is packed on the host, run through the model in
fixed-size micro-batches on the evaluator's device (the tail padded by
repeating the last story, so every forward has the same shape as in the
JAX package; a multimodal story's images are padded the same way, which
changes nothing in eval, where BatchNorm uses its running statistics), and
the heat maps are decoded to orders on the host with the
parity decoders of `utils/heatmap.py`, or with `--device_decode` on the
evaluator's device (`ops/order_decode.py`). `berson` packs each story's
pairs (`StoryPacker.pack_berson_story`, an identity label that the beam
search does not read), encodes the whole batch at once and runs
`BersonOrdering.beam_search` on the device; each order is cut to its
story's length. The other sort methods are later slices.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.order_decode import (exhaustive_naive_decode,
                                topological_decode_batch)
from ..utils.heatmap import heatmap2order
from ..utils.metrics import METRICS, compute_metrics

logger = logging.getLogger(__name__)

SORT_METHODS = [
    "topological", "head_and_topological", "head_and_sequential",
    "head_and_sequential_abductive", "pure_class", "pure_decode",
    "heat_map", "berson",
]


def _batched_apply(apply_fn: Callable[[Dict[str, np.ndarray]], torch.Tensor],
                   feed: Dict[str, np.ndarray], micro_batch: int = 64
                   ) -> np.ndarray:
    """Run a flat batch through the model in fixed-size micro-batches (pad
    the tail), queueing every micro-batch before copying any result back."""
    n = feed["input_ids"].shape[0]
    outs, sizes = [], []
    for start in range(0, n, micro_batch):
        chunk = {k: v[start:start + micro_batch] for k, v in feed.items()}
        m = chunk["input_ids"].shape[0]
        if m < micro_batch:
            chunk = {k: np.concatenate(
                [v, np.repeat(v[-1:], micro_batch - m, axis=0)])
                for k, v in chunk.items()}
        outs.append(apply_fn(chunk))
        sizes.append(m)
    outs = [o.float().cpu().numpy() for o in outs]
    return np.concatenate([o[:m] for o, m in zip(outs, sizes)], axis=0)


class SortEvaluator:
    """Evaluate ordering models over a SortDataset-style loader.

    `forwards` counts model forwards. For each batch, `forward_seconds`
    holds the host wall time of packing, the forwards and the copy back,
    and `decode_seconds` that of decoding the heat maps (on the host, or
    on the device with `cfg.device_decode`); for `berson`, of packing and
    encoding the pairs, and of the beam search with the orders' copy
    back."""

    def __init__(self, cfg, packer, device: torch.device,
                 micro_batch: int = 64):
        self.cfg = cfg
        self.packer = packer
        self.device = torch.device(device)
        self.micro_batch = micro_batch
        self.forwards = 0
        self.forward_seconds: List[float] = []
        self.decode_seconds: List[float] = []

    def story_logits(self, model, stories: List[List[str]],
                     images: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole-story forward; returns each story's (N, N) heat map.
        `images`: the stories' step images, (B, N, H, W, 3) uint8 or (B, N,
        3, H, W) f32, for a multimodal model."""
        packs = [self.packer.pack_story(t, self.cfg.max_seq_length)
                 for t in stories]
        feed = {
            "input_ids": np.stack([p[0] for p in packs]),
            "attention_mask": np.stack([p[1] for p in packs]),
            "token_type_ids": np.stack([p[2] for p in packs]),
        }
        if images is not None:
            feed["images"] = images

        def fn(chunk):
            t = {k: torch.from_numpy(v).to(self.device, torch.long)
                 for k, v in chunk.items() if k != "images"}
            imgs = chunk.get("images")
            if imgs is not None:
                imgs = torch.from_numpy(imgs).to(self.device)
            with torch.inference_mode():
                out = model(t["input_ids"], t["attention_mask"],
                            t["token_type_ids"], images=imgs)
            self.forwards += 1
            return out["heatmap"]

        return _batched_apply(fn, feed, self.micro_batch)

    # the exhaustive n! decode is exact and cheap up to this story length
    # (7! = 5040 candidate orders a story)
    DEVICE_DECODE_MAX_N = 7

    def decode_heatmap(self, heatmaps: np.ndarray) -> List[List[int]]:
        """Orders of (B, N, N) heat maps. With `cfg.device_decode`, the
        naive family (but `super_naive`) at N <= 7 and `topological` decode
        on the evaluator's device (`ops/order_decode.py`); every other case
        decodes on the host (`utils/heatmap.py`)."""
        cfg = self.cfg
        method = cfg.heatmap_decode_method
        n = int(heatmaps.shape[-1])
        if not np.isfinite(heatmaps).all():
            raise ValueError("heat map holds non-finite values")
        if cfg.device_decode:
            # the host decoders' range assertions: the device decoders would
            # turn an out-of-range heat map into NaN scores silently
            if "naive" in method and "v3" not in method \
                    and not heatmaps.min() >= 0:
                raise AssertionError("heat map cannot have negative values.")
            if ("v2" in method or "v3" in method) \
                    and not np.abs(heatmaps).max() <= 1.0:
                raise AssertionError("prob is > 1, sigmoid applied?")
            out = None
            if ("naive" in method and method != "super_naive"
                    and n <= self.DEVICE_DECODE_MAX_N):
                out = exhaustive_naive_decode(self._on_device(heatmaps), n,
                                              method)
            elif method == "topological":
                out = topological_decode_batch(self._on_device(heatmaps), n)
            # else (super_naive, mst, n > 7): the host decoder; the greedy
            # chain would change the v2/v3/_sum scoring
            if out is not None:
                return out.cpu().tolist()
        return [heatmap2order(
            hm.astype(np.float64),
            decode_method=method,
            beam_size=cfg.heatmap_decode_beam_size)
            for hm in heatmaps]

    def _on_device(self, heatmaps: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(heatmaps, np.float32)).to(
            self.device)

    def evaluate(self, loader, sort_method: str, models: Dict,
                 metrics: Optional[Sequence[str]] = None,
                 output_dir: Optional[str] = None,
                 data_split: str = "test", max_batches: Optional[int] = None,
                 args_ns=None,
                 every_n: Optional[int] = None) -> Dict[str, float]:
        """Run decode + metrics over a SortDataset loader. `models` maps
        role -> model (`heatmap` for the heat-map method). `every_n`
        subsamples the loader to every Nth batch."""
        metrics = list(metrics or METRICS)
        all_preds, all_labels, all_guids = [], [], []
        decoded = 0
        for bi, batch in enumerate(loader):
            if every_n is not None and bi % every_n != 0:
                continue
            if max_batches is not None and decoded >= max_batches:
                break
            decoded += 1
            valid = batch.get("valid")
            stories = [t for k, t in enumerate(batch["texts"])
                       if valid is None or valid[k]]
            labels = [l for k, l in enumerate(batch["labels"])
                      if valid is None or valid[k]]
            guids = [g for k, g in enumerate(batch.get(
                "guid", [""] * len(stories))) if valid is None or valid[k]]
            images = batch.get("images")
            if images is not None and valid is not None:
                images = np.asarray(images)[np.asarray(valid)]
            preds = self._decode_batch(sort_method, models, stories, images)
            all_preds.extend(preds)
            all_labels.extend([np.asarray(l) for l in labels])
            all_guids.extend(guids)

        res = {}
        for m in metrics:
            res[m] = compute_metrics(args_ns or self.cfg, m, all_preds,
                                     all_labels)
        if output_dir:
            self._write_outputs(output_dir, data_split, all_guids, all_preds,
                                all_labels, res)
        return res

    def berson_orders(self, model, stories: List[List[str]],
                      images: Optional[np.ndarray] = None
                      ) -> List[List[int]]:
        """`BersonOrdering.beam_search` over the batch, each order cut to
        its story's length; times its two parts."""
        t0 = time.perf_counter()
        items = [self.packer.pack_berson_story(
            texts, list(range(len(texts))),
            max_story_length=self.cfg.max_story_length) for texts in stories]
        batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(
            self.device, torch.long) for k in items[0]}
        if images is not None:
            batch["images"] = torch.from_numpy(np.asarray(images)).to(
                self.device)
        with torch.inference_mode():
            enc = model.encode(batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            pred = model.beam_search(batch, enc).cpu().numpy()
        self.forwards += 1
        self.forward_seconds.append(t1 - t0)
        self.decode_seconds.append(time.perf_counter() - t1)
        # strip the -1 tail of stories shorter than max_story_length
        return [[int(x) for x in p[:len(texts)]]
                for p, texts in zip(pred, stories)]

    def _decode_batch(self, sort_method, models, stories, images=None):
        if sort_method == "berson":
            return self.berson_orders(models["berson"], stories, images)
        if sort_method == "heat_map":
            t0 = time.perf_counter()
            hms = self.story_logits(models["heatmap"], stories, images)
            t1 = time.perf_counter()
            preds = self.decode_heatmap(hms)
            self.forward_seconds.append(t1 - t0)
            self.decode_seconds.append(time.perf_counter() - t1)
            return preds
        raise NotImplementedError(
            f"sort_method {sort_method}: the port decodes heat maps and "
            f"BERSON so far; the other methods come with later slices")

    def _write_outputs(self, output_dir, split, guids, preds, labels, res):
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "output_order.txt"), "w") as f:
            for p in preds:
                f.write(" ".join(str(x) for x in p) + "\n")
        with open(os.path.join(output_dir, "all_predictions.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["guid", "prediction", "label"])
            for g, p, l in zip(guids, preds, labels):
                w.writerow([g, list(p), np.asarray(l).tolist()])
        with open(os.path.join(
                output_dir, f"eval_results_split_{split}.txt"), "w") as f:
            for k, v in sorted(res.items()):
                f.write(f"{k} = {v}\n")
        logger.info("***** Paper Results *****")
        logger.info(" %s", paper_result_line(res)[0])
        logger.info(" %s", paper_result_line(res)[1])


def paper_result_line(res: Dict[str, float]):
    """The paper-format summary row."""
    headers = "& PM    & EM    & Lseq & Lstr & tau  & Dist."
    content = ("& {:03.2f} & {:03.2f} & {:03.2f} & {:03.2f} & {:03.2f} "
               "& {:03.2f}").format(
        res.get("partial_match", 0) * 100,
        res.get("exact_match", 0) * 100,
        res.get("lcs", 0), res.get("lcs_substr", 0),
        res.get("tau", 0), res.get("distance_based", 0))
    return headers, content
