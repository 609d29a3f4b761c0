"""Sort-decode evaluation harness (counterpart of `train/evaluation.py`):
the heat-map, BERSON and v0 baseline methods.

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
story's length.

The v0 baselines score each batch with classification models, one forward
per micro-batch of packed sequences: `topological` packs every ordered
step pair of each story (`StoryPacker.pack_all_pairs` at `pair_len` =
min(max_seq_length, 2 * per_seq_max_length rounded up to 64) tokens) and
sorts the tournament its argmax edges make (`utils/topo.py`, or with
`--device_decode` Kahn's decode of the "ordered" probability on the card);
`head_and_topological` forces the head model's first step;
`head_and_sequential` chains greedily from it by the raw "ordered" logit,
`head_and_sequential_abductive` adding 0.1 x the abductive model's logit
of each (previous, candidate, last) triple; `pure_class` unranks the
argmax of the story's permutation logits.

`pure_decode` beam-generates each story's index tokens with a pure_decode
model (`EncoderIndexDecoder.generate`, beam 5, bigram ban; the encoder
once a micro-batch, the beam loop on the device), or, given a p0/p1
pointer model (role `pointer`), takes the permutation of the largest sum
of the pointer's log-softmax over positions, exhaustively (n! <= 120 a
story at n = 5). A generated sequence need not be a permutation: a metric
that raises `ValueError` on such a prediction reports `nan`, as in the
JAX package.
"""

from __future__ import annotations

import csv
import itertools
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
from ..utils.permutation import permutation_unrank
from ..utils.topo import Graph

logger = logging.getLogger(__name__)

SORT_METHODS = [
    "topological", "head_and_topological", "head_and_sequential",
    "head_and_sequential_abductive", "pure_class", "pure_decode",
    "heat_map", "berson",
]
# the sort methods over a v0 pairwise model
BASELINE_METHODS = ("topological", "head_and_topological",
                    "head_and_sequential", "head_and_sequential_abductive")


def _logsumexp(x, axis=-1, keepdims=False):
    m = np.max(x, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
    return out if keepdims else np.squeeze(out, axis)


def _feed(packs) -> Dict[str, np.ndarray]:
    """Stacked (input_ids, attention_mask, token_type_ids) packs."""
    return {"input_ids": np.stack([p[0] for p in packs]),
            "attention_mask": np.stack([p[1] for p in packs]),
            "token_type_ids": np.stack([p[2] for p in packs])}


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
    and `decode_seconds` that of decoding (the heat maps, the pair logits
    or the permutation logits; on the host, or on the device with
    `cfg.device_decode`); for `berson`, of packing and encoding the pairs,
    and of the beam search with the orders' copy back; for `pure_decode`
    with a pure_decode model, of packing and the encodes, and of the beam
    loops."""

    def __init__(self, cfg, packer, device: torch.device,
                 micro_batch: int = 64):
        self.cfg = cfg
        self.packer = packer
        self.device = torch.device(device)
        self.micro_batch = micro_batch
        self.forwards = 0
        self.forward_seconds: List[float] = []
        self.decode_seconds: List[float] = []

    def _apply(self, model, feed: Dict[str, np.ndarray], want: str
               ) -> np.ndarray:
        """`model(...)[want]` over the packed rows of `feed` (and their
        `images`), in micro-batches on the evaluator's device."""

        def fn(chunk):
            t = {k: torch.from_numpy(chunk[k]).to(self.device, torch.long)
                 for k in ("input_ids", "attention_mask", "token_type_ids")}
            imgs = chunk.get("images")
            if imgs is not None:
                imgs = torch.from_numpy(imgs).to(self.device)
            kw = {}
            if "img_regional_features" in chunk:
                kw["img_regional_features"] = torch.from_numpy(
                    chunk["img_regional_features"]).to(self.device,
                                                       torch.float32)
            with torch.inference_mode():
                out = model(t["input_ids"], t["attention_mask"],
                            t["token_type_ids"], images=imgs, aux=False,
                            **kw)
            self.forwards += 1
            return out[want]

        return _batched_apply(fn, feed, self.micro_batch)

    def story_logits(self, model, stories: List[List[str]],
                     images: Optional[np.ndarray] = None,
                     want: str = "logits",
                     regional: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole-story forward; returns each story's `want` output (a v0
        model's `logits`, a heat-map model's (N, N) `heatmap`). `images`:
        the stories' step images, (B, N, H, W, 3) uint8 or (B, N, 3, H, W)
        f32, for a multimodal model; `regional` their ROI sidecar batch
        (B, N, R, C), or the (B, 1) sentinel, for a VisualBERT model."""
        feed = _feed([self.packer.pack_story(t, self.cfg.max_seq_length)
                      for t in stories])
        if images is not None:
            feed["images"] = images
        if regional is not None:
            feed["img_regional_features"] = regional
        return self._apply(model, feed, want)

    def story_generate(self, model, stories: List[List[str]]):
        """Beam-5 index-token generate over the packed whole stories of a
        pure_decode model, in micro-batches (the tail padded): the encoder
        once a micro-batch, then the beam loop. Returns (each story's N
        tokens, the seconds of the beam loops)."""
        feed = _feed([self.packer.pack_story(t, self.cfg.max_seq_length)
                      for t in stories])
        beam_s = [0.0]

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def fn(chunk):
            t = {k: torch.from_numpy(v).to(self.device, torch.long)
                 for k, v in chunk.items()}
            with torch.inference_mode():
                enc = model.encode(t["input_ids"], t["attention_mask"],
                                   t["token_type_ids"])
                self.forwards += 1
                sync()
                t0 = time.perf_counter()
                out = model.generate(None, enc=enc)
                sync()
            beam_s[0] += time.perf_counter() - t0
            return out

        out = _batched_apply(fn, feed, self.micro_batch)
        return [[int(x) for x in row] for row in out], beam_s[0]

    @staticmethod
    def pointer_argmax(logits: np.ndarray) -> List[List[int]]:
        """The pointer substitution of `pure_decode`: for each story's
        (N, N) p0/p1 logits, the permutation with the largest sum over
        positions t of the log-softmax at (t, perm[t]), exhaustively; on a
        tie the first in lexicographic order."""
        logp = logits - _logsumexp(logits, axis=-1, keepdims=True)
        n = logits.shape[-1]
        preds = []
        for lp in logp:
            best, best_s = None, -np.inf
            for perm in itertools.permutations(range(n)):
                s = sum(lp[t, perm[t]] for t in range(n))
                if s > best_s:
                    best, best_s = list(perm), s
            preds.append(best)
        return preds

    def pair_logit_matrix(self, model, stories: List[List[str]],
                          images: Optional[np.ndarray] = None,
                          regional: Optional[np.ndarray] = None):
        """A v0 model's logits of every ordered step pair (i, j), i != j, of
        each story: ((B, N, N) raw 'ordered' logits, (B, N, N, 2) the first
        two logits), the diagonals 0. Each pair is packed alone to
        `pair_len` tokens (with its two steps' images, and their two rows
        of `regional`, the (B, N, R, C) sidecars)."""
        cfg = self.cfg
        n = cfg.max_story_length
        # a pair needs at most 2 * per_seq_max_length tokens
        pair_len = min(cfg.max_seq_length,
                       -(-2 * cfg.per_seq_max_length // 64) * 64)
        packs, img_feed, reg_feed = [], [], []
        for b, texts in enumerate(stories):
            ii, am, tt, pair_idx = self.packer.pack_all_pairs(texts,
                                                              pair_len)
            packs.append((ii, am, tt))
            if images is not None:
                img_feed.append(images[b][pair_idx])  # (P, 2, ...)
            if regional is not None:
                reg_feed.append(regional[b][pair_idx])  # (P, 2, R, C)
        feed = {k: np.concatenate([p[i] for p in packs]) for i, k in
                enumerate(("input_ids", "attention_mask", "token_type_ids"))}
        if images is not None:
            feed["images"] = np.concatenate(img_feed)
        if regional is not None:
            feed["img_regional_features"] = np.concatenate(reg_feed)
        logits = self._apply(model, feed, "logits").reshape(
            len(stories), len(pair_idx), -1)
        mat = np.zeros((len(stories), n, n), np.float32)
        cls2 = np.zeros((len(stories), n, n, 2), np.float32)
        for p, (i, j) in enumerate(pair_idx):
            mat[:, i, j] = logits[:, p, 1]
            cls2[:, i, j] = logits[:, p, :2]
        return mat, cls2

    def abductive_logit_cube(self, model, stories: List[List[str]]
                             ) -> np.ndarray:
        """(B, N, N, N) 'ordered' logits of every (h1, h2, h3) triple of
        distinct steps, each packed to `max_seq_length` (text only, as in
        the JAX package)."""
        n = self.cfg.max_story_length
        triples = [(a, b, c) for a in range(n) for b in range(n)
                   for c in range(n) if len({a, b, c}) == 3]
        packs = []
        for texts in stories:
            ids = self.packer.encode_steps(texts)
            packs += [self.packer.pack([ids[a], ids[b], ids[c]],
                                       self.cfg.max_seq_length)
                      for a, b, c in triples]
        logits = self._apply(model, _feed(packs), "logits").reshape(
            len(stories), len(triples), -1)
        cube = np.zeros((len(stories), n, n, n), np.float32)
        for t, (a, b, c) in enumerate(triples):
            cube[:, a, b, c] = logits[:, t, 1]
        return cube

    @staticmethod
    def decode_topological(pair_logits_2c: np.ndarray,
                           head_idx: Optional[np.ndarray] = None
                           ) -> List[List[int]]:
        """The edge i -> j of each i < j where the pair's logits argmax to
        'ordered', else j -> i, then the DFS topological sort (with
        `head_idx`, each story's forced first step)."""
        b, n = pair_logits_2c.shape[:2]
        preds = []
        for s in range(b):
            g = Graph(n)
            for i in range(n):
                for j in range(i + 1, n):
                    if np.argmax(pair_logits_2c[s, i, j]) == 1:
                        g.addEdge(i, j)
                    else:
                        g.addEdge(j, i)
            preds.append(g.topologicalSort(
                assert_head=None if head_idx is None else int(head_idx[s])))
        return preds

    @staticmethod
    def decode_sequential(pair_logits: np.ndarray, head_idx: np.ndarray,
                          abd_cube: Optional[np.ndarray] = None
                          ) -> List[List[int]]:
        """From each story's head, greedily the next step of the largest raw
        'ordered' logit after the last one (plus 0.1 x the abductive logit
        of (previous, candidate, last) with `abd_cube`, from the third step
        on); ties to the lowest remaining step."""
        b, n = pair_logits.shape[:2]
        preds = []
        for s in range(b):
            pred = [int(head_idx[s])]
            left = [i for i in range(n) if i != pred[0]]
            while left:
                prev = pred[-1]
                scores = []
                for cand in left:
                    sc = pair_logits[s, prev, cand]
                    if abd_cube is not None and len(pred) >= 2:
                        sc = sc + 0.1 * abd_cube[s, pred[-2], cand, prev]
                    scores.append(sc)
                nxt = left[int(np.argmax(scores))]
                pred.append(nxt)
                left.remove(nxt)
            preds.append(pred)
        return preds

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
        role -> model: `heatmap`, `berson`, `pure_class`, `pure_decode` or
        `pointer` (for pure_decode), or for the pairwise methods
        `pairwise`, `head` (head_and_*) and `abductive` (optional,
        head_and_sequential_abductive). `every_n` subsamples the loader to
        every Nth batch. A metric that raises `ValueError` (one that needs
        permutations, given a generated sequence that is not one) is
        `nan`."""
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
            regional = batch.get("img_regional_features")
            if regional is not None and valid is not None:
                regional = np.asarray(regional)[np.asarray(valid)]
            preds = self._decode_batch(sort_method, models, stories, images,
                                       regional)
            all_preds.extend(preds)
            all_labels.extend([np.asarray(l) for l in labels])
            all_guids.extend(guids)

        res = {}
        for m in metrics:
            try:
                res[m] = compute_metrics(args_ns or self.cfg, m, all_preds,
                                         all_labels)
            except ValueError:
                res[m] = float("nan")
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

    def _decode_batch(self, sort_method, models, stories, images=None,
                      regional=None):
        if sort_method == "berson":
            return self.berson_orders(models["berson"], stories, images)
        t0 = time.perf_counter()
        if sort_method == "heat_map":
            hms = self.story_logits(models["heatmap"], stories, images,
                                    want="heatmap", regional=regional)
            t1 = time.perf_counter()
            preds = self.decode_heatmap(hms)
        elif sort_method == "pure_class":
            logits = self.story_logits(models["pure_class"], stories, images,
                                       regional=regional)
            t1 = time.perf_counter()
            n = self.cfg.max_story_length
            preds = [permutation_unrank(int(np.argmax(lg)), n)
                     for lg in logits]
        elif sort_method == "pure_decode" and "pure_decode" in models:
            preds, beam_s = self.story_generate(models["pure_decode"],
                                                stories)
            # forward: the packing and the encodes; decode: the beam loops
            t1 = time.perf_counter() - beam_s
        elif sort_method == "pure_decode":
            logits = self.story_logits(models["pointer"], stories, images,
                                       want="pointer_logits",
                                       regional=regional)
            t1 = time.perf_counter()
            preds = self.pointer_argmax(logits)
        elif sort_method in BASELINE_METHODS:
            logits = self._baseline_logits(sort_method, models, stories,
                                           images, regional)
            t1 = time.perf_counter()
            preds = self._baseline_orders(sort_method, *logits)
        else:
            raise NotImplementedError(f"sort_method {sort_method}")
        self.forward_seconds.append(t1 - t0)
        self.decode_seconds.append(time.perf_counter() - t1)
        return preds

    def _baseline_logits(self, sort_method, models, stories, images,
                         regional=None):
        """The forwards of a pairwise method: (the head model's first steps
        or None, the pairs' 'ordered' logits, their first two logits, the
        abductive cube or None)."""
        head_idx = abd = None
        if sort_method.startswith("head_and"):
            head_idx = np.argmax(self.story_logits(
                models["head"], stories, images, regional=regional), axis=-1)
        pair_logits, pair_2c = self.pair_logit_matrix(
            models["pairwise"], stories, images, regional=regional)
        if (sort_method == "head_and_sequential_abductive"
                and "abductive" in models):
            abd = self.abductive_logit_cube(models["abductive"], stories)
        return head_idx, pair_logits, pair_2c, abd

    def _baseline_orders(self, sort_method, head_idx, pair_logits, pair_2c,
                         abd) -> List[List[int]]:
        if sort_method == "topological" and self.cfg.device_decode:
            # Kahn's decode of P(ordered) on the card: the host DFS order
            # whenever the argmax tournament is acyclic
            e = pair_2c - _logsumexp(pair_2c, axis=-1, keepdims=True)
            return topological_decode_batch(
                self._on_device(np.exp(e[..., 1])), pair_2c.shape[1],
                thres=0.5).cpu().tolist()
        if sort_method in ("topological", "head_and_topological"):
            return self.decode_topological(pair_2c, head_idx)
        return self.decode_sequential(pair_logits, head_idx, abd)

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
