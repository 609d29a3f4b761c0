"""Pretraining objective planners on the host (copy of
`train/objectives.py`: `plan_objective`, `_repack_language`,
`choose_objective`), and the fine-tune loop's `plan_itm_swap` (the `itm`
auxiliary objective).

One objective runs per batch, drawn uniformly by `choose_objective`. Its
random decisions and index surgery run here in numpy on the packed batch;
the model then computes the objective's loss from the transformed batch and
the plan's auxiliary arrays (`models/pretrainer.py`). Every draw is the JAX
package's, in the same order, so one `np.random.Generator` state gives the
same plans in both packages. Labels: 1 = untouched, 0 = corrupted (p = 0.5).

  image_swapping                  swap two step images within a story
  image_sequence_predictions      one step image from another story
  whole_image_sequence_swapping   the whole image sequence from another
  multimodal_swapping             image_swapping, then two language step
                                  spans swapped with p = 0.25; labels
                                  multiplied
  margin_loss, multimodal_margin_loss
                                  (i, j) and (i, k) two-step pairs, the
                                  batch doubled; the multimodal one draws
                                  a modality (text only: no images; image
                                  only: the language cut to one token)
  time_contrastive                anchor / positive / negative step triplets
  patch_based_image_swapping      random patch subsets of two steps swapped
                                  inside the folded visual stream
  patch_based_image_sequence_predictions
                                  a patch subset of one step taken from
                                  another story's stream (`patch_src`)
  patch_based_mrm_classification mask 5 patches a step; match the masked
                                  outputs to the shuffled originals
  swapping_based_nsp, sequence_based_nsp
                                  language spans swapped / permuted
  no_mlm, visual_mlm, mlm_only    the batch as it is
The objectives in `SUBSAMPLED` first keep `subsample_len` (2) random steps
of each story, language and images.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SUBSAMPLED = {
    "image_swapping", "image_sequence_predictions",
    "patch_based_image_swapping", "patch_based_mrm_classification",
    "patch_based_image_sequence_predictions",
}


def _repack_language(batch, indices_per_sample, cls_id, pad_id,
                     ignore_index, n_story):
    """Keep (or reorder) language step spans per sample: `indices` are the
    step indices to keep, in order; the result is L // n_story * keep
    tokens long."""
    ids = batch["input_ids"]
    b, L = ids.shape
    keep = len(indices_per_sample[0])
    pad_len = L // n_story * keep
    out = {
        "input_ids": np.full((b, pad_len), pad_id, ids.dtype),
        "attention_mask": np.zeros((b, pad_len),
                                   batch["attention_mask"].dtype),
        "token_type_ids": np.zeros((b, pad_len),
                                   batch["token_type_ids"].dtype),
    }
    has_mlm = "mlm_labels" in batch
    if has_mlm:
        out["mlm_labels"] = np.full((b, pad_len), ignore_index,
                                    batch["mlm_labels"].dtype)
    for i in range(b):
        row = ids[i]
        cls_pos = np.flatnonzero(row == cls_id)
        span_end = list(cls_pos[1:]) + [int(np.flatnonzero(
            row != pad_id)[-1]) + 1 if (row != pad_id).any() else L]
        sel = []
        for s in indices_per_sample[i]:
            if s < len(cls_pos):
                sel.extend(range(int(cls_pos[s]), int(span_end[s])))
        sel = sel[:pad_len]
        m = len(sel)
        out["input_ids"][i, :m] = row[sel]
        out["attention_mask"][i, :m] = batch["attention_mask"][i, sel]
        out["token_type_ids"][i, :m] = batch["token_type_ids"][i, sel]
        if has_mlm:
            out["mlm_labels"][i, :m] = batch["mlm_labels"][i, sel]
    return out


def plan_objective(objective: str, batch: Dict[str, np.ndarray], cfg,
                   rng: np.random.Generator,
                   subsample_len: int = 2
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Transform a packed pretraining batch for `objective`. Returns
    (new_batch, aux); aux carries the objective's labels and index plans
    (and `eff_n`, the steps a story has after subsampling)."""
    batch = dict(batch)
    aux: Dict[str, np.ndarray] = {}
    n = cfg.max_story_length
    b = batch["input_ids"].shape[0]
    images = batch.get("images")

    def corrupt_flags():
        return (rng.random(b) > 0.5)  # True = corrupt (label 0)

    # --- step subsampling ----------------------------------------------------
    eff_n = n
    if objective in SUBSAMPLED and subsample_len < n:
        keep = [sorted(rng.choice(n, subsample_len, replace=False))
                for _ in range(b)]
        if images is not None:
            images = np.stack([images[i][keep[i]] for i in range(b)])
        lang = _repack_language(batch, keep, cfg.cls_id, cfg.pad_id,
                                cfg.mlm_ignore_index, n)
        batch.update(lang)
        eff_n = subsample_len
    aux["eff_n"] = np.int32(eff_n)

    if objective == "image_swapping":
        flags = corrupt_flags()
        labels = (~flags).astype(np.int32)
        images = None if images is None else images.copy()
        for i in range(b):
            if flags[i] and images is not None:
                x, y = sorted(rng.choice(eff_n, 2, replace=False))
                images[i, [x, y]] = images[i, [y, x]]
        aux["objective_labels"] = labels

    elif objective == "image_sequence_predictions":
        flags = corrupt_flags()
        labels = (~flags).astype(np.int32)
        if images is not None:
            src = images.copy()
            for i in range(b):
                if flags[i] and b > 1:
                    other = rng.choice([j for j in range(b) if j != i])
                    images[i, rng.integers(eff_n)] = src[
                        other, rng.integers(eff_n)]
        aux["objective_labels"] = labels

    elif objective == "whole_image_sequence_swapping":
        flags = corrupt_flags()
        labels = (~flags).astype(np.int32)
        if images is not None:
            src = images.copy()
            for i in range(b):
                if flags[i] and b > 1:
                    other = rng.choice([j for j in range(b) if j != i])
                    images[i] = src[other]
        aux["objective_labels"] = labels

    elif objective == "multimodal_swapping":
        # language span swap with p = 0.25, composed multiplicatively with
        # an image_swapping pass
        img_batch, img_aux = plan_objective(
            "image_swapping", {**batch, "images": images}, cfg, rng,
            subsample_len)
        batch, images = img_batch, img_batch.get("images")
        eff_n = int(img_aux["eff_n"])
        lang_labels = np.ones(b, np.int32)
        perms = []
        for i in range(b):
            perm = list(range(eff_n))
            if rng.random() > 0.75:
                x, y = sorted(rng.choice(eff_n, 2, replace=False))
                perm[x], perm[y] = perm[y], perm[x]
                lang_labels[i] = 0
            perms.append(perm)
        lang = _repack_language(batch, perms, cfg.cls_id, cfg.pad_id,
                                cfg.mlm_ignore_index, eff_n)
        batch.update(lang)
        aux["objective_labels"] = img_aux["objective_labels"] * lang_labels
        aux["eff_n"] = np.int32(eff_n)

    elif objective in ("margin_loss", "multimodal_margin_loss"):
        # sample i < j < k; variant 1 = steps (i, j), variant 2 = (i, k);
        # with p = 0.3 reversed or mixed index pairs
        idx1, idx2 = [], []
        for _ in range(b):
            i_ = rng.integers(0, n - 2)
            j_ = rng.integers(i_ + 1, n - 1)
            k_ = rng.integers(j_ + 1, n)
            a, c = [i_, j_], [i_, k_]
            if rng.random() > 0.7:
                if rng.random() > 0.5:
                    if rng.random() > 0.5:
                        a, c = [i_, k_], [k_, i_]
                    else:
                        a, c = [i_, j_], [j_, i_]
                else:
                    a, c = [j_, i_], [k_, i_]
            idx1.append(a)
            idx2.append(c)
        both = idx1 + idx2
        big = {k: np.concatenate([v, v]) for k, v in batch.items()
               if isinstance(v, np.ndarray) and v.shape[:1] == (b,)}
        if images is not None:
            images2 = np.concatenate([images, images])
            images = np.stack([images2[i][both[i]]
                               for i in range(2 * b)])
        lang = _repack_language(big, both, cfg.cls_id, cfg.pad_id,
                                cfg.mlm_ignore_index, n)
        big.update(lang)
        batch = big
        aux["margin_target"] = np.ones(b, np.int32)
        aux["eff_n"] = np.int32(2)
        if objective == "multimodal_margin_loss":
            modality = rng.choice(["multimodal", "text_only", "image_only"])
            if modality == "text_only":
                images = None
            elif modality == "image_only":
                # the language shrinks to its leading CLS token
                for k in ("input_ids", "attention_mask", "token_type_ids",
                          "mlm_labels"):
                    if k in batch:
                        batch[k] = batch[k][:, :1]
            aux["modality"] = modality

    elif objective == "time_contrastive":
        anchors, positives, negatives = [], [], []
        for _ in range(b):
            a = int(rng.integers(n))
            pos_opts = [x for x in (a - 1, a + 1) if 0 <= x < n]
            p_ = int(rng.choice(pos_opts))
            neg_opts = [x for x in range(n) if abs(x - a) >= 2]
            if not neg_opts:  # short stories: fall back to the farthest step
                neg_opts = [0 if a >= n // 2 else n - 1]
            g = int(rng.choice(neg_opts))
            anchors.append(a)
            positives.append(p_)
            negatives.append(g)
        aux["anchor_idx"] = np.asarray(anchors, np.int32)
        aux["positive_idx"] = np.asarray(positives, np.int32)
        aux["negative_idx"] = np.asarray(negatives, np.int32)

    elif objective == "patch_based_image_swapping":
        # swap equal random patch subsets of two steps: a per-sample
        # permutation of the folded stream (1 + eff_n * grid^2 tokens)
        grid2 = cfg.patch_grid ** 2
        stream = 1 + eff_n * grid2
        flags = corrupt_flags()
        perms = np.tile(np.arange(stream, dtype=np.int32), (b, 1))
        for i in range(b):
            if not flags[i]:
                continue
            num_sub = int(rng.integers(0, grid2))
            if num_sub == 0:
                flags[i] = False
                continue
            x, y = sorted(rng.choice(eff_n, 2, replace=False))
            px = 1 + x * grid2 + rng.choice(grid2, num_sub, replace=False)
            py = 1 + y * grid2 + rng.choice(grid2, num_sub, replace=False)
            perms[i, px], perms[i, py] = perms[i, py].copy(), \
                perms[i, px].copy()
        aux["patch_perm"] = perms
        aux["objective_labels"] = (~flags).astype(np.int32)

    elif objective == "patch_based_image_sequence_predictions":
        # the patch-level analogue of image_sequence_predictions: a random
        # patch subset of ONE step replaced by patches of another sample's
        # folded stream; corrupted (0) vs intact (1)
        grid2 = cfg.patch_grid ** 2
        stream = 1 + eff_n * grid2
        flags = corrupt_flags()
        perms = np.tile(np.arange(stream, dtype=np.int32), (b, 1))
        srcs = np.tile(np.arange(b, dtype=np.int32)[:, None], (1, stream))
        for i in range(b):
            if b < 2 or not flags[i]:
                flags[i] = False
                continue
            num_sub = int(rng.integers(0, grid2))
            if num_sub == 0:
                flags[i] = False
                continue
            donor = int(rng.choice([j for j in range(b) if j != i]))
            x = int(rng.integers(eff_n))   # corrupted step (this sample)
            y = int(rng.integers(eff_n))   # donor step (other sample)
            px = 1 + x * grid2 + rng.choice(grid2, num_sub, replace=False)
            py = 1 + y * grid2 + rng.choice(grid2, num_sub, replace=False)
            perms[i, px] = py
            srcs[i, px] = donor
        aux["patch_perm"] = perms
        aux["patch_src"] = srcs
        aux["objective_labels"] = (~flags).astype(np.int32)

    elif objective == "patch_based_mrm_classification":
        # mask `mask_num` patches a step; the model must assign each masked
        # output to its shuffled original feature
        grid2 = cfg.patch_grid ** 2
        mask_num = 5
        total = mask_num * eff_n
        mask_idx = np.zeros((b, total), np.int32)
        shuffle_perm = np.zeros((b, total), np.int32)
        for i in range(b):
            cols = []
            for s in range(eff_n):
                cols.extend(1 + s * grid2
                            + rng.choice(grid2, mask_num, replace=False))
            mask_idx[i] = np.asarray(sorted(cols), np.int32)
            shuffle_perm[i] = rng.permutation(total)
        aux["mask_idx"] = mask_idx
        aux["shuffle_perm"] = shuffle_perm
        aux["mrm_mask_num"] = np.int32(mask_num)

    elif objective in ("swapping_based_nsp", "sequence_based_nsp"):
        # text-only analogues: permute language spans, classify corrupted
        flags = corrupt_flags()
        perms = []
        for i in range(b):
            perm = list(range(eff_n))
            if flags[i]:
                if objective == "swapping_based_nsp":
                    x, y = sorted(rng.choice(eff_n, 2, replace=False))
                    perm[x], perm[y] = perm[y], perm[x]
                else:
                    perm = list(rng.permutation(eff_n))
            perms.append(perm)
        lang = _repack_language(batch, perms, cfg.cls_id, cfg.pad_id,
                                cfg.mlm_ignore_index, eff_n)
        batch.update(lang)
        aux["objective_labels"] = (~flags).astype(np.int32)

    elif objective in ("no_mlm", "visual_mlm", "mlm_only"):
        pass  # the caller decides whether MLM runs

    else:
        raise NotImplementedError(
            f"pretraining objective {objective} not implemented")

    if images is not None:
        batch["images"] = images
    elif "images" in batch:
        batch.pop("images")
    return batch, aux


def choose_objective(objectives, rng: np.random.Generator) -> str:
    """One objective a batch, uniformly."""
    return str(rng.choice(list(objectives)))


def plan_itm_swap(images: np.ndarray, rng: np.random.Generator):
    """Swapping-based ITM of the fine-tune loop: each story, with p = 0.5
    (and a batch of more than one), has one step image replaced by the
    same step's image of the next story in the batch; target 1 = intact,
    0 = swapped. Returns (new_images, targets int32)."""
    b, n = images.shape[:2]
    out = images.copy()
    targets = np.ones(b, np.int32)
    for i in range(b):
        if rng.random() > 0.5 and b > 1:
            neighbor = (i + 1) % b
            s = int(rng.integers(n))
            out[i, s] = images[neighbor, s]
            targets[i] = 0
    return out, targets
