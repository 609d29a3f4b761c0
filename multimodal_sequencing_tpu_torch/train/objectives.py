"""Objective planners on the host (copy of `train/objectives.py`, the
`time_contrastive` branch of `plan_objective`).

BERSON's `--additional_wrapper_level_objectives time_contrastive` draws,
for every story of a batch, an anchor time step, a positive next to it and
a negative at least two steps away (the farthest end when a short story
has none), from the same `np.random.Generator` calls as the JAX package, so
one seed gives the same triplets. The other objectives are pretraining's
and come with that slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def plan_objective(objective: str, batch: Dict[str, np.ndarray], cfg,
                   rng: np.random.Generator, subsample_len: int = 2
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(batch, aux) for `objective`; aux carries the objective's index
    plans. Only `time_contrastive` is ported: anchor_idx, positive_idx and
    negative_idx, (B,) int32 time steps of each story."""
    if objective != "time_contrastive":
        raise NotImplementedError(
            f"objective {objective!r}: the pretraining objectives come with "
            f"a later slice of the port (ROADMAP A4)")
    batch = dict(batch)
    n = cfg.max_story_length
    b = batch["input_ids"].shape[0]
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
    aux = {"eff_n": np.int32(n),
           "anchor_idx": np.asarray(anchors, np.int32),
           "positive_idx": np.asarray(positives, np.int32),
           "negative_idx": np.asarray(negatives, np.int32)}
    return batch, aux
