"""Masked-language-model masking on the host (copy of `train/mlm.py`).

Per sequence, each token that is neither padding nor a CLS token is masked
with `mlm_probability`; of the masked positions 80 % become the mask token,
10 % a random token from [cls_id + 1, vocab) and 10 % stay. Labels are
`ignore_index` everywhere but at masked positions. The draws are the JAX
package's, call for call (`rng.random` three times, then `rng.integers`),
so one `np.random.Generator` state gives the same masks in both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mask_tokens_sentence(
        input_ids: np.ndarray, *, mlm_probability: float, pad_id: int,
        cls_id: int, mask_id: int, vocab_size: int,
        ignore_index: int = -100,
        rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """input_ids: (B, L) int. Returns (masked_inputs, labels)."""
    inputs = input_ids.copy()
    labels = input_ids.copy()

    non_pad = inputs != pad_id
    is_cls = inputs == cls_id
    candidates = non_pad & ~is_cls

    masked = (rng.random(inputs.shape) < mlm_probability) & candidates
    labels[~masked] = ignore_index

    replaced = (rng.random(inputs.shape) < 0.8) & masked
    inputs[replaced] = mask_id

    random_mask = (rng.random(inputs.shape) < 0.5) & masked & ~replaced
    random_words = rng.integers(cls_id + 1, vocab_size, size=inputs.shape,
                                dtype=np.int64)
    inputs[random_mask] = random_words[random_mask]
    return inputs, labels
