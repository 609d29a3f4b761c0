"""Synthetic WikiHow-schema stories, made from the seed.

A traffic file sets the pool (`pool_stories`), the steps a story
(`steps_per_story`), the words a step (`words`: a [low, high] range,
drawn uniformly, from a fixed list of instructional verbs) and the step
images (`images_per_story`, each `image_size` square: blocks of random
colour, made once in set-up as uint8 arrays, so no image is decoded in
the window).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

WORDS = ("gather measure cut sand paint attach tighten clean check wait mark "
         "drill fold press rinse dry lift turn slide align glue clamp trim "
         "wipe pour stir heat cool fill empty open close label store").split()

IMAGE_BLOCKS = 8


def make_pool(traffic: Dict, seed: int
              ) -> Tuple[List[List[str]], Optional[np.ndarray]]:
    """(stories: each a list of step texts, images (stories, steps, H, W, 3)
    uint8 or None)."""
    rng = np.random.default_rng(seed)
    n, steps = traffic["pool_stories"], traffic["steps_per_story"]
    lo, hi = traffic["words"]
    sizes = rng.integers(lo, hi + 1, size=(n, steps))
    words = np.asarray(WORDS)
    stories = [[" ".join(words[rng.integers(0, len(words), size=int(k))])
                + "." for k in row] for row in sizes]
    k = traffic.get("images_per_story", 0)
    if not k:
        return stories, None
    size = traffic["image_size"]
    blocks = rng.integers(0, 256, (n, k, IMAGE_BLOCKS, IMAGE_BLOCKS, 3),
                          dtype=np.uint8)
    rep = size // IMAGE_BLOCKS
    images = np.repeat(np.repeat(blocks, rep, axis=2), rep, axis=3)
    return stories, np.ascontiguousarray(images)
