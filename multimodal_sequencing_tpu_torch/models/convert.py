"""Move weights from the JAX package's parameter tree into the port
(counterpart of `models/convert.py`).

The port's modules carry the Flax module names, so a Flax path maps to the
same dotted state-dict key with its leaf renamed:
  Dense `kernel` (in, out)   -> Linear `weight` (out, in), transposed
  Embed `embedding`          -> Embedding `weight`
  LayerNorm `scale` / `bias` -> `weight` / `bias`
e.g. `encoder/layer_3/attention/query/kernel` ->
`encoder.layer_3.attention.query.weight`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import MultimodalConfig
from .sequencer import SequencingModel

_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
           "bias": "bias"}


def params_from_jax(params: Mapping, cfg: MultimodalConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX `SequencingModel` params (nested dicts of numpy arrays, with or
    without the outer `params` collection) -> a state dict for the port's
    `SequencingModel(cfg)`. Raises if the tree does not match the model."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path):
        for name, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (name,))
                continue
            if name not in _LEAVES:
                raise KeyError(f"unknown parameter leaf {'/'.join(path + (name,))}")
            arr = np.array(val, dtype=np.float32)  # a writable copy
            if name == "kernel":
                arr = arr.T
            out[".".join(path + (_LEAVES[name],))] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(params, ())
    with torch.device("meta"):
        want = SequencingModel(cfg).state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"parameter tree does not match the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    for key, t in want.items():
        if tuple(out[key].shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(out[key].shape)}, model "
                             f"wants {tuple(t.shape)}")
    return out
