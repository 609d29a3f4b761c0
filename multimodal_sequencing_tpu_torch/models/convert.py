"""Weights into the port (counterpart of `models/convert.py`, text
branch): from the JAX package's parameter tree, and from HF BERT/RoBERTa
checkpoints.

The port's modules carry the Flax module names, so a Flax path maps to the
same dotted state-dict key with its leaf renamed:
  Dense `kernel` (in, out)   -> Linear `weight` (out, in), transposed
  Embed `embedding`          -> Embedding `weight`
  LayerNorm `scale` / `bias` -> `weight` / `bias`
e.g. `encoder/layer_3/attention/query/kernel` ->
`encoder.layer_3.attention.query.weight`.

HF text weights (`--model_name_or_path <dir with pytorch_model.bin>`) map
by name onto the same keys; HF `Linear` weights are already (out, in), so
nothing is transposed. As in the JAX package, `model.safetensors` is found
but not read.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping

import numpy as np
import torch

from .config import MultimodalConfig
from .sequencer import SequencingModel

logger = logging.getLogger(__name__)

# the weights files a local HF model directory may hold, in the order the
# JAX package looks for them
HF_WEIGHTS_NAMES = ("pytorch_model.bin", "model.safetensors")

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


def strip_prefixes(state_dict: Dict, prefixes=("roberta.", "bert.",
                                               "module.")) -> Dict:
    """Drop the first matching prefix of each key (HF task models keep the
    encoder under `roberta.` or `bert.`, DataParallel under `module.`)."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def convert_hf_text_encoder(state_dict: Dict, num_layers: int
                            ) -> Dict[str, torch.Tensor]:
    """HF BertModel/RobertaModel state dict -> the port's `TextEncoder`
    state-dict entries. The token-type table and the pooler are included
    only when the file has them; a missing layer weight raises KeyError."""
    sd = strip_prefixes(state_dict)
    out: Dict[str, torch.Tensor] = {}

    def take(dst, src):
        out[dst] = torch.as_tensor(sd[src])

    def dense(dst, src):
        take(f"{dst}.weight", f"{src}.weight")
        take(f"{dst}.bias", f"{src}.bias")

    take("embeddings.word_embeddings.weight",
         "embeddings.word_embeddings.weight")
    take("embeddings.position_embeddings.weight",
         "embeddings.position_embeddings.weight")
    if "embeddings.token_type_embeddings.weight" in sd:
        take("embeddings.token_type_embeddings.weight",
             "embeddings.token_type_embeddings.weight")
    dense("embeddings.ln", "embeddings.LayerNorm")
    for i in range(num_layers):
        p, q = f"layer_{i}", f"encoder.layer.{i}"
        dense(f"{p}.attention.query", f"{q}.attention.self.query")
        dense(f"{p}.attention.key", f"{q}.attention.self.key")
        dense(f"{p}.attention.value", f"{q}.attention.self.value")
        dense(f"{p}.attention.out", f"{q}.attention.output.dense")
        dense(f"{p}.attention_ln", f"{q}.attention.output.LayerNorm")
        dense(f"{p}.intermediate", f"{q}.intermediate.dense")
        dense(f"{p}.output", f"{q}.output.dense")
        dense(f"{p}.output_ln", f"{q}.output.LayerNorm")
    if "pooler.dense.weight" in sd:
        dense("pooler", "pooler.dense")
    return out


def resize_token_type_embeddings(state_dict: Dict[str, torch.Tensor],
                                 new_size: int) -> Dict[str, torch.Tensor]:
    """`--replace_token_type_embeddings`: tile (or truncate) the token-type
    table to `new_size` rows, one per story step. A state dict without the
    table is returned as it is."""
    key = "embeddings.token_type_embeddings.weight"
    table = state_dict.get(key)
    if table is None:
        return state_dict
    reps = -(-new_size // table.shape[0])
    return {**state_dict, key: table.repeat(reps, 1)[:new_size].clone()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a flat state dict on the CPU (the file's
    dict, or the dict under its `state_dict` key). Tensors only: the file
    is loaded with `weights_only=True`, so no pickled code runs."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return dict(sd)


def load_pretrained_weights(model: SequencingModel, args) -> bool:
    """`--model_name_or_path <dir>` holding `pytorch_model.bin`: load its HF
    text weights into `model.encoder` in place (the token-type table tiled
    to `type_vocab_size` rows when that is above 2). Encoder weights the
    file lacks (a pooler, a token-type table) keep their init. Returns
    whether weights were loaded; a directory whose weights file is
    `model.safetensors` loads none, as in the JAX package."""
    path = getattr(args, "model_name_or_path", None)
    if not path or not os.path.isdir(path):
        return False
    found = [n for n in HF_WEIGHTS_NAMES
             if os.path.exists(os.path.join(path, n))]
    if not found:
        return False
    weights = os.path.join(path, found[0])
    if found[0] != "pytorch_model.bin":
        logger.warning("%s: only pytorch_model.bin is read (as in the JAX "
                       "package); no pretrained weights loaded", weights)
        return False
    enc_cfg = model.cfg.encoder
    text = convert_hf_text_encoder(load_torch_state_dict(weights),
                                   enc_cfg.num_hidden_layers)
    if enc_cfg.type_vocab_size > 2:
        text = resize_token_type_embeddings(text, enc_cfg.type_vocab_size)
    unexpected = model.encoder.load_state_dict(
        text, strict=False).unexpected_keys
    if unexpected:
        raise KeyError(f"HF weights the encoder has no place for: "
                       f"{unexpected[:5]}")
    logger.info("loaded HF text weights from %s", weights)
    return True
