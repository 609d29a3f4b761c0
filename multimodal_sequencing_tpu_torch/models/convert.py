"""Weights into the port (counterpart of `models/convert.py`): from the JAX
package's variable trees, from HF BERT/RoBERTa checkpoints, from OpenAI
CLIP visual weights, and from torchvision ResNet and detectron2 ResNet-FPN
files.

The port's modules carry the Flax module names, so a Flax path maps to the
same dotted state-dict key with its leaf renamed:
  Dense `kernel` (in, out)        -> Linear `weight` (out, in), transposed
  DenseGeneral `kernel` of `nn.MultiHeadDotProductAttention`: query, key,
    value (in, heads, head_dim), out (heads, head_dim, out) -> Linear
    `weight` (heads * head_dim, in) and (out, heads * head_dim); their
    (heads, head_dim) biases flattened
  Conv `kernel` (kh, kw, in, out) -> Conv2d `weight` (out, in, kh, kw)
  Embed `embedding`               -> Embedding `weight`
  LayerNorm/BatchNorm `scale`     -> `weight`; `bias` -> `bias`
  raw `positional_embedding`, `class_embedding`, `proj`, `pos_emb`,
    `position_embeddings` (VisualBERT's visual positions) -> the same name
and the `batch_stats` tree's BatchNorm `mean` / `var` -> the buffers
`running_mean` / `running_var`; e.g. `encoder/layer_3/attention/query/
kernel` -> `encoder.layer_3.attention.query.weight`. The LSTM of BERSON's
pointer keeps Flax's eight Denses (`decoder/ii`, ..., `decoder/ho`), so it
needs no rule of its own, nor do p1's `pointer_head/lstm_pointer/cell`
and the attention layers of p0 and pure_decode (`self_attn`, `cross_attn`:
the DenseGeneral rule).

HF text weights (`--model_name_or_path <dir with pytorch_model.bin>`) map
by name onto the same keys of either encoder layout (the multimodal
encoder keeps the text encoder's names); HF `Linear` weights are already
(out, in), so nothing is transposed. As in the JAX package,
`model.safetensors` is found but not read.

OpenAI CLIP visual weights (`--clip_visual_model_weights <file>`, the
`visual.*` keys) load into the tower with little renaming, torch layouts
being the port's own (`convert_clip_rn50`, `convert_clip_vit`). A
directory given there is a checkpoint of this package, whose tower
weights and BatchNorm statistics are read.

`--vision_model_checkpoint <file>` loads the VisualBERT or naive encoder's
`vision_model`: a torchvision ResNet state dict
(`resnet.py::convert_torchvision_resnet`), or for a `detectron2_*` tower a
detectron2 model-zoo file, `.pkl` or `.pth` (`load_detectron2_state_dict`,
`convert_detectron2_fpn`), of which only the parts the built tower has are
grafted (the objectness and box heads exist in regional mode alone); a
part whose shapes differ from the tower's raises ValueError. BatchNorm
statistics go into the buffers. A path that does not exist is ignored, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .config import CLIPVisionConfig, MultimodalConfig
from .sequencer import SequencingModel

logger = logging.getLogger(__name__)

# the weights files a local HF model directory may hold, in the order the
# JAX package looks for them
HF_WEIGHTS_NAMES = ("pytorch_model.bin", "model.safetensors")

_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
           "bias": "bias", "positional_embedding": "positional_embedding",
           "class_embedding": "class_embedding", "proj": "proj",
           "pos_emb": "pos_emb",
           "position_embeddings": "position_embeddings"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def tree_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """A Flax `params` tree (and `batch_stats` tree) -> state-dict entries
    by the leaf rules above. An unknown leaf raises KeyError."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path, leaves):
        for name, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (name,), leaves)
                continue
            if name not in leaves:
                raise KeyError(f"unknown parameter leaf "
                               f"{'/'.join(path + (name,))}")
            arr = np.array(val, dtype=np.float32)  # a writable copy
            if name == "kernel" and arr.ndim == 4:  # Conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif name == "kernel" and arr.ndim == 3:  # DenseGeneral
                arr = (arr.reshape(-1, arr.shape[-1]) if path[-1] == "out"
                       else arr.reshape(arr.shape[0], -1)).T
            elif name == "kernel":  # Dense (in, out)
                arr = arr.T
            elif name == "bias" and arr.ndim == 2:  # DenseGeneral (h, d)
                arr = arr.reshape(-1)
            out[".".join(path + (leaves[name],))] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(params, (), _LEAVES)
    if batch_stats:
        walk(batch_stats, (), _STAT_LEAVES)
    return out


def params_from_jax(params: Mapping, cfg: MultimodalConfig,
                    batch_stats: Optional[Mapping] = None,
                    vision_cfg: Optional[CLIPVisionConfig] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX `SequencingModel`, `EncoderIndexDecoder`, `BersonOrdering` or
    `SequencingPretrainer` params (nested dicts of numpy arrays, with or
    without the outer `params` collection) and, for a model with
    BatchNorms, its `batch_stats` tree -> a state dict for the port's model
    of the same class, which the tree picks: `BersonOrdering(cfg,
    vision_cfg)` when it has BERSON's `inner` encoder (with its image-stream
    pairwise head when it has `img_projection`), `EncoderIndexDecoder(cfg)`
    when it has pure_decode's `lm_head`, `SequencingModel(cfg, vision_cfg)`
    when it has a sequencer head (`heatmap_head`, `pointer_head`, or the v0
    `cls_head`, whose Dense kernels `dense` and `out_proj` transpose as
    every Dense does; `cfg` gives the version, `num_labels` and the
    `hl_include_objectives` whose `aux_heads` and `aux_mlm_head` the tree
    holds), else
    `SequencingPretrainer(cfg, vision_cfg)`, its cfg's objectives those
    whose heads the tree holds (`mlm_head`, `{objective}_mlp`,
    `margin_loss_mlp`, `mrm_*`). Raises if the trees do not match the
    model."""
    if "params" in params:
        params = params["params"]
    if batch_stats is not None and "batch_stats" in batch_stats:
        batch_stats = batch_stats["batch_stats"]
    out = tree_to_state_dict(params, batch_stats)
    with torch.device("meta"):
        want = _model_of_tree(params, cfg, vision_cfg).state_dict()
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


def _model_of_tree(params: Mapping, cfg: MultimodalConfig,
                   vision_cfg: Optional[CLIPVisionConfig]) -> torch.nn.Module:
    """The port's model whose parameters a JAX tree holds."""
    from .berson import BersonOrdering
    from .pretrainer import SequencingPretrainer
    from .pure_decode import EncoderIndexDecoder
    if "inner" in params:
        return BersonOrdering(cfg, vision_cfg,
                              multimodal_loss="img_projection" in params)
    if "lm_head" in params:
        return EncoderIndexDecoder(cfg)
    if {"heatmap_head", "pointer_head", "cls_head"} & set(params):
        return SequencingModel(cfg, vision_cfg)
    objectives = [("margin_loss" if k == "margin_loss_mlp" else k[:-4])
                  for k in params if k.endswith("_mlp")]
    if "mrm_dense" in params:
        objectives.append("patch_based_mrm_classification")
    return SequencingPretrainer(dataclasses.replace(
        cfg, multimodal_pretrain_objectives=objectives), vision_cfg)


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


# ----- CLIP visual towers ---------------------------------------------------


def filter_visual_state_dict(state_dict: Dict) -> Dict:
    """The `--clip_visual_model_weights` filtered load: only the
    `visual.`-prefixed weights, with everything up to that prefix
    dropped."""
    out = {}
    for k, v in state_dict.items():
        m = re.search(r"(?:^|\.)visual\.(.*)$", k)
        if m:
            out[m.group(1)] = v
    return out


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).clone()


def convert_clip_vit(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP ViT `visual.*` weights (prefix stripped) -> the tower's
    state-dict entries under `vit.`."""
    sd = state_dict
    out = {f"vit.{k}": _t(sd[k]) for k in (
        "conv1.weight", "class_embedding", "positional_embedding",
        "ln_pre.weight", "ln_pre.bias", "ln_post.weight", "ln_post.bias",
        "proj")}
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        src, dst = f"transformer.resblocks.{i}", f"vit.resblock_{i}"
        for a, b in (("ln_1", "ln_1"), ("ln_2", "ln_2"),
                     ("attn.out_proj", "attn_out"), ("mlp.c_fc", "c_fc"),
                     ("mlp.c_proj", "c_proj")):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{b}.{leaf}"] = _t(sd[f"{src}.{a}.{leaf}"])
        out[f"{dst}.qkv.weight"] = _t(sd[f"{src}.attn.in_proj_weight"])
        out[f"{dst}.qkv.bias"] = _t(sd[f"{src}.attn.in_proj_bias"])
        i += 1
    return out


def convert_clip_rn50(state_dict: Dict, layers=(3, 4, 6, 3)
                      ) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP ModifiedResNet `visual.*` weights (prefix stripped) ->
    the tower's state-dict entries under `resnet.`, BatchNorm running
    statistics included (`num_batches_tracked` is dropped)."""
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}

    def bn(dst, src):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"resnet.{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])

    for i in (1, 2, 3):
        out[f"resnet.conv{i}.weight"] = _t(sd[f"conv{i}.weight"])
        bn(f"bn{i}", f"bn{i}")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            src, dst = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for c in (1, 2, 3):
                out[f"resnet.{dst}.conv{c}.weight"] = _t(
                    sd[f"{src}.conv{c}.weight"])
                bn(f"{dst}.bn{c}", f"{src}.bn{c}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"resnet.{dst}.downsample_conv.weight"] = _t(
                    sd[f"{src}.downsample.0.weight"])
                bn(f"{dst}.downsample_bn", f"{src}.downsample.1")
    out["resnet.attnpool.positional_embedding"] = _t(
        sd["attnpool.positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        for leaf in ("weight", "bias"):
            out[f"resnet.attnpool.{proj}.{leaf}"] = _t(
                sd[f"attnpool.{proj}.{leaf}"])
    return out


# ----- detectron2 ResNet-FPN towers ------------------------------------------


def load_detectron2_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A detectron2 checkpoint as numpy arrays: `model_final_*.pkl` files
    are pickles of a `model` dict of numpy arrays, `.pth` files torch
    checkpoints (read with `weights_only=True`); either may hold the state
    dict under `model`."""
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            payload = pickle.load(f, encoding="latin1")
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model" in payload:
        payload = payload["model"]
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in payload.items()}


def convert_detectron2_fpn(state_dict: Dict, backbone_name: str = "resnet50",
                           roi_size: int = 7) -> Dict[str, torch.Tensor]:
    """Detectron2 model-zoo ResNet-FPN weights -> `FPNVisionTower`
    state-dict entries: `backbone.bottom_up.*` (stem and res2..res5, the
    FrozenBN statistics as running statistics) -> `bottom_up`,
    `backbone.fpn_lateral{2..5}` / `fpn_output{2..5}` -> `fpn`, the RPN's
    shared conv -> `obj_conv` and its square (ratio 1.0, the middle) anchor
    channel of `objectness_logits` -> `obj_logit`, `roi_heads.box_head.fc1`
    / `fc2` -> `box_fc1` / `box_fc2`, fc1's input columns permuted from
    detectron2's (C, s, s) ROI flattening to the tower's (s, s, C). The RPN
    deltas and the box predictor have no counterpart and are dropped. The
    torch layouts are the tower's own, so no kernel is transposed."""
    from .resnet import _SPECS, BasicBlock
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}

    def conv(dst, src, bias=False):
        out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])

    def frozen_bn(dst, src):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])

    bu = "backbone.bottom_up"
    block_cls, layers, _ = _SPECS[backbone_name]
    n_convs = 2 if block_cls is BasicBlock else 3
    conv("bottom_up.conv1", f"{bu}.stem.conv1")
    frozen_bn("bottom_up.bn1", f"{bu}.stem.conv1.norm")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            src = f"{bu}.res{stage + 2}.{b}"
            dst = f"bottom_up.layer{stage + 1}_{b}"
            for c in range(1, n_convs + 1):
                conv(f"{dst}.conv{c}", f"{src}.conv{c}")
                frozen_bn(f"{dst}.bn{c}", f"{src}.conv{c}.norm")
            if f"{src}.shortcut.weight" in sd:
                conv(f"{dst}.downsample_conv", f"{src}.shortcut")
                frozen_bn(f"{dst}.downsample_bn", f"{src}.shortcut.norm")
    for lvl in (2, 3, 4, 5):
        conv(f"fpn.lateral_c{lvl}", f"backbone.fpn_lateral{lvl}", bias=True)
        conv(f"fpn.output_p{lvl}", f"backbone.fpn_output{lvl}", bias=True)
    rpn = "proposal_generator.rpn_head"
    if f"{rpn}.conv.weight" in sd:
        conv("obj_conv", f"{rpn}.conv", bias=True)
        w = _t(sd[f"{rpn}.objectness_logits.weight"])  # (A, C, 1, 1)
        mid = w.shape[0] // 2  # ratios (0.5, 1.0, 2.0) -> 1.0
        out["obj_logit.weight"] = w[mid:mid + 1].clone()
        out["obj_logit.bias"] = _t(
            sd[f"{rpn}.objectness_logits.bias"])[mid:mid + 1].clone()
    bh = "roi_heads.box_head"
    if f"{bh}.fc1.weight" in sd:
        w1 = _t(sd[f"{bh}.fc1.weight"])  # (D, C * s * s)
        d = w1.shape[0]
        w1 = w1.reshape(d, -1, roi_size, roi_size).permute(0, 2, 3, 1)
        out["box_fc1.weight"] = w1.reshape(d, -1).contiguous()
        out["box_fc1.bias"] = _t(sd[f"{bh}.fc1.bias"])
        conv("box_fc2", f"{bh}.fc2", bias=True)
    return out


def _load_vision_model_checkpoint(model, path: str) -> None:
    """`--vision_model_checkpoint`: a torchvision ResNet file, or for a
    detectron2 tower a detectron2 file whose parts the tower has, into the
    encoder's `vision_model` (see the module docstring)."""
    from .fpn import backbone_from_name, is_detectron2
    from .resnet import convert_torchvision_resnet
    cfg = model.cfg
    tower = encoder_of(model).vision_model
    if not is_detectron2(cfg.vision_model):
        tower.load_state_dict(convert_torchvision_resnet(
            load_torch_state_dict(path), cfg.vision_model))
        return
    weights = convert_detectron2_fpn(load_detectron2_state_dict(path),
                                     backbone_from_name(cfg.vision_model))
    have = tower.state_dict()
    grafted = {}
    for key, val in weights.items():
        part = key.split(".")[0]
        if not any(k.split(".")[0] == part for k in have):
            continue  # a head the tower does not have
        if key not in have or tuple(have[key].shape) != tuple(val.shape):
            raise ValueError(
                f"detectron2 weights for {part!r} do not match the built "
                f"tower ({key}: {tuple(val.shape)}, the tower has "
                f"{tuple(have[key].shape) if key in have else 'none'}; set "
                f"--vision_feature_dim to the checkpoint's box-head width)")
        grafted[key] = val
    tower.load_state_dict(grafted, strict=False)


def encoder_of(model) -> torch.nn.Module:
    """The text or multimodal encoder of a model: `inner` of BERSON,
    `encoder` of the sequencer."""
    return model.inner if hasattr(model, "inner") else model.encoder


def _load_clip_visual_weights(model, path: str) -> None:
    """`--clip_visual_model_weights`: OpenAI CLIP weights (a file) or the
    tower of a checkpoint of this package (a directory holding `model.pt`,
    of the sequencer or of BERSON) into the encoder's `visual_model`,
    BatchNorm statistics included."""
    tower = encoder_of(model).visual_model
    if os.path.isdir(path):
        from ..train.checkpoint import WEIGHTS_NAME
        sd = load_torch_state_dict(os.path.join(path, WEIGHTS_NAME))
        weights = {}
        for prefix in ("encoder.visual_model.", "inner.visual_model."):
            weights = {k[len(prefix):]: v for k, v in sd.items()
                       if k.startswith(prefix)}
            if weights:
                break
    else:
        sd = filter_visual_state_dict(load_torch_state_dict(path))
        if tower.cfg.is_resnet:
            weights = convert_clip_rn50(sd, tower.cfg.layers)
        else:
            weights = convert_clip_vit(sd)
    tower.load_state_dict(weights)


def load_pretrained_weights(model, args) -> bool:
    """Pretrained weights into `model` (the sequencer or BERSON) in place;
    returns whether any were loaded.

    `--model_name_or_path <dir>` holding `pytorch_model.bin`: its HF text
    weights into the encoder (`encoder_of`: BERSON's `inner`, as the JAX
    package's `apply_pretrained_to_state(..., encoder_key="inner")`), text
    or multimodal (the token-type table
    tiled to `type_vocab_size` rows when that is above 2). Encoder weights
    the file lacks (a pooler, a token-type table) keep their init; a
    directory whose weights file is `model.safetensors` loads none, as in
    the JAX package. `--clip_visual_model_weights <file or dir>` (an
    existing path; the JAX package ignores a missing one): the CLIP tower's
    weights (`_load_clip_visual_weights`). `--vision_model_checkpoint
    <file>` (an existing path): the VisualBERT or naive encoder's
    `vision_model` (`_load_vision_model_checkpoint`)."""
    loaded = _load_hf_text_weights(model, args)
    vc = getattr(args, "vision_model_checkpoint", None)
    if vc and hasattr(encoder_of(model), "vision_model"):
        if os.path.exists(vc):
            _load_vision_model_checkpoint(model, vc)
            logger.info("loaded vision backbone weights from %s", vc)
            loaded = True
        else:
            logger.warning("--vision_model_checkpoint %s does not exist; "
                           "ignored, as in the JAX package", vc)
    cw = getattr(args, "clip_visual_model_weights", None)
    if cw and hasattr(encoder_of(model), "visual_model"):
        if os.path.exists(cw):
            _load_clip_visual_weights(model, cw)
            logger.info("loaded CLIP visual weights from %s", cw)
            loaded = True
        else:
            logger.warning("--clip_visual_model_weights %s does not exist; "
                           "ignored, as in the JAX package", cw)
    return loaded


def _load_hf_text_weights(model, args) -> bool:
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
    unexpected = encoder_of(model).load_state_dict(
        text, strict=False).unexpected_keys
    if unexpected:
        raise KeyError(f"HF weights the encoder has no place for: "
                       f"{unexpected[:5]}")
    logger.info("loaded HF text weights from %s", weights)
    return True
