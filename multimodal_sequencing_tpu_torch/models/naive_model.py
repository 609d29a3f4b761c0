"""Naive multimodal model: image features appended as extra tokens
(counterpart of `models/naive_model.py`).

Each step image runs the pooled vision tower (`--vision_model`: a ResNet's
pooled features or the FPN tower's flattened p6), is projected to the
hidden width by `img_project` with a ReLU, and is appended after the text
token embeddings as one more input embedding; the attention mask gets ones
for them. The combined stream runs through the text encoder's layers, then
the tanh pooler and the classification head `cls_head` (which the JAX
module always calls, so its parameters exist whatever the wrapper reads).
Under `multimodal_img_part` the text is one zero id with attention mask 0
and no token types. `img_project`'s input width is the tower's, which the
FPN tower's depends on the image size (`cfg.image_size`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import MultimodalConfig
from .encoder import (Dense, DropoutRng, Embeddings, TransformerLayer,
                      check_rng, remat_layer)
from .fpn import build_pooled_vision_tower, is_detectron2, pooled_feature_dim
from .heads import ClassificationHead
from ..ops.preprocess import images_to_nchw


def naive_encode_parts(cfg: MultimodalConfig, encoder, ids, attn, types,
                       images, deterministic: bool,
                       rng: Optional[DropoutRng] = None):
    """(lang, visn or None, pooled) of the naive model under the text_part
    and img_part ablations: no images under text_part, and the language is
    one token long under img_part. Shared by the sequencer and the
    pretrainer."""
    imgs = None if cfg.multimodal_text_part else images
    out = encoder(ids, attn, types, images=imgs, deterministic=deterministic,
                  rng=rng)
    seq = out["sequence_output"]
    length = 1 if cfg.multimodal_img_part else ids.shape[1]
    visn = seq[:, length:] if imgs is not None else None
    return seq[:, :length], visn, out["pooled_output"]


class NaiveMultimodalModel(nn.Module):
    def __init__(self, cfg: MultimodalConfig, vision_name: str = "resnet50"):
        super().__init__()
        self.cfg = cfg
        self.vision_name = vision_name
        ecfg = cfg.encoder
        dt = ecfg.compute_dtype
        self.embeddings = Embeddings(ecfg)
        if not cfg.multimodal_text_part:
            self.vision_model = build_pooled_vision_tower(vision_name, dt)
            self.img_project = Dense(
                pooled_feature_dim(vision_name, cfg.image_size),
                ecfg.hidden_size, dt)
        for i in range(ecfg.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(ecfg))
        self.pooler = Dense(ecfg.hidden_size, ecfg.hidden_size, dt)
        self.cls_head = ClassificationHead(
            cfg.num_labels, ecfg.hidden_size, ecfg.hidden_dropout_prob, dt)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                images: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = check_rng(deterministic, rng)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if cfg.multimodal_img_part:
            input_ids = torch.zeros_like(input_ids[:, :1])
            attention_mask = torch.zeros_like(attention_mask[:, :1])
            token_type_ids = None
        x = self.embeddings(input_ids, token_type_ids, rng)
        mask = attention_mask.to(torch.int32)
        if images is not None:
            b, n = images.shape[:2]
            feats = self.vision_model(
                images_to_nchw(images, "detectron2_bgr"
                               if is_detectron2(self.vision_name)
                               else "imagenet"), deterministic)
            if cfg.freeze_vision_model:
                feats = feats.detach()
            proj = F.relu(self.img_project(feats)).reshape(b, n, -1)
            x = torch.cat([x, proj.to(x.dtype)], 1)
            mask = torch.cat([mask, torch.ones((b, n), dtype=torch.int32,
                                               device=mask.device)], 1)
        remat = cfg.encoder.remat and torch.is_grad_enabled()
        for i in range(cfg.encoder.num_hidden_layers):
            layer = getattr(self, f"layer_{i}")
            x = (remat_layer(layer, x, mask, rng) if remat
                 else layer(x, mask, rng))
        pooled = torch.tanh(self.pooler(x[:, 0]))
        logits = self.cls_head(pooled, rng)
        return {"sequence_output": x, "pooled_output": pooled,
                "logits": logits.float()}
