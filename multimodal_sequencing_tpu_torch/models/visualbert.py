"""VisualBERT-style encoder: one visual token per step image (counterpart of
`models/visualbert.py`).

  text embeddings -----------------------------------------------+
                                                                 +-> [lang; visn]
  ResNet / FPN tower -> pooled feature a step (+ R regional)     |   -> layers
    -> projection + step type + position -> LayerNorm (f32) -----+   -> pooler

The step images run the ResNet tower (`--vision_model resnet*`, pooled
features) or the detectron2-style FPN tower (`detectron2_*`, the flattened
p6 map). With `num_img_regional_features` K each step gets R regional
tokens after its image token, projected to the image feature's width by
`regional_proj`: from the `{img}_maskrcnn.npy` sidecars (a (B, N, R, C)
batch), or, for an FPN tower given no sidecars, from the tower's own ROI
features (inline ROI: K proposals, K + 1 without
`include_full_img_features`, whose top ROI then stands for the image). A
sidecar batch that is not 4-D (the dataset's `zeros(1)` sentinel of a story
with a missing sidecar) adds no regional tokens and starts no inline ROI.
`bypass_transformer` runs the layers over the text alone and fuses the
visual tokens through one `additional_layer`. `multimodal_img_part` cuts
the language to its CLS token, `multimodal_text_part` drops the visual
stream.

The JAX package creates some modules depending on the call its init
traces; here the config and the caller decide them. `regional_proj` exists
whenever K is set, its input width the sidecars' (`cfg.visual_feat_dim`)
for a ResNet tower and the box head's (`vision_feature_dim`, default 2048)
for an FPN tower, which both inline ROI and the sidecar extractor give. An
FPN tower with K runs inline ROI only where the caller builds the encoder
with `inline_roi`: BERSON and the pretrainer, which never pass sidecars
(their towers get the objectness and box heads). The sequencer builds it
without: its datasets always carry the sidecars or, where one is missing,
the sentinel, so in the JAX package too its fine-tuning never reaches
inline ROI, and its tower is the backbone-only one JAX's init builds from
such a batch. A sidecar of another width raises ValueError, as do sidecars
given to an inline tower without `include_full_img_features` (whose image
feature, the top ROI, is sized for inline ROI) and an FPN sequencer with K
given neither sidecars nor the sentinel.

Dtypes follow Flax: the visual embeddings' LayerNorm has no dtype, so it
returns f32 under a bf16 encoder, and the joint stream [lang; visn] is
promoted to f32, as `jnp.concatenate` promotes; the first layer's residual
and `attention_ln` input are then f32 (its output the compute dtype). The
towers' BatchNorms update their statistics in training, frozen or not;
`freeze_vision_model` detaches the tower's features.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import MultimodalConfig
from .encoder import (Dense, DropoutRng, Embed, Embeddings, LayerNorm,
                      TransformerLayer, check_rng, dropout, remat_layer)
from .fpn import (FPNVisionTower, backbone_from_name, full_img_feature_dim,
                  is_detectron2)
from .resnet import ResNetBackbone, resnet_feature_dim
from ..ops.preprocess import images_to_nchw


class VisioLinguisticVisualEmbeddings(nn.Module):
    """Projection + visual token-type + position embeddings + LayerNorm
    (eps 1e-12, in f32) + dropout."""

    # `init_weights` draws these raw parameters from a normal of this std
    normal_init = {"position_embeddings": 0.02}

    def __init__(self, feat_dim: int, hidden_size: int,
                 max_story_length: int, max_positions: int = 256,
                 dropout_p: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_p = dropout_p
        self.projection = Dense(feat_dim, hidden_size, dtype)
        self.token_type_embeddings = Embed(max_story_length, hidden_size,
                                           dtype)
        self.position_embeddings = nn.Parameter(
            torch.zeros(max_positions, hidden_size))
        self.ln = LayerNorm(hidden_size, 1e-12,
                            torch.promote_types(dtype, torch.float32))

    def forward(self, feats: torch.Tensor, type_ids: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = self.projection(feats) + self.token_type_embeddings(type_ids)
        x = x + self.position_embeddings[:x.shape[1]][None].to(x.dtype)
        return dropout(self.ln(x.to(self.ln.compute_dtype)), self.dropout_p,
                       rng)


def _cat_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=1)


class VisualBERTEncoder(nn.Module):
    """Text tokens + per-step visual tokens through the shared layers;
    returns (lang_out, visn_out or None, pooled)."""

    def __init__(self, cfg: MultimodalConfig, inline_roi: bool = True):
        super().__init__()
        self.cfg = cfg
        ecfg = cfg.encoder
        dt = ecfg.compute_dtype
        k = cfg.num_img_regional_features
        self.embeddings = Embeddings(ecfg)
        if not cfg.multimodal_text_part:
            if is_detectron2(cfg.vision_model):
                box_dim = cfg.vision_feature_dim or 2048
                stride = (True if cfg.vision_stride_in_1x1 is None
                          else cfg.vision_stride_in_1x1)
                self.inline_roi = bool(k and inline_roi)
                self.vision_model = FPNVisionTower(
                    backbone_from_name(cfg.vision_model),
                    feature_dim=box_dim,
                    num_regional_features=(
                        (k if cfg.include_full_img_features else k + 1)
                        if self.inline_roi else None),
                    pool_full_img=cfg.include_full_img_features,
                    stride_in_1x1=stride, dtype=dt)
                feat_dim = (box_dim if self.inline_roi
                            and not cfg.include_full_img_features
                            else full_img_feature_dim(
                                cfg.image_size, cfg.include_full_img_features))
                regional_dim = box_dim
            else:
                self.vision_model = ResNetBackbone(cfg.vision_model, dt)
                feat_dim = resnet_feature_dim(cfg.vision_model)
                regional_dim = cfg.visual_feat_dim
            if k:
                self.regional_proj = Dense(regional_dim, feat_dim, dt)
            self.visual_embeddings = VisioLinguisticVisualEmbeddings(
                feat_dim, ecfg.hidden_size, cfg.max_story_length,
                dropout_p=ecfg.hidden_dropout_prob, dtype=dt)
        for i in range(ecfg.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(ecfg))
        if cfg.bypass_transformer and not cfg.multimodal_text_part:
            self.additional_layer = TransformerLayer(ecfg)
        self.pooler = Dense(ecfg.hidden_size, ecfg.hidden_size, dt)

    def encode_visual(self, images: torch.Tensor,
                      img_regional_features: Optional[torch.Tensor],
                      deterministic: bool, rng: Optional[DropoutRng]
                      ) -> torch.Tensor:
        """(B, N, ...) step images (and sidecars) -> the visual embeddings
        (B, N * (1 + R), hidden), f32 under a bf16 encoder."""
        cfg = self.cfg
        b, n = images.shape[:2]
        d2 = is_detectron2(cfg.vision_model)
        x = images_to_nchw(images, "detectron2_bgr" if d2 else "imagenet")
        regional = img_regional_features
        if d2 and cfg.num_img_regional_features and regional is None:
            if not self.inline_roi:
                raise ValueError(
                    "this VisualBERT encoder's FPN tower takes the ROI "
                    "sidecars (or the zeros(1) sentinel of a missing one), "
                    "as the sequencer's datasets give them; it was built "
                    "without inline ROI")
            feats, reg, _, _ = self.vision_model(x, deterministic)
            if not cfg.include_full_img_features:
                # the top ROI stands for the image, the next K follow
                feats, reg = reg[:, 0], reg[:, 1:]
            regional = reg.reshape(b, n, -1, reg.shape[-1])
            if cfg.freeze_vision_model:
                regional = regional.detach()
        elif d2:
            if self.inline_roi and not cfg.include_full_img_features:
                raise ValueError(
                    "an inline-ROI FPN tower without "
                    "--include_full_img_features takes each image's feature "
                    "from its top ROI; it cannot take sidecars")
            feats = self.vision_model(x, deterministic, regional=False)
        else:
            feats = self.vision_model(x, deterministic)
        if cfg.freeze_vision_model:
            feats = feats.detach()
        feats = feats.reshape(b, n, -1)
        type_ids = torch.arange(n, device=feats.device)[None].expand(b, n)
        if (cfg.num_img_regional_features and regional is not None
                and regional.dim() == 4):
            proj = self.regional_proj
            if regional.shape[-1] != proj.in_features:
                raise ValueError(
                    f"regional features of width {regional.shape[-1]}; the "
                    f"encoder's regional_proj takes {proj.in_features}")
            r = regional.shape[2]
            feats = torch.cat([feats[:, :, None], proj(regional)], 2).reshape(
                b, n * (1 + r), -1)
            type_ids = type_ids.repeat_interleave(1 + r, dim=1)
        return self.visual_embeddings(feats, type_ids, rng)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                images: Optional[torch.Tensor] = None,
                img_regional_features: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None):
        cfg = self.cfg
        rng = check_rng(deterministic, rng)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if cfg.multimodal_img_part:
            input_ids = input_ids[:, :1]
            attention_mask = attention_mask[:, :1]
            if token_type_ids is not None:
                token_type_ids = token_type_ids[:, :1]
        lang = self.embeddings(input_ids, token_type_ids, rng)
        lang_len = lang.shape[1]
        mask = attention_mask.to(torch.int32)
        visn = None
        if images is not None and not cfg.multimodal_text_part:
            visn = self.encode_visual(images, img_regional_features,
                                      deterministic, rng)
            joint_mask = torch.cat([mask, torch.ones(
                visn.shape[:2], dtype=torch.int32, device=mask.device)], 1)
        bypass = visn is not None and cfg.bypass_transformer
        joint = lang
        if visn is not None and not bypass:
            joint, mask = _cat_promoted(lang, visn), joint_mask
        remat = cfg.encoder.remat and torch.is_grad_enabled()
        for i in range(cfg.encoder.num_hidden_layers):
            layer = getattr(self, f"layer_{i}")
            joint = (remat_layer(layer, joint, mask, rng) if remat
                     else layer(joint, mask, rng))
        if bypass:
            # the layers saw the text alone; one more fuses the visual tokens
            joint = self.additional_layer(_cat_promoted(joint, visn),
                                          joint_mask, rng)
        lang_out = joint[:, :lang_len]
        visn_out = joint[:, lang_len:] if visn is not None else None
        pooled = torch.tanh(self.pooler(lang_out[:, 0]))
        return lang_out, visn_out, pooled
