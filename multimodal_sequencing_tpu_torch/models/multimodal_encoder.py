"""Single-stream multimodal encoder (counterpart of
`models/multimodal_encoder.py`): the CLIP tower's folded visual stream,
projected into the text width with 2-D position and per-step token-type
embeddings, runs with the text tokens through the shared transformer
layers.

  text embeddings ------------------------------------------+
                                                            +-> [lang; visn]
  CLIP tower -> + x/y position -> + step type -> visn_fc ---+   -> layers
                                                                -> pooler

Three modes, as in the JAX package: `multimodal_text_part` (no visual
stream), `multimodal_img_part` (language cut to its CLS token) and the full
joint stream. The forward runs in three parts, as JAX's does:
`embed_language`, `encode_visual` and `joint_encode`; the pretrainer does
its patch surgery on the visual stream between the last two. The text children keep `TextEncoder`'s names (`embeddings`,
`layer_{i}`, `pooler`), so the HF text loaders and `params_from_jax` map
both layouts alike. The joint mask is the text mask followed by ones, and
the joint layers are the text encoder's `TransformerLayer`s (remat
included), so every attention call on the card goes through the flash
kernels.

`freeze_vision_model` detaches the tower's output: its parameters get no
gradient (the optimizer fills zeros, and they still decay), while its
BatchNorm statistics still update in training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .config import CLIPVisionConfig, MultimodalConfig, clip_vision_config
from .clip_visual import CLIPVisualTower
from .encoder import (Dense, DropoutRng, Embed, Embeddings, LayerNorm,
                      TransformerLayer, check_rng, dropout, remat_layer)
from ..ops.preprocess import images_to_nchw


class VisualFeatEncoder(nn.Module):
    """Dense (compute dtype) + LayerNorm (eps 1e-12) + dropout into the text
    width. The LayerNorm returns its input promoted with its f32
    parameters (f32 for a bf16 encoder), as Flax's without a dtype does;
    the joint stream casts the result to the compute dtype."""

    def __init__(self, feat_dim: int, hidden_size: int, dropout_p: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dropout_p = dropout_p
        ln_dtype = torch.promote_types(dtype, torch.float32)
        self.visn_fc = Dense(feat_dim, hidden_size, dtype)
        self.visn_ln = LayerNorm(hidden_size, 1e-12, ln_dtype)

    def forward(self, feats: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = self.visn_fc(feats).to(self.visn_ln.compute_dtype)
        return dropout(self.visn_ln(x), self.dropout_p, rng)


class LinearPositionEmbedding(nn.Module):
    """Learned x and y grid embeddings, summed to a (grid^2, D) table,
    tiled per image with its first row in front for the class token."""

    def __init__(self, feat_dim: int, grid: int):
        super().__init__()
        self.grid = grid
        self.x_position_embedding = Embed(grid, feat_dim)
        self.y_position_embedding = Embed(grid, feat_dim)

    def forward(self, feats: torch.Tensor, img_len: int) -> torch.Tensor:
        ar = torch.arange(self.grid, device=feats.device)
        x_emb = self.x_position_embedding(ar)
        y_emb = self.y_position_embedding(ar)
        pe = (x_emb[:, None, :] + y_emb[None, :, :]).reshape(
            1, self.grid * self.grid, -1)
        if img_len > 1:
            pe = torch.cat([pe] * img_len, dim=1)
            pe = torch.cat([pe[:, :1], pe], dim=1)
        return feats + pe.to(feats.dtype)


class VisualTokenTypeEmbedding(nn.Module):
    """Per-step token types over the folded stream: token 0 typed 0, then
    each image's block typed by its step index."""

    def __init__(self, feat_dim: int, max_story_length: int):
        super().__init__()
        self.token_type_embedding = Embed(max_story_length, feat_dim)

    def forward(self, feats: torch.Tensor, img_len: int) -> torch.Tensor:
        length = feats.shape[1]
        single = (length - 1) // max(img_len, 1)
        dev = feats.device
        type_ids = torch.cat([
            torch.zeros(1, dtype=torch.long, device=dev),
            torch.arange(img_len, device=dev).repeat_interleave(single),
            torch.zeros(length - 1 - img_len * single, dtype=torch.long,
                        device=dev)])
        return feats + self.token_type_embedding(type_ids)[None].to(
            feats.dtype)


class MultimodalEncoder(nn.Module):
    """Joint text + vision encoder; returns (lang_feats, visn_feats or None,
    pooled)."""

    def __init__(self, cfg: MultimodalConfig,
                 vision_cfg: Optional[CLIPVisionConfig] = None):
        super().__init__()
        self.cfg = cfg
        ecfg = cfg.encoder
        vcfg = vision_cfg or clip_vision_config(cfg)
        self.vcfg = vcfg
        self.embeddings = Embeddings(ecfg)
        if not cfg.multimodal_text_part:
            feat_dim = vcfg.feat_dim  # raises for a ViT it cannot take
            self.visual_model = CLIPVisualTower(vcfg)
            self.visn_fc = VisualFeatEncoder(
                feat_dim, ecfg.hidden_size, ecfg.hidden_dropout_prob,
                ecfg.compute_dtype)
            if cfg.use_positional_embedding:
                self.visual_pos = LinearPositionEmbedding(feat_dim, vcfg.grid)
            if cfg.use_token_type_embedding:
                self.visual_token_type = VisualTokenTypeEmbedding(
                    feat_dim, cfg.max_story_length)
        for i in range(ecfg.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(ecfg))
        self.pooler = Dense(ecfg.hidden_size, ecfg.hidden_size,
                            ecfg.compute_dtype)

    def encode_visual(self, images: torch.Tensor, deterministic: bool = True,
                      rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """images: (B, N, 3, H, W) float CHW, or (B, N, H, W, 3) uint8
        (normalized on the device) -> the projected folded stream (B, N *
        grid^2 + 1, hidden)."""
        cfg = self.cfg
        n = images.shape[1]
        feats = self.visual_model(images_to_nchw(images),
                                  skip_last_layer=False, img_len=n,
                                  deterministic=deterministic)
        if cfg.freeze_vision_model:
            feats = feats.detach()
        if cfg.use_positional_embedding:
            feats = self.visual_pos(feats, n)
        if cfg.use_token_type_embedding:
            feats = self.visual_token_type(feats, n)
        return self.visn_fc(feats, rng)

    def joint_encode(self, lang: torch.Tensor, visn: Optional[torch.Tensor],
                     attention_mask: torch.Tensor,
                     rng: Optional[DropoutRng] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                torch.Tensor]:
        """The shared layers over [lang; visn], split back. `visn` may be
        None (text only)."""
        lang_len = lang.shape[1]
        mask = attention_mask.to(torch.int32)
        joint = lang
        if visn is not None:
            joint = torch.cat([lang, visn.to(lang.dtype)], dim=1)
            mask = torch.cat([mask, torch.ones(visn.shape[:2],
                                               dtype=torch.int32,
                                               device=mask.device)], dim=1)
        remat = self.cfg.encoder.remat and torch.is_grad_enabled()
        for i in range(self.cfg.encoder.num_hidden_layers):
            layer = getattr(self, f"layer_{i}")
            joint = (remat_layer(layer, joint, mask, rng) if remat
                     else layer(joint, mask, rng))
        lang_out = joint[:, :lang_len]
        visn_out = joint[:, lang_len:] if visn is not None else None
        pooled = torch.tanh(self.pooler(lang_out[:, 0]))
        return lang_out, visn_out, pooled

    def embed_language(self, input_ids: torch.Tensor,
                       attention_mask: Optional[torch.Tensor] = None,
                       token_type_ids: Optional[torch.Tensor] = None,
                       rng: Optional[DropoutRng] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The text embeddings and their mask; with `multimodal_img_part`
        the language shrinks to its CLS token."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if self.cfg.multimodal_img_part:
            input_ids = input_ids[:, :1]
            attention_mask = attention_mask[:, :1]
            if token_type_ids is not None:
                token_type_ids = token_type_ids[:, :1]
        return self.embeddings(input_ids, token_type_ids, rng), attention_mask

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                images: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None):
        rng = check_rng(deterministic, rng)
        lang, attention_mask = self.embed_language(
            input_ids, attention_mask, token_type_ids, rng)
        visn = None
        if images is not None and not self.cfg.multimodal_text_part:
            visn = self.encode_visual(images, deterministic, rng)
        return self.joint_encode(lang, visn, attention_mask, rng)
