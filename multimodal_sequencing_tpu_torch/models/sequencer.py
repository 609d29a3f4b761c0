"""SequencingModel: text or CLIP multimodal encoder + ordering head
(counterpart of `models/sequencer.py`), the heat-map targets and the fresh
init.

  v0            pooled CLS -> `ClassificationHead` (`cls_head`): pairwise,
                head, abductive or pure_class logits (`cfg.num_labels`)
  v1 | v2 | v3  per-step CLS -> `HeatmapHead` (`heatmap_head`)
  p0 | p1       per-step CLS -> `PointerHead` (`pointer_head`), given the
                order labels in training (p1 teacher-forced)

Under the per-step heads, `cfg.hl_include_objectives` adds
`AuxObjectiveHeads` (`aux_heads`: head, binary / pairwise, itm) and, for
`mlm`, `aux_mlm_head`, the pretrainer's `MLMHead` tied to the word
embedding; v0 gets neither, as the JAX init creates neither there (Flax
makes a `setup` submodule's parameters only where it is called).

With `cfg.multimodal` the encoder is the single-stream joint encoder
(`models/multimodal_encoder.py`: CLIP tower + folded visual tokens + the
shared transformer layers), built from `vision_cfg` (default: RN50 or
ViT-B/32 by `cfg.clip_model_name`). The VisualBERT and naive multimodal
encoders (ROADMAP A5e) are a later slice of the port and raise
`NotImplementedError` here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .clip_visual import (AttentionPool2d, BatchNorm, Conv,
                          VisualTransformer)
from .config import CLIPVisionConfig, MultimodalConfig
from .encoder import DropoutRng, Embed, LayerNorm, TextEncoder
from .heads import (AUX_HEAD_OBJECTIVES, AuxObjectiveHeads,
                    ClassificationHead, HeatmapHead, PointerHead,
                    gather_step_cls)
from .multimodal_encoder import MultimodalEncoder
from .pretrainer import MLMHead

HEATMAP_VERSIONS = ("v1", "v2", "v3")
POINTER_VERSIONS = ("p0", "p1")
VERSIONS = ("v0",) + HEATMAP_VERSIONS + POINTER_VERSIONS


class SequencingModel(nn.Module):
    def __init__(self, cfg: MultimodalConfig,
                 vision_cfg: Optional[CLIPVisionConfig] = None):
        super().__init__()
        if cfg.multimodal and cfg.multimodal_model_type in (
                "visualbert", "naive", "naive_model"):
            raise NotImplementedError(
                f"multimodal_model_type {cfg.multimodal_model_type!r}: the "
                f"VisualBERT and naive encoders (with models/resnet.py and "
                f"models/fpn.py) come with a later slice of the port "
                f"(ROADMAP A5); the port runs the CLIP encoder")
        if cfg.hierarchical_version not in VERSIONS:
            raise ValueError(
                f"unknown hierarchical_version {cfg.hierarchical_version!r}")
        if (cfg.multimodal and cfg.multimodal_img_part
                and cfg.hierarchical_version != "v0"):
            # the JAX package's gather returns NaN there: NaN heat maps
            raise ValueError(
                "multimodal_img_part cuts the language to its first CLS "
                "token, so the per-step heads find no step CLS tokens to "
                "gather")
        self.cfg = cfg
        # "clip" (and the reference's unreachable vilbert/vlbert/uniter,
        # which the JAX package also builds as the CLIP encoder)
        self.encoder = (MultimodalEncoder(cfg, vision_cfg) if cfg.multimodal
                        else TextEncoder(cfg.encoder))
        enc = cfg.encoder
        if cfg.hierarchical_version == "v0":
            self.cls_head = ClassificationHead(
                cfg.num_labels, enc.hidden_size, enc.hidden_dropout_prob,
                enc.compute_dtype)
            return
        if cfg.hierarchical_version in POINTER_VERSIONS:
            self.pointer_head = PointerHead(cfg)
        else:
            self.heatmap_head = HeatmapHead(cfg)
        objs = set(cfg.hl_include_objectives or [])
        if objs & set(AUX_HEAD_OBJECTIVES):
            self.aux_heads = AuxObjectiveHeads(cfg)
        if "mlm" in objs:
            self.aux_mlm_head = MLMHead(enc.hidden_size, enc.vocab_size,
                                        enc.compute_dtype)

    @property
    def vision_cfg(self) -> Optional[CLIPVisionConfig]:
        return self.encoder.vcfg if self.cfg.multimodal else None

    def encode(self, input_ids, attention_mask=None, token_type_ids=None,
               images=None, deterministic: bool = True,
               rng: Optional[DropoutRng] = None):
        """(lang_seq, visn_seq or None, pooled)."""
        if self.cfg.multimodal:
            return self.encoder(input_ids, attention_mask, token_type_ids,
                                images, deterministic, rng)
        seq, pooled = self.encoder(input_ids, attention_mask, token_type_ids,
                                   deterministic, rng)
        return seq, None, pooled

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                images: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None,
                order_labels: Optional[torch.Tensor] = None,
                aux: bool = True) -> Dict[str, torch.Tensor]:
        """`images`: a story's step images for the multimodal encoder,
        (B, N, H, W, 3) uint8 or (B, N, 3, H, W) float. v0 returns the
        classification head's f32 `logits` of the pooled CLS; the per-step
        versions the step representations and the `heatmap` (v1-v3) or the
        f32 `pointer_logits` (p0/p1, p1 teacher-forced by `order_labels`
        when given), and the aux heads' `head_logits`, `bin_logits`,
        `itm_logits` and `mlm_logits` (`aux=False` skips those heads: the
        evaluator reads one output, where the JAX eval's jit prunes the
        rest).
        `deterministic=False` (training) needs `rng`, the step's dropout
        streams; it also normalizes the BatchNorms by the batch and updates
        their running averages."""
        cfg = self.cfg
        seq, visn, pooled = self.encode(input_ids, attention_mask,
                                        token_type_ids, images, deterministic,
                                        rng)
        if cfg.hierarchical_version == "v0":
            logits = self.cls_head(pooled, None if deterministic else rng)
            return {"sequence_output": seq, "visual_output": visn,
                    "pooled_output": pooled, "logits": logits.float()}
        reprs, present = gather_step_cls(seq, input_ids, cfg.cls_id,
                                         cfg.max_story_length)
        out = {"sequence_output": seq, "visual_output": visn,
               "pooled_output": pooled, "step_reprs": reprs,
               "present": present}
        if cfg.hierarchical_version in POINTER_VERSIONS:
            out["pointer_logits"] = self.pointer_head(
                reprs, present, order_labels).float()
        else:
            out["heatmap"] = self.heatmap_head(reprs, present)
        if not aux:
            return out
        if hasattr(self, "aux_heads"):
            out.update(self.aux_heads(reprs, present, pooled,
                                      None if deterministic else rng))
        if hasattr(self, "aux_mlm_head"):
            out["mlm_logits"] = self.aux_mlm_head(
                seq, self.encoder.embeddings.word_embeddings.weight)
        return out


def render_heatmap_targets(order_labels: torch.Tensor, n: int,
                           soft_value: float = 0.1) -> torch.Tensor:
    """Batched `render_order_heatmap` (soft mode): immediate successor ->
    1.0, later descendants -> soft_value, diagonal 0. `order_labels` is the
    chain itself: node order_labels[t] precedes order_labels[t+1]."""
    pos = torch.argsort(order_labels, dim=1)  # chain time of each node
    pi, pj = pos[:, :, None], pos[:, None, :]
    one = torch.ones((), dtype=torch.float32, device=order_labels.device)
    target = torch.where(pj == pi + 1, one,
                         torch.where(pj > pi, soft_value * one, 0 * one))
    eye = torch.eye(n, dtype=torch.bool, device=order_labels.device)
    return torch.where(eye[None], 0 * one, target)


def cast_for_inference(model: nn.Module) -> nn.Module:
    """Store the Dense, Conv and Embed weights in their compute dtype. They
    are cast to it at every call anyway, so outputs are unchanged;
    LayerNorm and BatchNorm parameters and statistics stay f32. For eval
    only: the optimizer needs f32 weights."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, Embed)):
            mod.to(mod.compute_dtype)
    return model


# the constant that makes a standard normal truncated to [-2, 2] unit
# variance (the "truncated_normal" of JAX's variance_scaling initializers)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, gen) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    return w


def _normal(shape, std: float, gen) -> torch.Tensor:
    return torch.empty(shape).normal_(0.0, std, generator=gen)


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fresh weights from `seed` with the distributions of Flax's default
    initializers, drawn on the CPU with an explicit generator so a seed
    gives the same model on every device: Dense and Conv kernels
    `lecun_normal` (a normal truncated at two standard deviations, variance
    1 / fan_in, fan_in = kh * kw * cin for a conv, the input width for
    Flax's multi-head projections: heads * head_dim for their output), the
    LSTM's recurrent kernels orthogonal, Embed tables normal with
    std 1 / sqrt(features), zero biases, unit LayerNorm and BatchNorm
    scales, BatchNorm running mean 0 and variance 1; the CLIP towers' raw
    parameters as their modules declare them (attention-pool positions
    normal with std c^-0.5; ViT class embedding, positions and projection
    normal with std width^-0.5), and a module's `normal_init` parameters
    (name -> std: the pointer and index decoders' position tables) normal.
    The bits differ from JAX's."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                if getattr(mod, "recurrent", False):
                    nn.init.orthogonal_(mod.weight, generator=gen)
                else:
                    mod.weight.copy_(_lecun_normal(mod.weight.shape,
                                                   mod.in_features, gen))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Conv):
                o, i, kh, kw = mod.weight.shape
                mod.weight.copy_(_lecun_normal(mod.weight.shape, i * kh * kw,
                                               gen))
            elif isinstance(mod, Embed):
                mod.weight.copy_(_normal(mod.weight.shape,
                                         1.0 / math.sqrt(mod.embedding_dim),
                                         gen))
            elif isinstance(mod, (LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            elif isinstance(mod, AttentionPool2d):
                pe = mod.positional_embedding
                pe.copy_(_normal(pe.shape, pe.shape[1] ** -0.5, gen))
            elif isinstance(mod, VisualTransformer):
                std = mod.cfg.vit_width ** -0.5
                for p in (mod.class_embedding, mod.positional_embedding,
                          mod.proj):
                    p.copy_(_normal(p.shape, std, gen))
            for name, std in getattr(mod, "normal_init", {}).items():
                p = getattr(mod, name)
                p.copy_(_normal(p.shape, std, gen))
    return model
