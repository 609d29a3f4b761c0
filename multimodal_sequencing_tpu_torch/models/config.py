"""Model configuration dataclasses (counterpart of `models/config.py`).

Same fields, defaults and JSON layout as the JAX package, so a
`config.json` sidecar loads in either package. `compute_dtype` maps the
dtype string to a `torch.dtype`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


@dataclass
class EncoderConfig:
    """BERT/RoBERTa-compatible text encoder config (defaults: roberta-large)."""
    vocab_size: int = 50265
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pad_token_id: int = 1
    # RoBERTa position ids start at pad_token_id + 1 (HF convention).
    position_offset: int = 2
    initializer_range: float = 0.02
    dtype: str = "bfloat16"
    # The fields below are read by the JAX package only; they are kept so
    # that a config written by either package loads in the other.
    remat: bool = False
    use_pallas_attention: bool = True
    gelu_approximate: bool = False
    # "logit_erf" / "fast_erf" / "erf" all run as exact erf GELU here
    # (ops/gelu.py); "tanh" is the tanh approximation.
    gelu_impl: str = "logit_erf"
    sequence_parallel: bool = False
    attention_dropout_mode: str = "probs"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def resolved_gelu_impl(self) -> str:
        return "tanh" if self.gelu_approximate else self.gelu_impl

    @classmethod
    def tiny(cls, **kw):
        """Small config for tests."""
        base = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=160, dtype="float32")
        base.update(kw)
        return cls(**base)

    @classmethod
    def roberta_large(cls, **kw):
        return cls(**kw)

    @classmethod
    def roberta_base(cls, **kw):
        base = dict(hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, intermediate_size=3072)
        base.update(kw)
        return cls(**base)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str):
        return cls(**json.loads(s))


@dataclass
class MultimodalConfig:
    """Sequencing task + multimodal fusion config. Every field of the JAX
    package's `MultimodalConfig` is kept for the shared JSON layout; the
    port so far runs the text branch with the heat-map heads."""
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    max_story_length: int = 5
    min_story_length: int = 5
    max_seq_length: int = 300
    per_seq_max_length: int = 60
    cls_id: int = 0
    pad_id: int = 1
    mask_id: int = 50264
    mlm_ignore_index: int = -100

    # multimodal
    multimodal: bool = False
    multimodal_model_type: str = "clip"   # naive | visualbert | clip
    bypass_transformer: bool = False
    vision_model: str = "resnet50"
    vision_feature_dim: Optional[int] = None
    vision_stride_in_1x1: Optional[bool] = None
    clip_model_name: str = "RN50"         # RN50 | ViT-B/32
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4
    use_positional_embedding: bool = True
    use_token_type_embedding: bool = True
    freeze_vision_model: bool = False
    multimodal_text_part: bool = False
    multimodal_img_part: bool = False
    multimodal_fusion_method: str = "sum"  # sum | mul | text_only | img_only
    include_full_img_features: bool = True
    num_img_regional_features: Optional[int] = None
    image_size: Tuple[int, int] = (224, 224)
    patch_grid: int = 7
    detectron2_pixel_mean: Tuple[float, float, float] = (
        103.530, 116.280, 123.675)

    # heads / objectives
    hierarchical_version: str = "v0"      # v0 | v1 | v2 | v3 | p0 | p1
    hl_include_objectives: List[str] = field(default_factory=list)
    heatmap_decode_method: str = "naive_v2_sum"
    heatmap_decode_beam_size: int = 2
    device_decode: bool = False
    num_labels: int = 2
    wrapper_model_type: Optional[str] = None   # None | "berson"
    wrapper_model_with_heatmap: bool = False

    # pretraining
    multimodal_pretrain_objectives: List[str] = field(default_factory=list)
    mlm_probability: float = 0.15

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        d["encoder"] = EncoderConfig(**d["encoder"])
        d["image_size"] = tuple(d["image_size"])
        return cls(**d)
