"""SequencingModel: text encoder + heat-map head (counterpart of
`models/sequencer.py`, text branch, heat-map versions v1/v2/v3).

The other versions (v0 classification, p0/p1 pointer), the auxiliary
objective heads and the multimodal encoders are later slices of the port
and raise `NotImplementedError` here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .config import MultimodalConfig
from .encoder import TextEncoder
from .heads import HeatmapHead, gather_step_cls

HEATMAP_VERSIONS = ("v1", "v2", "v3")


class SequencingModel(nn.Module):
    def __init__(self, cfg: MultimodalConfig):
        super().__init__()
        if cfg.multimodal:
            raise NotImplementedError(
                "the multimodal encoders come with a later slice of the port")
        if cfg.hierarchical_version not in HEATMAP_VERSIONS:
            raise NotImplementedError(
                f"hierarchical_version {cfg.hierarchical_version!r}: the port "
                f"has the heat-map heads {HEATMAP_VERSIONS} so far; the "
                f"classification and pointer heads come with a later slice")
        if cfg.hl_include_objectives:
            raise NotImplementedError(
                "auxiliary objective heads come with the training slice")
        self.cfg = cfg
        self.encoder = TextEncoder(cfg.encoder)
        self.heatmap_head = HeatmapHead(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        seq, pooled = self.encoder(input_ids, attention_mask, token_type_ids)
        reprs, present = gather_step_cls(seq, input_ids, cfg.cls_id,
                                         cfg.max_story_length)
        return {"sequence_output": seq, "pooled_output": pooled,
                "step_reprs": reprs, "present": present,
                "heatmap": self.heatmap_head(reprs, present)}


def init_weights(model: nn.Module, seed: int,
                 initializer_range: float = 0.02) -> nn.Module:
    """Fresh weights from `seed`, drawn on the CPU with an explicit
    generator so a seed gives the same model on every device: normal
    (0, initializer_range) for linear and embedding weights, zero biases,
    unit LayerNorm scales."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
                    0.0, initializer_range, generator=gen))
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model
