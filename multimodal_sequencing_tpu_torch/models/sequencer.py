"""SequencingModel: text encoder + heat-map head (counterpart of
`models/sequencer.py`, text branch, heat-map versions v1/v2/v3), the
heat-map targets and the fresh init.

The other versions (v0 classification, p0/p1 pointer), the auxiliary
objective heads and the multimodal encoders are later slices of the port
and raise `NotImplementedError` here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .config import MultimodalConfig
from .encoder import DropoutRng, Embed, LayerNorm, TextEncoder
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
        if cfg.hl_include_objectives and set(cfg.hl_include_objectives) != {
                "heatmap_pairwise_ranking"}:
            raise NotImplementedError(
                "auxiliary objective heads (head/binary/itm/mlm) come with a "
                "later slice of the port")
        self.cfg = cfg
        self.encoder = TextEncoder(cfg.encoder)
        self.heatmap_head = HeatmapHead(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None) -> Dict[str, torch.Tensor]:
        """`deterministic=False` (training) needs `rng`, the step's
        dropout streams."""
        cfg = self.cfg
        seq, pooled = self.encoder(input_ids, attention_mask, token_type_ids,
                                   deterministic, rng)
        reprs, present = gather_step_cls(seq, input_ids, cfg.cls_id,
                                         cfg.max_story_length)
        return {"sequence_output": seq, "pooled_output": pooled,
                "step_reprs": reprs, "present": present,
                "heatmap": self.heatmap_head(reprs, present)}


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
    """Store the Dense and Embed weights in their compute dtype. They are
    cast to it at every call anyway, so outputs are unchanged; LayerNorm
    parameters stay f32. For eval only: the optimizer needs f32 weights."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, Embed)):
            mod.to(mod.compute_dtype)
    return model


# the constant that makes a standard normal truncated to [-2, 2] unit
# variance (the "truncated_normal" of JAX's variance_scaling initializers)
_TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fresh weights from `seed` with the distributions of Flax's default
    initializers, drawn on the CPU with an explicit generator so a seed
    gives the same model on every device: Dense kernels `lecun_normal` (a
    normal truncated at two standard deviations, variance 1 / fan_in), Embed
    tables normal with std 1 / sqrt(features), zero biases, unit LayerNorm
    scales. The bits differ from JAX's."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, Embed):
                mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
                    0.0, 1.0 / math.sqrt(mod.embedding_dim), generator=gen))
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model
