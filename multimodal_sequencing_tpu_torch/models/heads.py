"""Heat-map ordering head (counterpart of `models/heads.py`:
`gather_step_cls` and `HeatmapHead`).

`HeatmapHead` scores parent->child precedence over step CLS
representations with a low-rank bilinear form plus a pairwise MLP term,
squashed by a sigmoid (v1/v2) or tanh (v3). The pair MLP's GELU is the tanh
approximation, as Flax `nn.gelu`'s default is in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import MultimodalConfig


def gather_step_cls(sequence_output: torch.Tensor, input_ids: torch.Tensor,
                    cls_id: int, n_steps: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hidden state at each step's CLS token: step k's CLS is the k-th
    occurrence of cls_id. Returns (reprs (B, n_steps, H), present
    (B, n_steps) bool); a missing step gathers position 0 with
    present=False."""
    is_cls = (input_ids == cls_id).long()
    # rank of each position among CLS tokens (1-based), 0 if not cls
    rank = torch.cumsum(is_cls, dim=1) * is_cls
    steps = torch.arange(1, n_steps + 1, device=input_ids.device)
    onehot = rank[:, :, None] == steps[None, None, :]
    pos = onehot.long().argmax(dim=1)  # first match; 0 when none
    present = onehot.any(dim=1)
    idx = pos[:, :, None].expand(-1, -1, sequence_output.shape[-1])
    return torch.gather(sequence_output, 1, idx), present


class HeatmapHead(nn.Module):
    """N x N precedence heatmap over step CLS representations."""

    def __init__(self, cfg: MultimodalConfig):
        super().__init__()
        self.version = cfg.hierarchical_version
        hs = cfg.encoder.hidden_size
        self.parent_proj = nn.Linear(hs, hs)
        self.child_proj = nn.Linear(hs, hs)
        self.pair_mlp = nn.Linear(2 * hs, hs // 2)
        self.pair_out = nn.Linear(hs // 2, 1)

    def forward(self, step_reprs: torch.Tensor,
                present: torch.Tensor) -> torch.Tensor:
        b, n, hs = step_reprs.shape
        parent = torch.tanh(self.parent_proj(step_reprs))
        child = torch.tanh(self.child_proj(step_reprs))
        logits = torch.einsum("bih,bjh->bij", parent.float(), child.float())
        logits = logits / math.sqrt(hs)
        # pairwise interaction term over all (i, j): i-major, j-minor
        pi = step_reprs.repeat_interleave(n, dim=1)
        pj = step_reprs.repeat(1, n, 1)
        inter = F.gelu(self.pair_mlp(torch.cat([pi, pj], dim=-1)),
                       approximate="tanh")
        inter = self.pair_out(inter)
        logits = logits + inter.reshape(logits.shape).float()
        pair_valid = present[:, :, None] & present[:, None, :]
        out = torch.tanh(logits) if self.version == "v3" else torch.sigmoid(logits)
        return torch.where(pair_valid, out, torch.zeros_like(out))
