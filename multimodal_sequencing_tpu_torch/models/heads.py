"""Ordering heads (counterpart of `models/heads.py`: the v0
`ClassificationHead`, `gather_step_cls` and `HeatmapHead` with its
losses).

`ClassificationHead` (RoBERTa's classification head: dropout, dense, tanh,
dropout, out_proj) scores the pooled CLS of a pair, a triple or a story;
the pairwise, head, abductive and pure_class tasks differ only in its
`num_labels`.

`HeatmapHead` scores parent->child precedence over step CLS
representations with a low-rank bilinear form plus a pairwise MLP term,
squashed by a sigmoid (v1/v2) or tanh (v3). The pair MLP's GELU is the tanh
approximation, as Flax `nn.gelu`'s default is in the JAX package. Its
layers compute in the dtype of the step representations, as the JAX head's
`dtype=step_reprs.dtype`: the encoder's compute dtype under the sequencer,
f32 under BERSON (`dtype`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import MultimodalConfig
from .encoder import Dense, DropoutRng, dropout


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


class ClassificationHead(nn.Module):
    """dropout -> dense -> tanh -> dropout -> out_proj, in `dtype`."""

    def __init__(self, num_labels: int, hidden_size: int,
                 dropout_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.dense = Dense(hidden_size, hidden_size, dtype)
        self.out_proj = Dense(hidden_size, num_labels, dtype)

    def forward(self, features: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = dropout(features, self.dropout_prob, rng)
        x = torch.tanh(self.dense(x))
        x = dropout(x, self.dropout_prob, rng)
        return self.out_proj(x)


class HeatmapHead(nn.Module):
    """N x N precedence heatmap over step CLS representations."""

    def __init__(self, cfg: MultimodalConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.version = cfg.hierarchical_version
        hs, dt = cfg.encoder.hidden_size, dtype or cfg.encoder.compute_dtype
        self.parent_proj = Dense(hs, hs, dt)
        self.child_proj = Dense(hs, hs, dt)
        self.pair_mlp = Dense(2 * hs, hs // 2, dt)
        self.pair_out = Dense(hs // 2, 1, dt)

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

    @staticmethod
    def loss(heatmap: torch.Tensor, target: torch.Tensor,
             present: torch.Tensor) -> torch.Tensor:
        """BCE against render_heatmap_targets (soft values allowed), masked
        to valid step pairs."""
        eps = 1e-6
        p = torch.clamp(heatmap.abs(), eps, 1 - eps)
        bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
        pair_valid = present[:, :, None] & present[:, None, :]
        bce = torch.where(pair_valid, bce, torch.zeros_like(bce))
        return bce.sum() / torch.clamp(pair_valid.sum(), min=1)

    @staticmethod
    def pairwise_ranking_loss(heatmap: torch.Tensor, order_labels: torch.Tensor,
                              present: torch.Tensor,
                              margin: float = 0.1) -> torch.Tensor:
        """heatmap_pairwise_ranking aux: for the true order, enforce
        hm[pi_t, pi_{t+1}] > hm[pi_{t+1}, pi_t] + margin. The label is the
        chain sequence: node order_labels[t] precedes order_labels[t+1]."""
        b = order_labels.shape[0]
        src, dst = order_labels[:, :-1], order_labels[:, 1:]
        bidx = torch.arange(b, device=heatmap.device)[:, None]
        pos = heatmap[bidx, src, dst]
        neg = heatmap[bidx, dst, src]
        valid = (torch.gather(present, 1, src) & torch.gather(present, 1, dst))
        loss = torch.clamp(margin - (pos - neg), min=0.0)
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        return loss.sum() / torch.clamp(valid.sum(), min=1)
