"""Ordering heads (counterpart of `models/heads.py`: the v0
`ClassificationHead`, `gather_step_cls`, `HeatmapHead` with its losses,
the auxiliary objective heads and the p0/p1 pointer heads), and the two
Flax layers they share with BERSON and pure_decode.

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

`AuxObjectiveHeads` are the `--hl_include_objectives` heads: `head` (a
`SimpleClassifier` score a step; dead steps -1e9), `binary` / `pairwise`
(one score a step, stacked as (score_j, score_i) for each i < j pair) and
`itm` (an f32 Dense on the pooled CLS). `SimpleClassifier` is Dense, exact
erf GELU, dropout 0.5 (its own rate, not the config's), Dense.

`PointerHead` is p1, an LSTM pointer net (`LSTMPointerDecoder`), or p0, a
causal self-attention decoder over learned position queries (4 heads),
cross-attention on the step representations and an index classifier. Both
give (B, T, N) logits, row t scoring which step sits at position t; p1 is
teacher-forced by the order labels when it is given them, greedy without.
Their dtypes are the JAX head's: p0's self-attention and p1's query
projection in the step representations' dtype, every other Dense, the
LSTM and the LayerNorms (eps 1e-6) in f32, as Flax promotes a bf16 input
with f32 parameters.

`MultiHeadAttention` is Flax's `nn.MultiHeadDotProductAttention` (no
dropout) in plain torch: an XLA computation in the JAX package, not a
Pallas kernel, and its masks (causal, or p0's 4 heads of 256) are not the
flash kernels' key mask. `LSTMCell` is Flax's `nn.OptimizedLSTMCell`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG_INF
from ..parallel.mesh import global_count
from .config import MultimodalConfig
from .encoder import Dense, DropoutRng, LayerNorm, dropout


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """log_softmax in the JAX package's formula:
    (x - max) - log(sum(exp(x - max)))."""
    shifted = x - x.amax(-1, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))


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
        return bce.sum() / torch.clamp(global_count(pair_valid.sum()), min=1)

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
        return loss.sum() / torch.clamp(global_count(valid.sum()), min=1)


class SimpleClassifier(nn.Module):
    """Dense -> exact-erf GELU -> dropout -> Dense, in `dtype`."""

    def __init__(self, hidden_size: int, out_size: int,
                 dropout_prob: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.fc1 = Dense(hidden_size, hidden_size, dtype)
        self.fc2 = Dense(hidden_size, out_size, dtype)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = F.gelu(self.fc1(x), approximate="none")
        return self.fc2(dropout(x, self.dropout_prob, rng))


AUX_HEAD_OBJECTIVES = ("head", "binary", "pairwise", "itm")


class AuxObjectiveHeads(nn.Module):
    """The heads of `cfg.hl_include_objectives` (module names as the Flax
    tree's: `hl_head_pred_layer`, `hl_bin_pred_layer`,
    `seq_relationship`); returns their f32 `head_logits` (B, N),
    `bin_logits` (B, N(N-1)/2, 2) and `itm_logits` (B, 2)."""

    def __init__(self, cfg: MultimodalConfig):
        super().__init__()
        objs = set(cfg.hl_include_objectives or [])
        h, dt = cfg.encoder.hidden_size, cfg.encoder.compute_dtype
        if "head" in objs:
            self.hl_head_pred_layer = SimpleClassifier(h, 1, dtype=dt)
        if objs & {"binary", "pairwise"}:
            self.hl_bin_pred_layer = SimpleClassifier(h, 1, dtype=dt)
            iu, ju = np.triu_indices(cfg.max_story_length, k=1)
            self.register_buffer("iu", torch.from_numpy(iu.astype(np.int64)),
                                 persistent=False)
            self.register_buffer("ju", torch.from_numpy(ju.astype(np.int64)),
                                 persistent=False)
        if "itm" in objs:
            self.seq_relationship = Dense(h, 2)

    def forward(self, step_reprs: torch.Tensor, present: torch.Tensor,
                pooled: torch.Tensor, rng: Optional[DropoutRng] = None
                ) -> Dict[str, torch.Tensor]:
        out = {}
        if hasattr(self, "hl_head_pred_layer"):
            scores = self.hl_head_pred_layer(step_reprs, rng)[..., 0]
            # -1e9 in the scores' dtype, as JAX's where casts it
            out["head_logits"] = torch.where(
                present, scores, torch.full_like(scores, NEG_INF)).float()
        if hasattr(self, "hl_bin_pred_layer"):
            s = self.hl_bin_pred_layer(step_reprs, rng)[..., 0]
            # logits per pair = (score_j, score_i): class 1 <=> i precedes j
            out["bin_logits"] = torch.stack(
                [s[:, self.ju], s[:, self.iu]], dim=-1).float()
        if hasattr(self, "seq_relationship"):
            out["itm_logits"] = self.seq_relationship(pooled).float()
        return out


class MultiHeadAttention(nn.Module):
    """Flax `nn.MultiHeadDotProductAttention` (no dropout) in `dtype`: the
    query, key, value and out projections (`query`, `key`, `value`,
    `out`), q / sqrt(head_dim), masked scores set to finfo(dtype).min, a
    softmax in `dtype`. `mask`: (B, K) keys or (B, Q, K) bool; keys and
    values come from `kv` (cross-attention), else from `x`."""

    def __init__(self, features: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.query = Dense(features, features, dtype)
        self.key = Dense(features, features, dtype)
        self.value = Dense(features, features, dtype)
        self.out = Dense(features, features, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        b, n, f = x.shape
        d = f // self.heads

        def split(t):
            return t.view(b, t.shape[1], self.heads, d)

        q = split(self.query(x)) / math.sqrt(d)
        s = torch.einsum("bqhd,bkhd->bhqk", q, split(self.key(kv)))
        mask = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w, split(self.value(kv)))
        return self.out(ctx.reshape(b, n, f))


class LSTMCell(nn.Module):
    """Flax `nn.OptimizedLSTMCell`: the input Denses `ii if ig io` (no
    bias) and the recurrent `hi hf hg ho`; gates i, f, o sigmoid, g tanh,
    in f32. `fused` concatenates the eight weights once a call of the
    model; `step` then takes two products a step."""

    GATES = "ifgo"

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for g in self.GATES:
            self.add_module(f"i{g}", Dense(in_features, features, bias=False))
            rec = Dense(features, features)
            rec.recurrent = True  # init_weights: orthogonal, as Flax's
            self.add_module(f"h{g}", rec)

    def fused(self):
        def cat(kind, leaf):
            return torch.cat([getattr(getattr(self, f"{kind}{g}"), leaf)
                              for g in self.GATES])
        return cat("i", "weight"), cat("h", "weight"), cat("h", "bias")

    @staticmethod
    def step(fused, c, h, x):
        """One step from carry (c, h) on input x; returns (c, h)."""
        w_i, w_h, b_h = fused
        z = F.linear(h, w_h, b_h) + F.linear(x, w_i)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class LSTMPointerDecoder(nn.Module):
    """p1: an LSTM pointer network over the step representations (`cell`,
    `query_proj`), from the mean present step; teacher-forced by
    `order_labels` when given, else greedy."""

    def __init__(self, hidden_size: int, dtype: torch.dtype):
        super().__init__()
        self.cell = LSTMCell(hidden_size, hidden_size)
        self.query_proj = Dense(hidden_size, hidden_size, dtype)

    def forward(self, step_reprs: torch.Tensor, present: torch.Tensor,
                order_labels: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, h = step_reprs.shape
        fused = self.cell.fused()
        inp = (torch.where(present[..., None], step_reprs,
                           torch.zeros((), dtype=step_reprs.dtype,
                                       device=step_reprs.device)).sum(1)
               / present.sum(1, keepdim=True).clamp(min=1))
        # the zero carry; the cell computes in f32 (the inputs promoted)
        c = hh = step_reprs.new_zeros((b, h), dtype=torch.float32)
        rows = torch.arange(b, device=step_reprs.device)
        pointed = torch.zeros_like(present)
        logits = []
        for t in range(n):
            c, hh = LSTMCell.step(fused, c, hh, inp.float())
            q = self.query_proj(hh)
            logit = torch.einsum("bh,bnh->bn", q,
                                 step_reprs).float() / math.sqrt(h)
            logit = torch.where(present & ~pointed, logit, NEG_INF)
            nxt = (order_labels[:, t] if order_labels is not None
                   else logit.argmax(-1))
            pointed = pointed | F.one_hot(nxt, n).bool()
            inp = step_reprs[rows, nxt]
            logits.append(logit)
        return torch.stack(logits, dim=1)


class PointerHead(nn.Module):
    """p0 / p1 pointer ordering head over the step CLS representations:
    (B, T, N) f32 logits, row t scoring which step sits at position t."""

    def __init__(self, cfg: MultimodalConfig):
        super().__init__()
        self.version = cfg.hierarchical_version
        h, dt = cfg.encoder.hidden_size, cfg.encoder.compute_dtype
        if self.version == "p1":
            self.lstm_pointer = LSTMPointerDecoder(h, dt)
            return
        n = cfg.max_story_length
        self.pos_emb = nn.Parameter(torch.zeros(n, h))
        self.normal_init = {"pos_emb": 0.02}  # init_weights
        self.self_attn = MultiHeadAttention(h, 4, dt)
        self.ln1 = LayerNorm(h, 1e-6)
        self.xq, self.xk, self.xv = Dense(h, h), Dense(h, h), Dense(h, h)
        self.ln2 = LayerNorm(h, 1e-6)
        self.index_q = Dense(h, h)
        self.register_buffer("causal", torch.tril(torch.ones(
            n, n, dtype=torch.bool)), persistent=False)

    def forward(self, step_reprs: torch.Tensor, present: torch.Tensor,
                order_labels: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.version == "p1":
            return self.lstm_pointer(step_reprs, present, order_labels)
        # p0: causal self-attention over the position queries, then
        # cross-attention on the steps and an index classifier
        b, n, h = step_reprs.shape
        dt = self.self_attn.query.compute_dtype
        x = self.pos_emb[None].expand(b, n, h).to(dt)
        x = self.self_attn(x, self.causal[None].expand(b, n, n))
        x = self.ln1(x.float())
        reprs = step_reprs.float()
        w = torch.einsum("bth,bnh->btn", self.xq(x),
                         self.xk(reprs)) / math.sqrt(h)
        w = torch.where(present[:, None, :], w, NEG_INF)
        x = x + torch.einsum("btn,bnh->bth", torch.softmax(w, -1),
                             self.xv(reprs))
        x = self.ln2(x)
        logits = torch.einsum("bth,bnh->btn", self.index_q(x),
                              reprs) / math.sqrt(h)
        return torch.where(present[:, None, :], logits, NEG_INF)

    @staticmethod
    def loss(logits: torch.Tensor, order_labels: torch.Tensor,
             present: torch.Tensor) -> torch.Tensor:
        """Pointer NLL: position t must select node order_labels[t] (the
        label is the chain), over the present target steps."""
        nll = -log_softmax(logits).gather(2, order_labels[:, :, None])[..., 0]
        valid = torch.gather(present, 1, order_labels)
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return nll.sum() / torch.clamp(global_count(valid.sum()), min=1)

    @staticmethod
    def decode(logits: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
        """Greedy sequential decode with a no-repeat mask: the chain
        (seq[t] = the step pointed at position t). -1e12, strictly below
        the -1e9 of the masks, keeps a pointed step from winning an
        all-masked row."""
        b, n, _ = logits.shape
        pointed = torch.zeros_like(present)
        seq = []
        for t in range(n):
            row = torch.where(present & ~pointed, logits[:, t], -1e12)
            pick = row.argmax(-1)
            pointed = pointed | F.one_hot(pick, n).bool()
            seq.append(pick)
        return torch.stack(seq, dim=1)
