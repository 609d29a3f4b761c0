"""BERSON ordering wrapper (counterpart of `models/berson.py`): an inner
pair encoder, hierarchical attention, a paragraph encoder over the step
vectors, a relational LSTM pointer (teacher-forced in training) and a
batched beam search.

  packed pairs (B, P, L) -> inner encoder -> top_vec (B, P, L, H)
    -> HierarchicalAttention -> doc (B, N, H) + relation matrices (B, N, N, .)
    -> TransformerInterEncoder -> key, (h, c) of the LSTM
    -> pointer: N steps (training) / a W-beam search (inference)

The inner encoder is the text encoder, or a multimodal encoder over each
pair's two step images (`images[:, pairs]` -> (B * P, 2, ...)): the CLIP
joint encoder (the image stream's CLS its first visual token), VisualBERT
(its first image token) or the naive model (the first appended image
token); vilbert raises, as in the JAX package. Its
attention, GELU and LayerNorm run as the hand-written kernels on the card.
Everything after it computes in f32, as the JAX head does (none of its Flax
modules is given a dtype, so a bf16 trunk's output is promoted): the
Denses are f32, `top_vec` is cast before the span einsum. The paragraph
encoder's attention (8 heads of 128 over N = 5 step vectors; Flax's
`MultiHeadDotProductAttention`, an XLA computation in JAX) is plain f32
matmuls and softmax, its LayerNorms the LayerNorm op, its FF GELU the tanh
approximation.

Module names are the Flax parameter tree's (`inner`, `two_level_encoder`,
`para_encoder`, `key_linear`, `query_linear`, `tanh_linear`, `pw_k`,
`decoder` with the LSTM's eight Denses `ii if ig io hi hf hg ho`,
`heatmap`, `img_projection`, `img_pairwise_relationship`), so
`params_from_jax` moves JAX weights by name.

Beam ties: `scores` starts at -1e9 for beams 1..W-1, so the first step's
candidates tie exactly; the top W are taken with a stable descending sort,
the lower index first, as the JAX package's `lax.top_k` takes them (torch's
`topk` promises no order among ties). Neither the teacher-forced loop nor
the beam loop syncs with the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.packing import berson_pairs
from ..parallel.mesh import global_count, global_mean
from .config import CLIPVisionConfig, MultimodalConfig
from .encoder import (Dense, DropoutRng, LayerNorm, TextEncoder, check_rng,
                      dropout)
from .heads import (HeatmapHead, LSTMCell, MultiHeadAttention,
                    log_softmax)
from .multimodal_encoder import MultimodalEncoder
from .naive_model import NaiveMultimodalModel
from .visualbert import VisualBERTEncoder
from .sequencer import render_heatmap_targets

NEG = -1e9


def _sentence_membership(n: int):
    """(pairs, pair_idx, side_idx): for each step s, the (pair, side) slots
    of the pair list that hold s; each step is in 2(n-1) pairs."""
    pairs = berson_pairs(n)
    pair_idx = np.zeros((n, 2 * (n - 1)), np.int32)
    side_idx = np.zeros((n, 2 * (n - 1)), np.int32)
    for s in range(n):
        k = 0
        for p, (i, j) in enumerate(pairs):
            if i == s or j == s:
                pair_idx[s, k], side_idx[s, k] = p, 0 if i == s else 1
                k += 1
    return pairs, pair_idx, side_idx


def _const(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64))


class InterEncoderLayer(nn.Module):
    """Pre-norm transformer layer (no LayerNorm before layer 0's
    attention), LayerNorm eps 1e-6, tanh-GELU FF."""

    def __init__(self, d_model: int, heads: int, d_ff: int, first: bool):
        super().__init__()
        if not first:
            self.ln = LayerNorm(d_model, 1e-6)
        self.self_attn = MultiHeadAttention(d_model, heads)
        self.ff_ln = LayerNorm(d_model, 1e-6)
        self.ff_1 = Dense(d_model, d_ff)
        self.ff_2 = Dense(d_ff, d_model)

    def forward(self, x, mask, p: float, rng: Optional[DropoutRng]):
        h = self.ln(x) if hasattr(self, "ln") else x
        x = x + dropout(self.self_attn(h, mask), p, rng)
        h = F.gelu(self.ff_1(self.ff_ln(x)), approximate="tanh")
        h = self.ff_2(dropout(h, p, rng))
        return x + dropout(h, p, rng)


class TransformerInterEncoder(nn.Module):
    """The paragraph encoder over the step vectors. Its dropout is its own
    (0.1, as the JAX module's field), not the config's."""

    def __init__(self, d_model: int, d_ff: int = 3072, heads: int = 8,
                 dropout: float = 0.1, num_layers: int = 2):
        super().__init__()
        self.dropout = dropout
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", InterEncoderLayer(
                d_model, heads, d_ff, first=i == 0))
        self.ln_out = LayerNorm(d_model, 1e-6)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = x * mask[:, :, None]
        keys = mask != 0
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, keys, self.dropout, rng)
        return self.ln_out(x)


class HierarchicalAttention(nn.Module):
    """Two-level attention over the encoded pairs. Level 1: token attention
    inside each pair over step A's span (tokens 1..sep0) and step B's
    (sep0+1..sep1): two step vectors a pair. Level 2: each step attends
    over its 2(N-1) pair-contextualized vectors (edges to a dead partner
    step masked). Also the pairwise scores and the (N, N) relation
    matrices of the pointer."""

    def __init__(self, cfg: MultimodalConfig):
        super().__init__()
        h = cfg.encoder.hidden_size
        self.n = cfg.max_story_length
        self.dropout_p = cfg.encoder.hidden_dropout_prob
        self.sentence_tran = Dense(h, h)
        self.sentence_tran_2 = Dense(h, 1)
        self.pairwise_relationship = Dense(h, 2)
        self.h1_relationship = Dense(h, 2)
        self.h2_relationship = Dense(h, 2)
        self.linear_in_2 = Dense(h, 1, bias=False)
        pairs, pair_idx, side_idx = _sentence_membership(self.n)
        for name, val in (("pair_flat", pairs[:, 0] * self.n + pairs[:, 1]),
                          ("pair_idx", pair_idx), ("side_idx", side_idx),
                          ("partner", pairs[pair_idx, 1 - side_idx])):
            self.register_buffer(name, _const(val), persistent=False)

    def forward(self, top_vec, cls_pooled, sep_positions, mask_cls,
                rng: Optional[DropoutRng] = None):
        b, p, L, _ = top_vec.shape
        n = self.n
        top32 = top_vec.float()
        scores = self.sentence_tran_2(
            torch.tanh(self.sentence_tran(top32)))[..., 0]      # (B, P, L)
        tok = torch.arange(L, device=top_vec.device)
        sep0, sep1 = sep_positions[..., 0:1], sep_positions[..., 1:2]
        span = torch.stack([(tok >= 1) & (tok <= sep0),
                            (tok > sep0) & (tok <= sep1)], dim=2)
        att = torch.softmax(torch.where(span, scores[:, :, None, :], NEG),
                            dim=-1)
        att = dropout(att, self.dropout_p, rng)
        mix = torch.einsum("bpsl,bplh->bpsh", att, top32)    # (B, P, 2, H)

        cls_score = self.pairwise_relationship(cls_pooled)
        cls_his1 = self.h1_relationship(cls_pooled)
        cls_his2 = self.h2_relationship(cls_pooled)

        def to_matrix(x):  # (B, P, ...) -> (B, N, N, ...), zeros elsewhere
            out = x.new_zeros((b, n * n) + x.shape[2:])
            return out.index_copy(1, self.pair_flat, x).view(
                (b, n, n) + x.shape[2:])

        sent = mix[:, self.pair_idx, self.side_idx]           # (B, N, E, H)
        edge = self.linear_in_2(sent)[..., 0]                 # (B, N, E)
        edge = torch.where(mask_cls[:, self.partner] > 0, edge, NEG)
        doc = torch.einsum("bne,bneh->bnh", torch.softmax(edge, dim=-1),
                           sent)
        doc = doc * mask_cls[:, :, None]
        return (doc, to_matrix(cls_pooled), cls_score, to_matrix(cls_score),
                to_matrix(cls_his1), to_matrix(cls_his2))


class BersonOrdering(nn.Module):
    """Inner pair encoder + hierarchical attention + paragraph encoder +
    relational LSTM pointer. `forward(batch)` returns the training losses
    (teacher forced); `beam_search(batch)` the (B, N) predicted chains,
    -1 past each story's length."""

    def __init__(self, cfg: MultimodalConfig,
                 vision_cfg: Optional[CLIPVisionConfig] = None,
                 beam_size: int = 16, pairwise_loss_lam: float = 0.6,
                 time_contrastive: bool = False,
                 multimodal_loss: bool = False):
        super().__init__()
        h = cfg.encoder.hidden_size
        if cfg.multimodal and cfg.multimodal_img_part:
            raise NotImplementedError(
                "BERSON requires the text stream; --multimodal_img_part "
                "is incompatible with the wrapper")
        self.cfg = cfg
        self.beam_size = beam_size
        self.pairwise_loss_lam = pairwise_loss_lam
        self.time_contrastive = time_contrastive
        self.multimodal_loss = multimodal_loss
        if not cfg.multimodal:
            self.inner = TextEncoder(cfg.encoder)
        elif cfg.multimodal_model_type == "clip":
            self.inner = MultimodalEncoder(cfg, vision_cfg)
        elif cfg.multimodal_model_type == "visualbert":
            self.inner = VisualBERTEncoder(cfg)
        elif cfg.multimodal_model_type == "naive":
            self.inner = NaiveMultimodalModel(cfg, cfg.vision_model)
        else:
            raise NotImplementedError(
                f"berson inner model type {cfg.multimodal_model_type} (the "
                f"JAX package and the reference raise here too)")
        self.two_level_encoder = HierarchicalAttention(cfg)
        self.para_encoder = TransformerInterEncoder(h)
        self.key_linear = Dense(2 * h, h)
        self.query_linear = Dense(h, h)
        self.tanh_linear = Dense(h, 1)
        self.pw_k = Dense(4 * (h + 2), h, bias=False)
        self.decoder = LSTMCell(h, h)
        if cfg.wrapper_model_with_heatmap:
            self.heatmap = HeatmapHead(cfg, dtype=torch.float32)
        # the image-stream pairwise head exists where the JAX module's is
        # called: over a visual stream
        if (multimodal_loss and cfg.multimodal
                and not cfg.multimodal_text_part):
            self.img_projection = Dense(h, h)
            self.img_pairwise_relationship = Dense(h, 2)
        n = cfg.max_story_length
        self.register_buffer("pairs", _const(berson_pairs(n)),
                             persistent=False)

    @property
    def vision_cfg(self) -> Optional[CLIPVisionConfig]:
        """The CLIP inner's tower config (None for the other inners)."""
        return getattr(self.inner, "vcfg", None)

    # ----- encoding ----------------------------------------------------------

    def encode(self, batch: Dict[str, torch.Tensor],
               deterministic: bool = True,
               rng: Optional[DropoutRng] = None,
               trunk_out: Optional[torch.Tensor] = None) -> Dict:
        """The pairs through the inner encoder, the hierarchical attention
        and the paragraph encoder: doc, key, the LSTM's initial (h, c), the
        pairwise scores and the relation matrices. `trunk_out`, a
        precomputed (B * P, L, H) sequence output of the inner text
        encoder, replaces the inner encoder (the hook of the pipelined step,
        `parallel/pipeline.py::make_berson_pipeline_train_step`); a
        multimodal inner, which fuses vision inside the trunk, raises
        NotImplementedError."""
        cfg = self.cfg
        rng = check_rng(deterministic, rng)
        if trunk_out is not None and cfg.multimodal:
            raise NotImplementedError(
                "trunk_out replaces the plain text trunk; multimodal "
                "inner encoders cannot be pipelined this way")
        ids = batch["input_ids"]
        b, p, L = ids.shape

        def flat(x):
            return x.reshape((b * p,) + x.shape[2:])

        args = (flat(ids), flat(batch["attention_mask"]),
                flat(batch["token_type_ids"]))
        images = batch.get("images")
        visn_cls = None
        if (cfg.multimodal and not cfg.multimodal_text_part
                and images is not None):
            # each pair's two step images: (B, P, 2, ...) -> (B * P, 2, ...)
            out = self.inner(*args, images=flat(images[:, self.pairs]),
                             deterministic=deterministic, rng=rng)
            if cfg.multimodal_model_type == "naive":
                # the image tokens follow the text; the first is the CLS
                seq = out["sequence_output"]
                lang, visn = seq[:, :L], seq[:, L:]
            else:
                lang, visn, _ = out
            if visn is not None:  # the image stream's CLS
                visn_cls = visn[:, 0].reshape(b, p, -1)
        elif trunk_out is not None:
            lang = trunk_out
        else:
            out = self.inner(*args, deterministic=deterministic, rng=rng)
            lang = out["sequence_output"] if isinstance(out, dict) else out[0]
        top_vec = lang.reshape(b, p, L, -1)
        mask_cls = batch["mask_cls"].float()
        doc, cls_out_m, cls_score, cls_score_m, his1_m, his2_m = \
            self.two_level_encoder(top_vec, top_vec[:, :, 0],
                                   batch["sep_positions"], mask_cls, rng)
        para = self.para_encoder(doc, mask_cls, rng) * mask_cls[:, :, None]
        num_sen = mask_cls.sum(1, keepdim=True)
        para_vec = para.sum(1) / torch.clamp(num_sen, min=1e-20)
        out = dict(doc=doc, key=self.key_linear(torch.cat([doc, para], -1)),
                   hcn=(para_vec, torch.zeros_like(para_vec)),
                   cls_score=cls_score, cls_output_matrix=cls_out_m,
                   cls_score_matrix=cls_score_m, his1_matrix=his1_m,
                   his2_matrix=his2_m, mask_cls=mask_cls)
        if hasattr(self, "img_projection") and visn_cls is not None:
            out["cls_score_img"] = self.img_pairwise_relationship(
                self.img_projection(visn_cls))
        return out

    @staticmethod
    def rela_encode(cls_output_matrix, cls_score_matrix) -> torch.Tensor:
        """[CLS vector; softmax of the pairwise scores] for every (i, j),
        in f32."""
        return torch.cat([cls_output_matrix.float(),
                          torch.softmax(cls_score_matrix, dim=-1)], dim=-1)

    def _pointer_logits_step(self, lstm, h, c, dec_inp, key, rela_vec,
                             rela_mask, hist, l1_row, l2_row, pointed,
                             mask_cls):
        """One pointer step, shared by training and the beam search: the
        LSTM on `dec_inp`, then additive attention over the steps with the
        relation features of the last two picks (`l1_row`, `l2_row`: -1 for
        none). Returns (h, c, logits)."""
        c, h = LSTMCell.step(lstm, c, h, dec_inp)
        query = self.query_linear(h)
        rows = torch.arange(h.shape[0], device=h.device)

        def hist_row(row):
            got = hist[rows, row.clamp(min=0)]               # (B, N, H + 2)
            return torch.where((row >= 0)[:, None, None], got, 0.0)

        masked_rela = rela_vec * rela_mask[..., None]
        # the mean over N counts the masked zeros (a quirk of the reference)
        pw = torch.cat([hist_row(l1_row), hist_row(l2_row),
                        masked_rela.mean(2), masked_rela.mean(1)], dim=-1)
        e = self.tanh_linear(torch.tanh(query[:, None, :] + self.pw_k(pw)
                                        + key))[..., 0]
        e = torch.where(pointed, NEG, e)
        return h, c, torch.where(mask_cls > 0, e, NEG)

    @staticmethod
    def _drop_rows(rela_mask, picked):
        """rela_mask with row and column `picked` (B,) cleared."""
        n = rela_mask.shape[-1]
        ar = torch.arange(n, device=picked.device)
        hit = ((ar[None, :, None] == picked[:, None, None])
               | (ar[None, None, :] == picked[:, None, None]))
        return rela_mask & ~hit

    # ----- training ----------------------------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor],
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None,
                trunk_out: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The training losses: pointer NLL over the chain `ground_truth`
        (teacher forced) + pairwise_loss_lam x the pairwise CE over the true
        pairs, plus the optional image-stream pairwise CE, 0.1 x the
        time-contrastive triplet loss and the heat-map BCE; means over the
        batch entries marked `valid`. `trunk_out`: as `encode`'s."""
        n = self.cfg.max_story_length
        enc = self.encode(batch, deterministic, rng, trunk_out)
        doc, key, mask_cls = enc["doc"], enc["key"], enc["mask_cls"]
        target = batch["ground_truth"].long()                  # (B, N)
        b = target.shape[0]
        bidx = torch.arange(b, device=doc.device)
        # the history rows use the relation matrix of the pairwise scores
        # too (a quirk of the reference)
        rela_vec = hist = self.rela_encode(enc["cls_output_matrix"],
                                           enc["cls_score_matrix"])
        live = mask_cls > 0
        eye = torch.eye(n, dtype=torch.bool, device=doc.device)
        rela_mask = ~eye & live[:, :, None] & live[:, None, :]
        h, c = enc["hcn"]
        lstm = self.decoder.fused()
        pointed = torch.zeros((b, n), dtype=torch.bool, device=doc.device)
        neg1 = torch.full((b,), -1, dtype=torch.long, device=doc.device)
        dec_inp, l1_row, l2_row = torch.zeros_like(doc[:, 0]), neg1, neg1
        logits = []
        for t in range(n):
            if t > 0:
                tar = target[:, t - 1]
                dec_inp = doc[bidx, tar]
                rela_mask = self._drop_rows(rela_mask, tar)
                l1_row, l2_row = tar, target[:, t - 2] if t > 1 else neg1
                pointed = pointed | F.one_hot(tar, n).bool()
            h, c, e = self._pointer_logits_step(
                lstm, h, c, dec_inp, key, rela_vec, rela_mask, hist, l1_row,
                l2_row, pointed, mask_cls)
            logits.append(e)
        logits = torch.stack(logits, dim=1)                    # (B, N, N)

        nll = -log_softmax(logits).gather(2, target[:, :, None])[..., 0]
        nll = nll * mask_cls.gather(1, target)
        pointer_loss = nll.sum(1) / torch.clamp(mask_cls.sum(1) - 1,
                                                min=1e-20)
        # the pairwise CE over the true pairs of each story
        plabels = batch["pairwise_labels"].long()[:, :, None]
        vp = mask_cls[:, self.pairs[:, 0]] * mask_cls[:, self.pairs[:, 1]]

        def pair_ce(scores):
            nll = -log_softmax(scores).gather(2, plabels)[..., 0]
            return (nll * vp).sum(1) / torch.clamp(vp.sum(1), min=1e-20)

        valid = batch.get("valid")

        def mean(x):  # in a data-parallel step, this rank's share
            if valid is None:
                return global_mean(x)
            v = valid.float()
            return (x * v).sum() / torch.clamp(global_count(v.sum()), min=1)

        pointer_loss, pairwise_loss = mean(pointer_loss), mean(
            pair_ce(enc["cls_score"]))
        loss = pointer_loss + self.pairwise_loss_lam * pairwise_loss
        out = {"pointer_loss": pointer_loss, "pairwise_loss": pairwise_loss,
               "pointer_logits": logits}
        if "cls_score_img" in enc:  # the multimodal_loss head ran
            img_loss = mean(pair_ce(enc["cls_score_img"]))
            out["img_pairwise_loss"] = img_loss
            loss = loss + self.pairwise_loss_lam * img_loss
        if self.time_contrastive and "tc_anchor" in batch:
            # true-time anchor / positive / negative -> their steps' vectors
            def vec(times):
                return doc[bidx, target[bidx, times.long()]]
            a = vec(batch["tc_anchor"])
            d_ap = torch.linalg.vector_norm(a - vec(batch["tc_positive"]),
                                            dim=-1)
            d_an = torch.linalg.vector_norm(a - vec(batch["tc_negative"]),
                                            dim=-1)
            tc_loss = mean(torch.clamp(d_ap - d_an + 1.0, min=0.0))
            out["time_contrastive_loss"] = tc_loss
            loss = loss + 0.1 * tc_loss
        if self.cfg.wrapper_model_with_heatmap:
            hm = self.heatmap(doc, live)
            out["heatmap"] = hm
            out["heatmap_loss"] = HeatmapHead.loss(
                hm, render_heatmap_targets(target, n), live)
            loss = loss + out["heatmap_loss"]
        out["loss"] = loss
        return out

    # ----- inference ---------------------------------------------------------

    @torch.no_grad()
    def beam_search(self, batch: Dict[str, torch.Tensor],
                    enc: Optional[Dict] = None) -> torch.Tensor:
        """Batched beam search: W beams a story for N - 1 pointer steps
        (a story of m < N steps takes m - 1, the later steps leave its beams
        as they are), then the leftover step. All B x W beams are one batch
        of the shared pointer step. `enc`: `encode(batch)`'s output, when
        the caller has it. Returns (B, N) chains, -1 past each story's
        length."""
        n, W = self.cfg.max_story_length, self.beam_size
        if enc is None:
            enc = self.encode(batch)
        doc, key, mask_cls = enc["doc"], enc["key"], enc["mask_cls"]
        dev = doc.device
        b = doc.shape[0]

        def tile(x):  # (B, ...) -> (B * W, ...)
            return x.repeat_interleave(W, dim=0)

        rela = tile(self.rela_encode(enc["cls_output_matrix"],
                                     enc["cls_score_matrix"]))
        live = mask_cls > 0
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        rela_mask = tile(~eye & live[:, :, None] & live[:, None, :])
        keyW, maskW, docW = tile(key), tile(mask_cls), tile(doc)
        h, c = (tile(x) for x in enc["hcn"])
        lstm = self.decoder.fused()
        pointed = torch.zeros((b * W, n), dtype=torch.bool, device=dev)
        cands = torch.zeros((b * W, n), dtype=torch.long, device=dev)
        scores = torch.full((W,), NEG, device=dev)
        scores[0] = 0.0
        scores = scores.repeat(b)
        bw = torch.arange(b * W, device=dev)
        story0 = torch.arange(b, device=dev)[:, None] * W
        neg1 = torch.full((b * W,), -1, dtype=torch.long, device=dev)
        num_sen = mask_cls.sum(1).long()
        dec_inp, l1_row, l2_row = docW.new_zeros(b * W, doc.shape[-1]), \
            neg1, neg1
        for t in range(n - 1):
            if t > 0:
                last = cands[:, t - 1]
                dec_inp = docW[bw, last]
                l1_row, l2_row = last, cands[:, t - 2] if t > 1 else neg1
            h2, c2, e = self._pointer_logits_step(
                lstm, h, c, dec_inp, keyW, rela, rela_mask, rela, l1_row,
                l2_row, pointed, maskW)
            total = (scores[:, None] + log_softmax(e)).reshape(b, W * n)
            # the top W, ties to the lower index (`lax.top_k`'s order)
            top_scores, top_ix = torch.sort(total, dim=1, descending=True,
                                            stable=True)
            top_scores, top_ix = top_scores[:, :W], top_ix[:, :W]
            tok_ix = (top_ix % n).reshape(-1)
            act = (t < num_sen - 1).repeat_interleave(W)         # (B * W,)
            sel = torch.where(act, (story0 + top_ix // n).reshape(-1), bw)
            col = act[:, None]
            h = torch.where(col, h2[sel], h)
            c = torch.where(col, c2[sel], c)
            pointed = torch.where(col, pointed[sel] | F.one_hot(
                tok_ix, n).bool(), pointed)
            new_cands = cands[sel].clone()
            new_cands[:, t] = tok_ix
            cands = torch.where(col, new_cands, cands)
            scores = torch.where(act, top_scores.reshape(-1), scores)
            rela_mask = torch.where(act[:, None, None],
                                    self._drop_rows(rela_mask[sel], tok_ix),
                                    rela_mask)
        best = story0[:, 0] + scores.view(b, W).argmax(dim=1)
        chain = cands[best].clone()
        # the leftover step goes to the story's last slot
        leftover = (pointed[best].int() + (~live).int() * 2).argmin(dim=1)
        chain[torch.arange(b, device=dev), num_sen - 1] = leftover
        ar = torch.arange(n, device=dev)
        return torch.where(ar[None] < num_sen[:, None], chain, -1)
