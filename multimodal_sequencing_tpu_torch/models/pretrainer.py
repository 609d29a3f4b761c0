"""Sequencing pretrainer: MLM and the sequentiality objectives' heads
(counterpart of `models/pretrainer.py`).

One objective runs a batch, chosen and planned on the host
(`train/objectives.py`); the model computes its loss from the planned batch
and the plan's auxiliary arrays:
  * MLM over the language positions: a transform + tied-embedding decoder
    (`MLMHead`), cross entropy over the masked positions;
  * a binary classifier on the pooled output for each objective of
    `BINARY_OBJECTIVES` (`{objective}_mlp`);
  * margin ranking on a scalar head between the (i, j) and (i, k) halves
    of a doubled batch (`margin_loss_mlp`);
  * triplets over the steps' CLS outputs (`time_contrastive`);
  * patch MRM: the masked patch outputs matched to the shuffled pre-mask
    features by a bilinear MLP (`mrm_dense`, `mrm_ln`, `mrm_out`), cross
    entropy over the candidates, scaled by 0.2.

The encoder is the text encoder or, by `multimodal_model_type`, the
VisualBERT encoder (`visualbert`), the naive model (`naive`) or the CLIP
joint encoder (any other type, `naive_model` included, as the JAX
pretrainer builds it). The patch objectives corrupt the CLIP encoder's
folded stream and raise ValueError under the other two.

The heads are built as Flax creates their parameters: only for the
configured objectives (`cfg.multimodal_pretrain_objectives`), since the JAX package initializes the
model by tracing each of them. `mlm_head` exists unless
`multimodal_img_part` (that init always traces MLM, `no_mlm` included);
`time_contrastive` has no head. So the port's `state_dict` keys are the JAX
tree's, which `models/convert.py::params_from_jax` relies on and AdamW's
weight decay follows.

Dtypes follow Flax's promotion: the MLM transform runs in the compute dtype
and its LayerNorm in f32, so the vocabulary product is f32 against the f32
table; the objective heads are f32 over the compute-dtype `pooled`;
`time_contrastive`'s distances stay in the compute dtype, and its loss joins
the total in it before the f32 MLM term is added. The encoders run every
attention call through the flash kernels on the card; the heads' GELUs are
plain `F.gelu`: exact erf in `MLMHead`, tanh in the MRM head (Flax's
`nn.gelu` default), neither of them the encoder's logit_erf kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import CLIPVisionConfig, MultimodalConfig
from .encoder import Dense, DropoutRng, LayerNorm, TextEncoder, check_rng
from .multimodal_encoder import MultimodalEncoder
from .naive_model import NaiveMultimodalModel, naive_encode_parts
from .visualbert import VisualBERTEncoder

BINARY_OBJECTIVES = (
    "image_swapping", "image_sequence_predictions",
    "whole_image_sequence_swapping", "patch_based_image_swapping",
    "patch_based_image_sequence_predictions",
    "multimodal_swapping", "swapping_based_nsp", "sequence_based_nsp",
)
MARGIN_OBJECTIVES = ("margin_loss", "multimodal_margin_loss")
MRM_OBJECTIVE = "patch_based_mrm_classification"


def resolve_objectives(names) -> Tuple[List[str], bool]:
    """(the objectives a batch draws from, whether MLM runs) from
    `--multimodal_pretrain_objectives`, as the JAX package reads it:
    `no_mlm` turns MLM off, `visual_mlm` is accepted and does nothing, and
    with no objective left MLM runs alone (`mlm_only`)."""
    names = list(names or [])
    objectives = [o for o in names if o not in ("no_mlm", "visual_mlm")]
    return objectives or ["mlm_only"], "no_mlm" not in names


class MLMHead(nn.Module):
    """Dense (compute dtype) + exact-erf GELU + LayerNorm (eps 1e-12) in f32
    (the compute dtype promoted with f32, as Flax promotes), then the
    product with the word-embedding table (given at call time: the decoder
    is tied, not a parameter of its own) plus `bias`, in that dtype."""

    def __init__(self, hidden_size: int, vocab_size: int,
                 dtype: torch.dtype):
        super().__init__()
        self.transform = Dense(hidden_size, hidden_size, dtype)
        self.ln = LayerNorm(hidden_size, 1e-12,
                            torch.promote_types(dtype, torch.float32))
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, hidden: torch.Tensor,
                word_embedding: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.transform(hidden), approximate="none")
        x = self.ln(x.to(self.ln.compute_dtype))
        return F.linear(x, word_embedding.to(x.dtype)) + self.bias


class SequencingPretrainer(nn.Module):
    def __init__(self, cfg: MultimodalConfig,
                 vision_cfg: Optional[CLIPVisionConfig] = None):
        """Builds the heads of `cfg.multimodal_pretrain_objectives`
        (`resolve_objectives`)."""
        super().__init__()
        self.cfg = cfg
        self.objectives, _ = resolve_objectives(
            cfg.multimodal_pretrain_objectives)
        h = cfg.encoder.hidden_size
        mt = cfg.multimodal_model_type
        if not cfg.multimodal:
            self.encoder = TextEncoder(cfg.encoder)
        elif mt == "visualbert":
            self.encoder = VisualBERTEncoder(cfg)
        elif mt == "naive":
            self.encoder = NaiveMultimodalModel(cfg, cfg.vision_model)
        else:  # clip, and naive_model: the JAX pretrainer builds CLIP there
            self.encoder = MultimodalEncoder(cfg, vision_cfg)
        if not cfg.multimodal_img_part:
            self.mlm_head = MLMHead(h, cfg.encoder.vocab_size,
                                    cfg.encoder.compute_dtype)
        for name in dict.fromkeys(self.objectives):
            if name in BINARY_OBJECTIVES:
                self.add_module(f"{name}_mlp", Dense(h, 2))
            elif name in MARGIN_OBJECTIVES and not hasattr(
                    self, "margin_loss_mlp"):
                self.margin_loss_mlp = Dense(h, 1)
            elif name == MRM_OBJECTIVE:
                self.mrm_dense = Dense(2 * h, h)
                self.mrm_ln = LayerNorm(h, 1e-12)
                self.mrm_out = Dense(h, 1)

    @property
    def vision_cfg(self) -> Optional[CLIPVisionConfig]:
        """The CLIP tower's config (None for the other encoders)."""
        return getattr(self.encoder, "vcfg", None)

    def _head(self, name: str) -> nn.Module:
        head = getattr(self, name, None)
        if head is None:
            raise ValueError(
                f"the pretrainer has no {name}: it builds the heads of the "
                f"objectives it was given ({self.objectives})")
        return head

    def _encode(self, batch, deterministic, rng, patch_perm=None,
                mask_idx=None, patch_src=None):
        """(lang_out, visn_out, pooled, mrm_gt), with the folded visual
        stream's patch surgery between `encode_visual` and `joint_encode`:
        `patch_perm` permutes the stream within a sample, or with
        `patch_src` (a (B, S) map of samples) across samples, out[b, t] =
        visn[patch_src[b, t], patch_perm[b, t]]; `mask_idx` zeroes the
        tokens it names and returns their features before the zeroing
        (`mrm_gt`, which keeps its gradient)."""
        cfg = self.cfg
        ids = batch["input_ids"]
        attn = batch.get("attention_mask")
        types = batch.get("token_type_ids")
        images = batch.get("images")
        surgery = patch_perm is not None or mask_idx is not None
        if surgery and (not cfg.multimodal or cfg.multimodal_text_part
                        or images is None):
            # the planner's 'corrupted' labels would train the head on noise
            raise ValueError(
                "patch-based pretraining objectives need the folded CLIP "
                "visual stream (multimodal clip config with images; "
                "multimodal_text_part off)")
        if not cfg.multimodal:
            seq, pooled = self.encoder(ids, attn, types, deterministic, rng)
            return seq, None, pooled, None
        mt = cfg.multimodal_model_type
        if mt in ("visualbert", "naive"):
            # per-step visual tokens: no folded patch stream to corrupt
            if surgery:
                raise ValueError(
                    f"patch-based pretraining objectives need the folded "
                    f"CLIP visual stream; model type {mt} has per-step "
                    f"visual tokens")
            if mt == "visualbert":
                return (*self.encoder(ids, attn, types, images,
                                      deterministic=deterministic, rng=rng),
                        None)
            return (*naive_encode_parts(cfg, self.encoder, ids, attn, types,
                                        images, deterministic, rng), None)
        enc = self.encoder
        lang, attn2 = enc.embed_language(ids, attn, types, rng)
        visn = mrm_gt = None
        if images is not None and not cfg.multimodal_text_part:
            visn = enc.encode_visual(images, deterministic, rng)
            stream = 1 + images.shape[1] * cfg.patch_grid ** 2
            if surgery and visn.shape[1] != stream:
                # JAX's gathers clamp out-of-range indices; here they would
                # fault on the card
                raise ValueError(
                    f"the patch plans index a folded stream of {stream} "
                    f"tokens (patch_grid {cfg.patch_grid}); the tower gives "
                    f"{visn.shape[1]} (grid {enc.vcfg.grid})")
            bidx = torch.arange(visn.shape[0], device=visn.device)[:, None]
            if patch_perm is not None:
                src = bidx if patch_src is None else patch_src.long()
                visn = visn[src, patch_perm.long()]
            if mask_idx is not None:
                idx = (bidx.expand(mask_idx.shape), mask_idx.long())
                mrm_gt = visn[idx]
                visn = visn.index_put(idx, visn.new_zeros(()))
        lang_out, visn_out, pooled = enc.joint_encode(lang, visn, attn2, rng)
        return lang_out, visn_out, pooled, mrm_gt

    def forward(self, batch: Dict[str, torch.Tensor],
                objective: Optional[str] = None,
                aux: Optional[Dict[str, torch.Tensor]] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None,
                use_mlm: bool = True) -> Dict[str, torch.Tensor]:
        """The loss dict of `objective` on a planned batch: the objective's
        loss under its name, `mlm` when MLM runs, and their sum `loss`.
        Train mode (`deterministic=False`) needs `rng` and updates the
        tower's BatchNorm statistics."""
        cfg = self.cfg
        aux = aux or {}
        rng = check_rng(deterministic, rng)
        losses: Dict[str, torch.Tensor] = {}
        lang_out, visn_out, pooled, mrm_gt = self._encode(
            batch, deterministic, rng, patch_perm=aux.get("patch_perm"),
            mask_idx=aux.get("mask_idx"), patch_src=aux.get("patch_src"))

        total = 0.0
        if objective in BINARY_OBJECTIVES:
            logits = self._head(f"{objective}_mlp")(pooled)
            labels = aux["objective_labels"].long()
            ce = -F.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
            losses[objective] = ce.mean()
            total = total + losses[objective]

        elif objective in MARGIN_OBJECTIVES:
            logit = self._head("margin_loss_mlp")(pooled)[:, 0]
            half = logit.shape[0] // 2
            x1, x2 = logit[:half], logit[half:]
            target = aux["margin_target"].float()
            # MarginRankingLoss(margin=1): max(0, -y (x1 - x2) + 1)
            losses[objective] = torch.clamp(-target * (x1 - x2) + 1.0,
                                            min=0.0).mean()
            total = total + losses[objective]

        elif objective == "time_contrastive":
            ids = batch["input_ids"]
            is_cls = (ids == cfg.cls_id).long()
            rank = torch.cumsum(is_cls, 1) * is_cls
            n = cfg.max_story_length
            steps = torch.arange(1, n + 1, device=ids.device)
            onehot = rank[:, :, None] == steps[None, None]
            # the first position of each step's CLS (0 for a missing step);
            # clamped to the encoded length, as JAX's gather clamps
            pos = onehot.to(torch.uint8).argmax(1).clamp(
                max=lang_out.shape[1] - 1)
            bidx = torch.arange(ids.shape[0], device=ids.device)
            step_cls = lang_out[bidx[:, None], pos]  # (B, N, H)
            a = step_cls[bidx, aux["anchor_idx"].long()]
            p = step_cls[bidx, aux["positive_idx"].long()]
            g = step_cls[bidx, aux["negative_idx"].long()]
            d_ap = torch.linalg.vector_norm(a - p, dim=-1)
            d_an = torch.linalg.vector_norm(a - g, dim=-1)
            losses[objective] = torch.clamp(d_ap - d_an + 1.0,
                                            min=0.0).mean()
            total = total + losses[objective]

        elif objective == MRM_OBJECTIVE:
            if mrm_gt is None or visn_out is None:
                raise ValueError(f"{MRM_OBJECTIVE} needs the visual stream")
            mask_idx = aux["mask_idx"].long()
            perm = aux["shuffle_perm"].long()
            b, t = mask_idx.shape
            bidx = torch.arange(b, device=mask_idx.device)[:, None]
            outs = visn_out[bidx, mask_idx].float()  # masked outputs
            gt = mrm_gt[bidx, perm].float()
            # scores[b, j, k] = head([outs_j ; gt_k])
            pairs = torch.cat([outs[:, :, None, :].expand(-1, -1, t, -1),
                               gt[:, None, :, :].expand(-1, t, -1, -1)], -1)
            x = F.gelu(self._head("mrm_dense")(pairs), approximate="tanh")
            scores = self.mrm_out(self.mrm_ln(x))[..., 0]  # (B, T, T)
            labels = torch.argsort(perm, dim=1)  # position of j in shuffle
            ce = -F.log_softmax(scores, -1).gather(
                2, labels[:, :, None])[..., 0]
            losses[objective] = 0.2 * ce.mean()
            total = total + losses[objective]

        if use_mlm and "mlm_labels" in batch and not cfg.multimodal_img_part:
            logits = self.mlm_head(
                lang_out, self.encoder.embeddings.word_embeddings.weight)
            labels = batch["mlm_labels"].long()
            n_valid = (labels != cfg.mlm_ignore_index).sum()
            ce = F.cross_entropy(logits.flatten(0, 1), labels.flatten(),
                                 ignore_index=cfg.mlm_ignore_index,
                                 reduction="sum")
            losses["mlm"] = ce / n_valid.clamp(min=1)
            total = total + losses["mlm"]

        if not torch.is_tensor(total):
            # no loss term ran (`no_mlm` alone): a zero on the graph, so the
            # step's backward gives every gradient as zero, as JAX's does
            total = pooled.float().sum() * 0.0
        losses["loss"] = total
        return losses
