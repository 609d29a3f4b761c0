"""Loss and train steps (counterpart of `train/steps.py`: the sequencer's
step (v0 classification and the heat-map heads), BERSON's and the
pretrainer's).

`train_step` is one eager step: forward in train mode, the task loss,
backward, the gradient norm, and the optimizer update (`train/state.py`).
`berson_train_step` is the same around BERSON, whose forward returns its
own loss, and `pretrain_step` around the pretrainer, whose forward returns
the loss dict of one planned objective.
Its dropout streams derive from (seed + 1, step), as the JAX step folds the
step into `PRNGKey(seed + 1)`. A multimodal batch's `images` go to the
model as shipped (uint8 or f32); the train-mode forward updates the vision
tower's BatchNorm statistics, once a step, before the gradient, as the JAX
step's `mutable=["batch_stats"]` apply does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.encoder import DropoutRng
from ..models.heads import HeatmapHead
from ..models.sequencer import render_heatmap_targets

# host-only entries of a collated batch
_HOST_KEYS = ("guid", "texts")


def masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over batch entries marked valid (the padding of the final
    partial batch contributes no gradient)."""
    v = valid.to(values.dtype)
    return (values * v).sum() / torch.clamp(v.sum(), min=1)


def compute_loss(cfg, outputs: dict, batch: dict):
    """Task loss by hierarchical_version. Returns (loss, metrics). v0: the
    cross entropy of the logits against the integer labels and the
    accuracy, each a mean over the valid rows; v1-v3: the heat map's BCE
    (plus the pairwise ranking aux)."""
    v = cfg.hierarchical_version
    valid = batch.get("valid")
    if v == "v0":
        logits = outputs["logits"].float()
        labels = batch["labels"].long()
        ce = torch.nn.functional.cross_entropy(logits, labels,
                                               reduction="none")
        acc = (logits.argmax(-1) == labels).float()
        if valid is None:
            loss, acc = ce.mean(), acc.mean()
        else:
            loss, acc = masked_mean(ce, valid), masked_mean(acc, valid)
        return loss, {"loss": loss, "acc": acc}
    if v not in ("v1", "v2", "v3"):
        raise NotImplementedError(
            f"hierarchical_version {v!r}: the port trains the classification "
            f"and heat-map heads so far (the pointer heads: ROADMAP A5d)")
    order_labels = batch["labels"].long()
    target = render_heatmap_targets(order_labels, cfg.max_story_length)
    present = outputs["present"]
    if valid is not None:
        present = present & valid[:, None]
    loss = HeatmapHead.loss(outputs["heatmap"], target, present)
    if "heatmap_pairwise_ranking" in (cfg.hl_include_objectives or []):
        loss = loss + HeatmapHead.pairwise_ranking_loss(
            outputs["heatmap"], order_labels, present)
    return loss, {"loss": loss}


def device_batch(batch: dict, device) -> Dict[str, torch.Tensor]:
    """The array entries of a collated numpy batch as tensors on `device`
    (ids and labels as int64, `valid` as bool, `images` in their own
    dtype: uint8 or f32)."""
    out = {}
    for k, val in batch.items():
        if k in _HOST_KEYS or not isinstance(val, np.ndarray):
            continue
        t = torch.from_numpy(val)
        if k == "images":
            out[k] = t.to(device)
        else:
            out[k] = t.to(device, torch.bool if k == "valid" else torch.long)
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, accumulated in f64 and
    returned in f32 (an f32 sum over the 51M-entry embedding gradient on
    the CPU drifts by ~1e-4 relative)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        tensors, dtype=torch.float64))).float()


def train_step(model, optimizer, batch: dict, step: int, seed: int
               ) -> Dict[str, torch.Tensor]:
    """One train step on `batch` (a collated numpy batch); returns the loss
    and the gradient's global norm as tensors on the model's device (no
    host sync). `step` is the micro-step count the dropout derives from."""
    device = next(model.parameters()).device
    db = device_batch(batch, device)
    model.train()
    outputs = model(db["input_ids"], db.get("attention_mask"),
                    db.get("token_type_ids"), images=db.get("images"),
                    deterministic=False,
                    rng=DropoutRng(seed + 1, step, device))
    loss, _ = compute_loss(model.cfg, outputs, db)
    return _update(optimizer, loss)


def berson_train_step(model, optimizer, batch: dict, step: int, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """One train step of `BersonOrdering` on `batch` (a collated numpy batch
    of `BersonDataset`, with the time-contrastive plan's `tc_*` entries when
    that objective is on): its loss as the model returns it, then the same
    clipping and AdamW update as `train_step`, with the same dropout
    streams; a multimodal inner's BatchNorm statistics update once."""
    device = next(model.parameters()).device
    model.train()
    out = model(device_batch(batch, device), deterministic=False,
                rng=DropoutRng(seed + 1, step, device))
    return _update(optimizer, out["loss"])


def pretrain_step(model, optimizer, batch: dict, aux: dict, objective: str,
                  step: int, seed: int, use_mlm: bool = True
                  ) -> Dict[str, torch.Tensor]:
    """One train step of `SequencingPretrainer` on a planned batch (numpy:
    the masked batch and the plan's aux arrays of `objective`): the loss
    dict as the model returns it, then the same clipping and AdamW update
    as `train_step`, with the same dropout streams; the tower's BatchNorm
    statistics update once. Returns the loss dict and the gradient's global
    norm as tensors on the model's device."""
    device = next(model.parameters()).device
    model.train()
    losses = model(device_batch(batch, device), objective,
                   device_batch(aux, device), deterministic=False,
                   rng=DropoutRng(seed + 1, step, device), use_mlm=use_mlm)
    out = _update(optimizer, losses["loss"])
    return {**{k: v.detach() for k, v in losses.items()}, **out}


def _update(optimizer, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    optimizer.zero_grad()
    loss.backward()
    grad_norm = optimizer.step(optimizer.grads())
    return {"loss": loss.detach(), "grad_norm": grad_norm}
