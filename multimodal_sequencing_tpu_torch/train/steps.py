"""Loss and train steps (counterpart of `train/steps.py`: the sequencer's
step (v0 classification, the heat-map and pointer heads with their
auxiliary objectives, the pure_decode encoder-decoder), BERSON's and the
pretrainer's).

`train_step` is one eager step: forward in train mode (the order labels
given to the pointer heads and the decoder), the task loss, backward, the
gradient norm, and the optimizer update (`train/state.py`).
`berson_train_step` is the same around BERSON, whose forward returns its
own loss, and `pretrain_step` around the pretrainer, whose forward returns
the loss dict of one planned objective.
Its dropout streams derive from (seed + 1, step), as the JAX step folds the
step into `PRNGKey(seed + 1)`. A multimodal batch's `images` go to the
model as shipped (uint8 or f32), its ROI sidecars
(`img_regional_features`) as f32; the train-mode forward updates the vision
tower's BatchNorm statistics, once a step, before the gradient, as the JAX
step's `mutable=["batch_stats"]` apply does.

On a parallelized model (`parallel/sharding_rules.py::parallelize`) a step
runs in the data group's context (`parallel/mesh.py::data_parallel`): the
rank takes its rows of the global batch (`device_batch`), every mean of
the loss divides by the global count, so the ranks' loss terms add up to
the single-process loss, the backward runs through the DDP or FSDP2
module on the loss times n_data (both average the ranks' gradients), and
the returned loss and metrics are summed over the data group.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.encoder import DropoutRng
from ..models.heads import HeatmapHead, PointerHead
from ..models.sequencer import render_heatmap_targets
from ..parallel.mesh import (batch_slice, data_parallel, global_count,
                             global_mean, step_layout)
from ..parallel.sharding_rules import parallel_of

# host-only entries of a collated batch
_HOST_KEYS = ("guid", "texts")
# the versions whose forward takes the order labels in training
ORDER_LABELLED = ("p0", "p1", "decode")


def masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over batch entries marked valid (the padding of the final
    partial batch contributes no gradient); in a data-parallel step this
    rank's share, over the valid entries of the global batch."""
    v = valid.to(values.dtype)
    return (values * v).sum() / torch.clamp(global_count(v.sum()), min=1)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy of f32 logits against integer labels."""
    return F.cross_entropy(logits.float().transpose(1, -1)
                           if logits.dim() > 2 else logits.float(),
                           labels.long(), reduction="none")


def compute_loss(cfg, outputs: dict, batch: dict):
    """Task loss by hierarchical_version. Returns (loss, metrics). v0: the
    cross entropy of the logits against the integer labels and the
    accuracy, each a mean over the valid rows; v1-v3: the heat map's BCE
    (plus the pairwise ranking aux); p0/p1: the pointer NLL; both plus the
    auxiliary objectives' terms (`aux_*` in the metrics); decode: the
    teacher-forced cross entropy over the index tokens and the token
    accuracy (`token_acc`), each a mean over the valid rows."""
    v = cfg.hierarchical_version
    valid = batch.get("valid")

    def mean(x):
        return global_mean(x) if valid is None else masked_mean(x, valid)

    metrics = {}
    if v == "v0":
        logits = outputs["logits"].float()
        labels = batch["labels"].long()
        loss = mean(_ce(logits, labels))
        metrics["acc"] = mean((logits.argmax(-1) == labels).float())
    elif v == "decode":
        logits = outputs["dec_logits"]  # (B, N, V)
        labels = batch["labels"].long()
        loss = mean(_ce(logits, labels).mean(-1))
        metrics["token_acc"] = mean(
            (logits.argmax(-1) == labels).float().mean(-1))
    elif v in ("v1", "v2", "v3", "p0", "p1"):
        order_labels = batch["labels"].long()
        present = outputs["present"]
        if valid is not None:
            present = present & valid[:, None]
        if v in ("p0", "p1"):
            loss = PointerHead.loss(outputs["pointer_logits"], order_labels,
                                    present)
        else:
            target = render_heatmap_targets(order_labels,
                                            cfg.max_story_length)
            loss = HeatmapHead.loss(outputs["heatmap"], target, present)
            if "heatmap_pairwise_ranking" in (cfg.hl_include_objectives
                                              or []):
                loss = loss + HeatmapHead.pairwise_ranking_loss(
                    outputs["heatmap"], order_labels, present)
        loss = loss + _aux_losses(cfg, outputs, batch, order_labels, metrics)
    else:
        raise ValueError(v)
    metrics["loss"] = loss
    return loss, metrics


def _aux_losses(cfg, outputs, batch, order_labels, metrics):
    """The `hl_include_objectives` auxiliary losses, each a mean over the
    whole batch as in the JAX package: head, the CE of the first step
    (labels[:, 0]); binary / pairwise, the 2-way CE of which step of each
    i < j pair comes first; itm, 0.1 x the CE of the swap targets (when
    the batch has them); mlm, 0.05 x the masked-LM CE over the labelled
    tokens."""
    objs = cfg.hl_include_objectives or []
    total = 0.0
    if "head" in objs and "head_logits" in outputs:
        ce = global_mean(_ce(outputs["head_logits"], order_labels[:, 0]))
        metrics["aux_head"] = ce
        total = total + ce
    if ("binary" in objs or "pairwise" in objs) and "bin_logits" in outputs:
        iu, ju = np.triu_indices(cfg.max_story_length, k=1)
        pos = torch.argsort(order_labels, dim=1)  # node -> chain time
        lbl = (pos[:, iu] < pos[:, ju]).long()
        ce = global_mean(_ce(outputs["bin_logits"], lbl))
        metrics["aux_binary"] = ce
        total = total + ce
    if "itm" in objs and "itm_logits" in outputs and "itm_targets" in batch:
        ce = 0.1 * global_mean(_ce(outputs["itm_logits"],
                                   batch["itm_targets"]))
        metrics["aux_itm"] = ce
        total = total + ce
    if "mlm" in objs and "mlm_logits" in outputs and "mlm_labels" in batch:
        labels = batch["mlm_labels"].long()
        vmask = labels != cfg.mlm_ignore_index
        safe = torch.where(vmask, labels, torch.zeros_like(labels))
        ce = -torch.log_softmax(outputs["mlm_logits"].float(), -1).gather(
            2, safe[:, :, None])[..., 0]
        mlm = (torch.where(vmask, ce, torch.zeros_like(ce)).sum()
               / torch.clamp(global_count(vmask.sum()), min=1))
        metrics["aux_mlm"] = 0.05 * mlm
        total = total + 0.05 * mlm
    return total


def device_batch(batch: dict, device) -> Dict[str, torch.Tensor]:
    """The array entries of a collated numpy batch as tensors on `device`
    (ids and labels as int64, `valid` as bool, `images` in their own
    dtype: uint8 or f32, `img_regional_features` as f32); in a
    data-parallel step this rank's rows of them."""
    out = {}
    for k, val in batch_slice(batch, step_layout()).items():
        if k in _HOST_KEYS or not isinstance(val, np.ndarray):
            continue
        t = torch.from_numpy(val)
        if k == "images":
            out[k] = t.to(device)
        elif k == "img_regional_features":
            out[k] = t.to(device, torch.float32)
        else:
            out[k] = t.to(device, torch.bool if k == "valid" else torch.long)
    return out


def global_norm(tensors, replicas=None) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, accumulated in f64 and
    returned in f32 (an f32 sum over the 51M-entry embedding gradient on
    the CPU drifts by ~1e-4 relative). With `replicas` (on how many ranks
    each tensor's elements live) the tensors are this rank's parts of a
    parallelized model's gradient: the squares are summed over every rank,
    each element once."""
    norms = torch.stack(torch._foreach_norm(tensors, dtype=torch.float64))
    if replicas is None:
        return torch.linalg.vector_norm(norms).float()
    sq = (norms * norms / torch.tensor(replicas, dtype=torch.float64,
                                       device=norms.device)).sum()
    dist.all_reduce(sq)
    return sq.sqrt().float()


def train_step(model, optimizer, batch: dict, step: int, seed: int
               ) -> Dict[str, torch.Tensor]:
    """One train step on `batch` (a collated numpy batch, with the loop's
    `mlm_labels` and `itm_targets` when the auxiliary objectives are on);
    returns the loss, the gradient's global norm and `compute_loss`'s
    metrics as tensors on the model's device (no host sync). `step` is the
    micro-step count the dropout derives from."""
    device = next(model.parameters()).device
    par, fwd = _parallel(model)
    with data_parallel(None if par is None else par.layout):
        db = device_batch(batch, device)
        model.train()
        outputs = fwd(
            db["input_ids"], db.get("attention_mask"),
            db.get("token_type_ids"), images=db.get("images"),
            deterministic=False, rng=DropoutRng(seed + 1, step, device),
            order_labels=db["labels"] if model.cfg.hierarchical_version
            in ORDER_LABELLED else None,
            **({"img_regional_features": db["img_regional_features"]}
               if "img_regional_features" in db else {}))
        loss, metrics = compute_loss(model.cfg, outputs, db)
        out = _update(optimizer, loss, par)
        return _summed({**{k: m.detach() for k, m in metrics.items()},
                        **out})


def berson_train_step(model, optimizer, batch: dict, step: int, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """One train step of `BersonOrdering` on `batch` (a collated numpy batch
    of `BersonDataset`, with the time-contrastive plan's `tc_*` entries when
    that objective is on): its loss as the model returns it, then the same
    clipping and AdamW update as `train_step`, with the same dropout
    streams; a multimodal inner's BatchNorm statistics update once."""
    device = next(model.parameters()).device
    par, fwd = _parallel(model)
    with data_parallel(None if par is None else par.layout):
        model.train()
        out = fwd(device_batch(batch, device), deterministic=False,
                  rng=DropoutRng(seed + 1, step, device))
        return _summed(_update(optimizer, out["loss"], par))


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
    par, fwd = _parallel(model)
    with data_parallel(None if par is None else par.layout):
        model.train()
        losses = fwd(device_batch(batch, device), objective,
                     device_batch(aux, device), deterministic=False,
                     rng=DropoutRng(seed + 1, step, device), use_mlm=use_mlm)
        out = _update(optimizer, losses["loss"], par)
        return _summed({**{k: v.detach() for k, v in losses.items()},
                        **out})


def _parallel(model):
    """(the model's `Parallel` record or None, the module a step calls)."""
    par = parallel_of(model)
    return par, (model if par is None else par.train_module)


def _update(optimizer, loss: torch.Tensor, par=None
            ) -> Dict[str, torch.Tensor]:
    optimizer.zero_grad()
    if par is not None and par.n_data > 1:
        # DDP and FSDP2 average the ranks' gradients; the ranks' terms sum
        (loss * par.n_data).backward()
    else:
        loss.backward()
    if par is not None:
        par.finish_grads()
    grad_norm = optimizer.step(optimizer.grads())
    return {"loss": loss.detach(), "grad_norm": grad_norm}


def _summed(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's loss terms and metrics summed over the data group (the
    gradient norm is already global)."""
    lay = step_layout()
    if lay is None:
        return out
    keys = [k for k in out if k != "grad_norm"]
    vals = torch.stack([out[k].float().reshape(()) for k in keys])
    dist.all_reduce(vals, group=lay.data_group)
    return {**out, **dict(zip(keys, vals.unbind()))}
