"""Fine-tuning loops on one device (counterpart of `train/loop.py::
run_finetune` and `MetricWriter`, and of the JAX CLI's
`_run_berson_training`).

The step count and epochs, the shuffled per-epoch loader, the scalar log
(`logs/scalars.jsonl`, plus TensorBoard when it imports), periodic and final
`checkpoint-{step}` folders, resume from the latest checkpoint unless
`--overwrite_output_dir`, and `--evaluate_during_training` with the best
checkpoint (`checkpoint-best`) kept on partial + exact match, as the JAX
loop does. One eager `train_step` per batch; the host prepares the next
batches on a thread meanwhile. The mlm/itm host surgery of the auxiliary
objectives comes with those heads.

`run_berson_training` is the BERSON wrapper's loop, as the JAX package runs
it on one device: the same steps and epochs but for fractional
`--num_train_epochs`, no resume, the time-contrastive plan drawn on the
host from `default_rng(seed + 11)` for each batch, `berson_train_step`,
and the beam-search eval at each save with the best checkpoint.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import data_loader, prefetch
from ..models.convert import load_pretrained_weights
from ..models.sequencer import init_weights
from .checkpoint import (find_checkpoints, parse_step_from_name,
                         restore_checkpoint, save_checkpoint)
from .objectives import plan_objective
from .state import AdamW
from .steps import berson_train_step, train_step

logger = logging.getLogger(__name__)


class MetricWriter:
    """Scalar logger: JSONL always; TensorBoard if available."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except ImportError:  # tensorboard is optional
            pass

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@dataclass
class TrainResult:
    """What `run_finetune` leaves: the trained model and optimizer, the
    final global step, and one record per logged step (step, loss,
    grad_norm, host time after the step's loss reached the host)."""
    model: torch.nn.Module
    optimizer: object
    global_step: int
    start_time: float
    history: List[Dict] = field(default_factory=list)
    eval_results: Dict = field(default_factory=dict)


def run_finetune(cfg, model, train_dataset, args, device,
                 eval_fn: Optional[Callable] = None,
                 tokenizer=None) -> TrainResult:
    """Fresh init from `args.seed`, the HF text weights of a
    `--model_name_or_path` directory (`models/convert.py`), optional
    resume, then the step loop.

    args needs: per_gpu_train_batch_size, learning_rate, weight_decay,
    adam_epsilon, max_grad_norm, num_train_epochs, max_steps, warmup_steps,
    gradient_accumulation_steps, logging_steps, save_steps, seed,
    output_dir, overwrite_output_dir, do_not_load_optimizer.
    `eval_fn(model)` runs at each save (the CLI passes it with
    `--evaluate_during_training`). `tokenizer`, when given, is saved into
    every checkpoint."""
    steps_per_epoch = max(1, len(train_dataset)
                          // args.per_gpu_train_batch_size)
    if args.max_steps > 0:
        total_steps = args.max_steps
        epochs = max(1, total_steps // steps_per_epoch + 1)
    else:
        epochs = int(args.num_train_epochs)
        total_steps = steps_per_epoch * epochs

    model, optimizer = _model_and_optimizer(model, args, device, total_steps)

    start_step = 0
    if not args.overwrite_output_dir:
        ckpts = [c for c in find_checkpoints(args.output_dir)
                 if parse_step_from_name(c) > 0]
        if ckpts:
            latest = max(ckpts, key=parse_step_from_name)
            # --do_not_load_optimizer: weights only, fresh optimizer state
            # and global step 0
            load_opt = not args.do_not_load_optimizer
            step = restore_checkpoint(latest, model,
                                      optimizer if load_opt else None)
            start_step = step if load_opt else 0
            logger.info("resumed from %s at step %d (optimizer %s)", latest,
                        start_step, "loaded" if load_opt else "reset")

    return _train_loop(cfg, model, optimizer, train_dataset, args, epochs,
                       total_steps, train_step, eval_fn=eval_fn,
                       tokenizer=tokenizer, start_step=start_step)


def run_berson_training(cfg, model, train_dataset, args, device,
                        eval_fn: Optional[Callable] = None,
                        tokenizer=None) -> TrainResult:
    """Train `BersonOrdering` on a `BersonDataset`: fresh init from
    `args.seed`, the HF text weights of a `--model_name_or_path` directory
    into its `inner` encoder, then the step loop. `eval_fn(model)` (the
    beam-search eval) runs at each save, and the best partial + exact
    match is kept as `checkpoint-best`. args as `run_finetune`'s, plus
    additional_wrapper_level_objectives."""
    steps_per_epoch = max(1, len(train_dataset)
                          // args.per_gpu_train_batch_size)
    if args.max_steps > 0:
        total_steps = args.max_steps
        epochs = total_steps // steps_per_epoch + 1
    else:  # a fractional --num_train_epochs counts
        epochs = max(1, int(args.num_train_epochs))
        total_steps = int(steps_per_epoch * args.num_train_epochs)
    model, optimizer = _model_and_optimizer(model, args, device, total_steps)
    prepare = None
    if "time_contrastive" in (args.additional_wrapper_level_objectives
                              or []):
        tc_rng = np.random.default_rng(args.seed + 11)

        def prepare(batch):
            _, tc = plan_objective("time_contrastive",
                                   {"input_ids": batch["input_ids"][:, 0]},
                                   cfg, tc_rng)
            batch.update(tc_anchor=tc["anchor_idx"],
                         tc_positive=tc["positive_idx"],
                         tc_negative=tc["negative_idx"])

    return _train_loop(cfg, model, optimizer, train_dataset, args, epochs,
                       total_steps, berson_train_step, eval_fn=eval_fn,
                       tokenizer=tokenizer, prepare=prepare)


def _train_loop(cfg, model, optimizer, train_dataset, args, epochs: int,
                total_steps: int, step_fn: Callable,
                eval_fn: Optional[Callable] = None, tokenizer=None,
                start_step: int = 0,
                prepare: Optional[Callable] = None) -> TrainResult:
    """The step loop of both trainers: `epochs` shuffled passes, cut at
    `total_steps`; `prepare(batch)` on the host, then `step_fn(model,
    optimizer, batch, step, seed)`; logging, saves (with `eval_fn` and the
    best checkpoint) and the final save."""
    writer = MetricWriter(os.path.join(args.output_dir, "logs"))
    result = TrainResult(model, optimizer, start_step, time.perf_counter())
    best_score = float("-inf")
    global_step = start_step
    for epoch in range(epochs):
        for batch in prefetch(data_loader(train_dataset,
                                          args.per_gpu_train_batch_size,
                                          shuffle=True, seed=args.seed,
                                          epoch=epoch)):
            if prepare is not None:
                prepare(batch)
            out = step_fn(model, optimizer, batch, global_step, args.seed)
            global_step += 1
            if global_step % args.logging_steps == 0:
                _log_step(writer, result, out, global_step, start_step)
            if args.save_steps and global_step % args.save_steps == 0:
                best_score = _save_and_eval(
                    args, cfg, model, optimizer, global_step, tokenizer,
                    writer, eval_fn, best_score)
            if global_step >= total_steps:
                break
        if global_step >= total_steps:
            break
    save_checkpoint(args.output_dir, global_step, model, optimizer, cfg,
                    vars(args), tokenizer=tokenizer)
    writer.close()
    result.global_step = global_step
    return result


def _model_and_optimizer(model, args, device, total_steps: int):
    """The model's fresh init from `args.seed` and pretrained weights, on
    `device`, and its AdamW."""
    model = init_weights(model, args.seed)
    load_pretrained_weights(model, args)
    model = model.to(device)
    optimizer = AdamW(
        model, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=total_steps,
        weight_decay=args.weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        grad_accum_steps=args.gradient_accumulation_steps)
    return model, optimizer


def _log_step(writer, result: TrainResult, out: Dict, global_step: int,
              start_step: int) -> None:
    """Loss, gradient norm and steps/s of a logged step (the host waits for
    the step's loss here)."""
    loss, gn = float(out["loss"]), float(out["grad_norm"])
    now = time.perf_counter()
    writer.scalar("train/loss", loss, global_step)
    writer.scalar("train/grad_norm", gn, global_step)
    writer.scalar("train/steps_per_sec", (global_step - start_step)
                  / (now - result.start_time), global_step)
    result.history.append({"step": global_step, "loss": loss,
                           "grad_norm": gn, "time": now})
    logger.info("step %d loss %.4f", global_step, loss)


def _save_and_eval(args, cfg, model, optimizer, step: int, tokenizer, writer,
                   eval_fn: Optional[Callable], best_score: float) -> float:
    """`checkpoint-{step}`, then `eval_fn(model)` when given, and
    `checkpoint-best` when its partial + exact match beats `best_score`;
    returns the best score."""
    save_checkpoint(args.output_dir, step, model, optimizer, cfg, vars(args),
                    tokenizer=tokenizer)
    if eval_fn is None:
        return best_score
    res = eval_fn(model)
    for k, v in res.items():
        writer.scalar(f"eval/{k}", v, step)
    logger.info("eval @%d: %s", step, res)
    score = res.get("partial_match", 0) + res.get("exact_match", 0)
    if score > best_score:
        save_checkpoint(args.output_dir, step, model, optimizer, cfg,
                        vars(args), name="best", tokenizer=tokenizer)
        return score
    return best_score
