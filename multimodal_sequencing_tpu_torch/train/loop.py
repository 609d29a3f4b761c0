"""Fine-tuning loop on one device (counterpart of `train/loop.py::
run_finetune` and `MetricWriter`).

The step count and epochs, the shuffled per-epoch loader, the scalar log
(`logs/scalars.jsonl`, plus TensorBoard when it imports), periodic and final
`checkpoint-{step}` folders, resume from the latest checkpoint unless
`--overwrite_output_dir`, and `--evaluate_during_training` with the best
checkpoint (`checkpoint-best`) kept on partial + exact match, as the JAX
loop does. One eager `train_step` per batch; the host prepares the next
batches on a thread meanwhile. The mlm/itm host surgery of the auxiliary
objectives comes with those heads.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..data.datasets import data_loader, prefetch
from ..models.convert import load_pretrained_weights
from ..models.sequencer import init_weights
from .checkpoint import (find_checkpoints, parse_step_from_name,
                         restore_checkpoint, save_checkpoint)
from .state import AdamW
from .steps import train_step

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
    output_dir, overwrite_output_dir, do_not_load_optimizer,
    evaluate_during_training. `tokenizer`, when given, is saved into every
    checkpoint."""
    batch_size = args.per_gpu_train_batch_size
    steps_per_epoch = max(1, len(train_dataset) // batch_size)
    if args.max_steps > 0:
        total_steps = args.max_steps
        epochs = max(1, total_steps // steps_per_epoch + 1)
    else:
        epochs = int(args.num_train_epochs)
        total_steps = steps_per_epoch * epochs

    model = init_weights(model, args.seed)
    load_pretrained_weights(model, args)
    model = model.to(device)
    optimizer = AdamW(
        model, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=total_steps,
        weight_decay=args.weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        grad_accum_steps=args.gradient_accumulation_steps)

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

    training_args = vars(args)
    writer = MetricWriter(os.path.join(args.output_dir, "logs"))
    result = TrainResult(model, optimizer, start_step, time.perf_counter())
    best_score = float("-inf")
    global_step = start_step
    for epoch in range(epochs):
        for batch in prefetch(data_loader(train_dataset, batch_size,
                                          shuffle=True, seed=args.seed,
                                          epoch=epoch)):
            out = train_step(model, optimizer, batch, global_step, args.seed)
            global_step += 1
            if global_step % args.logging_steps == 0:
                loss, gn = float(out["loss"]), float(out["grad_norm"])
                now = time.perf_counter()
                writer.scalar("train/loss", loss, global_step)
                writer.scalar("train/grad_norm", gn, global_step)
                writer.scalar("train/steps_per_sec", (global_step - start_step)
                              / (now - result.start_time), global_step)
                result.history.append({"step": global_step, "loss": loss,
                                       "grad_norm": gn, "time": now})
                logger.info("step %d loss %.4f", global_step, loss)
            save_now = args.save_steps and global_step % args.save_steps == 0
            if save_now:
                save_checkpoint(args.output_dir, global_step, model, optimizer,
                                cfg, training_args, tokenizer=tokenizer)
            if save_now and args.evaluate_during_training and eval_fn:
                res = eval_fn(model)
                for k, v in res.items():
                    writer.scalar(f"eval/{k}", v, global_step)
                score = res.get("partial_match", 0) + res.get("exact_match", 0)
                if score > best_score:
                    best_score = score
                    save_checkpoint(args.output_dir, global_step, model,
                                    optimizer, cfg, training_args, name="best",
                                    tokenizer=tokenizer)
            if global_step >= total_steps:
                break
        if global_step >= total_steps:
            break
    save_checkpoint(args.output_dir, global_step, model, optimizer, cfg,
                    training_args, tokenizer=tokenizer)
    writer.close()
    result.global_step = global_step
    return result
