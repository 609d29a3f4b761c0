"""Training loops on one device (counterpart of `train/loop.py::
run_finetune`, `run_pretraining`, `evaluate_pretraining` and
`MetricWriter`, and of the JAX CLI's `_run_berson_training`).

The step count and epochs, the shuffled per-epoch loader, the scalar log
(`logs/scalars.jsonl`, plus TensorBoard when it imports), periodic and final
`checkpoint-{step}` folders, resume from the latest checkpoint unless
`--overwrite_output_dir`, and `--evaluate_during_training` with the best
checkpoint (`checkpoint-best`) kept on partial + exact match, as the JAX
loop does. One eager `train_step` per batch; the host prepares the next
batches on a thread meanwhile. With the auxiliary objectives `mlm` or
`mlm_wo_loss` the host masks each batch (`mask_tokens_sentence`, which
adds `mlm_labels`), then with `itm` and step images swaps one story's
image (`plan_itm_swap`, which adds `itm_targets`), both from one
`default_rng(seed + 7)` in batch order, as the JAX loop draws them.

`run_berson_training` is the BERSON wrapper's loop, as the JAX package runs
it on one device: the same steps and epochs but for fractional
`--num_train_epochs`, no resume, the time-contrastive plan drawn on the
host from `default_rng(seed + 11)` for each batch, `berson_train_step`,
and the beam-search eval at each save with the best checkpoint.

`run_pretraining` drives the same loop with the pretraining step: the host
masks each batch and plans one objective for it (`prepare`), and the dev
MLM evaluation (`evaluate_pretraining`) runs at each save.

Each loop takes its rank layout (`parallel/mesh.py::Layout`, one process
by default): the global batch is `per_gpu_train_batch_size` x n_data, as
the JAX loops compute it, and the steps per epoch follow from it. Every
rank loads the same global batches and draws the same host plans (MLM
masks, `plan_itm_swap`, the objective plans, BERSON's time-contrastive
plan) before the step takes its rows; the model is sharded by
`parallel/sharding_rules.py::parallelize` (`--model_parallel_size`,
`--sequence_parallel`, `--fsdp`), or with `--pipeline_parallel_size` the
fine-tune and BERSON steps are pipelined (`parallel/pipeline.py`: the
model dim holds the stages, `--fsdp` shards over the data dim alone).
Pretraining is data-parallel only, as in the JAX package. Checkpoints gather whole tensors on every rank and rank 0
writes them; the evals run on every rank (their forwards are collective
under tensor parallelism and FSDP) and rank 0 writes their files and the
logs. `--profile_dir` traces steps 2-4 of the loop
(`utils/profiling.py::StepTraceWindow`).
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
from ..models.pretrainer import resolve_objectives
from ..parallel.mesh import Layout, is_rank0, model_ring
from ..parallel.pipeline import (make_berson_pipeline_train_step,
                                 make_pipeline_train_step)
from ..parallel.sharding_rules import gathered, parallelize
from ..utils.profiling import StepTraceWindow
from .checkpoint import (find_checkpoints, parse_step_from_name,
                         restore_checkpoint, save_checkpoint)
from .mlm import mask_tokens_sentence
from .objectives import choose_objective, plan_itm_swap, plan_objective
from .state import AdamW
from .steps import berson_train_step, device_batch, pretrain_step, train_step

logger = logging.getLogger(__name__)


class MetricWriter:
    """Scalar logger: JSONL always; TensorBoard if available. Off on every
    rank but rank 0."""

    def __init__(self, log_dir: str):
        self._f = self._tb = None
        if not is_rank0():
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except ImportError:  # tensorboard is optional
            pass

    def scalar(self, tag: str, value: float, step: int):
        if self._f is None:
            return
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        if self._f is not None:
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
                 tokenizer=None, layout: Optional[Layout] = None
                 ) -> TrainResult:
    """Fresh init from `args.seed`, the HF text weights of a
    `--model_name_or_path` directory (`models/convert.py`), optional
    resume, then the step loop.

    args needs: per_gpu_train_batch_size, learning_rate, weight_decay,
    adam_epsilon, max_grad_norm, num_train_epochs, max_steps, warmup_steps,
    gradient_accumulation_steps, logging_steps, save_steps, seed,
    output_dir, overwrite_output_dir, do_not_load_optimizer.
    `eval_fn(model)` runs at each save (the CLI passes it with
    `--evaluate_during_training`). `tokenizer`, when given, is saved into
    every checkpoint. `layout`: the ranks' mesh (one process by default)."""
    layout = layout or Layout()
    steps_per_epoch = max(1, len(train_dataset) // _global_batch(args, layout))
    if args.max_steps > 0:
        total_steps = args.max_steps
        epochs = max(1, total_steps // steps_per_epoch + 1)
    else:
        epochs = int(args.num_train_epochs)
        total_steps = steps_per_epoch * epochs

    step_fn = train_step
    pp = max(1, getattr(args, "pipeline_parallel_size", 1))
    if pp > 1:
        step_fn, _ = make_pipeline_train_step(
            cfg, model_ring(layout), pp,
            max(1, getattr(args, "pipeline_microbatches", 2)))
    model, optimizer = _model_and_optimizer(model, args, device, total_steps,
                                            layout, pipeline=pp > 1)

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
                       total_steps, step_fn, eval_fn=eval_fn,
                       tokenizer=tokenizer, start_step=start_step,
                       prepare=aux_surgery(cfg, args.seed), layout=layout)


def aux_surgery(cfg, seed: int) -> Optional[Callable]:
    """The host side of the auxiliary objectives, a `prepare` of the step
    loop (None when no objective needs one): for `mlm` and `mlm_wo_loss`,
    the batch's `input_ids` masked at `cfg.mlm_probability` and its
    `mlm_labels`; then for `itm`, when the batch has step images, the
    swapped `images` and their `itm_targets`. The draws come from one
    `default_rng(seed + 7)`, in the JAX loop's order."""
    objs = set(cfg.hl_include_objectives or [])
    mlm, itm = bool(objs & {"mlm", "mlm_wo_loss"}), "itm" in objs
    if not (mlm or itm):
        return None
    rng = np.random.default_rng(seed + 7)

    def prepare(batch):
        if mlm:
            batch["input_ids"], batch["mlm_labels"] = mask_tokens_sentence(
                np.asarray(batch["input_ids"]),
                mlm_probability=cfg.mlm_probability, pad_id=cfg.pad_id,
                cls_id=cfg.cls_id, mask_id=cfg.mask_id,
                vocab_size=cfg.encoder.vocab_size,
                ignore_index=cfg.mlm_ignore_index, rng=rng)
        if itm and "images" in batch:
            batch["images"], batch["itm_targets"] = plan_itm_swap(
                np.asarray(batch["images"]), rng)
        return batch

    return prepare


def run_berson_training(cfg, model, train_dataset, args, device,
                        eval_fn: Optional[Callable] = None,
                        tokenizer=None, layout: Optional[Layout] = None
                        ) -> TrainResult:
    """Train `BersonOrdering` on a `BersonDataset`: fresh init from
    `args.seed`, the HF text weights of a `--model_name_or_path` directory
    into its `inner` encoder, then the step loop. `eval_fn(model)` (the
    beam-search eval) runs at each save, and the best partial + exact
    match is kept as `checkpoint-best`. args as `run_finetune`'s, plus
    additional_wrapper_level_objectives. The rows of a BERSON batch are
    stories (each with its pairs), so a rank's slice holds whole stories,
    as JAX's `shard_batch` splits the collated leading axis."""
    layout = layout or Layout()
    steps_per_epoch = max(1, len(train_dataset) // _global_batch(args, layout))
    if args.max_steps > 0:
        total_steps = args.max_steps
        epochs = total_steps // steps_per_epoch + 1
    else:  # a fractional --num_train_epochs counts
        epochs = max(1, int(args.num_train_epochs))
        total_steps = int(steps_per_epoch * args.num_train_epochs)
    step_fn = berson_train_step
    pp = max(1, getattr(args, "pipeline_parallel_size", 1))
    if pp > 1:
        step_fn = make_berson_pipeline_train_step(
            cfg, model_ring(layout), pp,
            max(1, getattr(args, "pipeline_microbatches", 1) or pp))
    model, optimizer = _model_and_optimizer(model, args, device, total_steps,
                                            layout, pipeline=pp > 1)
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
            return batch

    return _train_loop(cfg, model, optimizer, train_dataset, args, epochs,
                       total_steps, step_fn, eval_fn=eval_fn,
                       tokenizer=tokenizer, prepare=prepare, layout=layout)


def run_pretraining(cfg, model, train_dataset, args, device, tokenizer=None,
                    dev_dataset=None, layout: Optional[Layout] = None
                    ) -> TrainResult:
    """Pretrain `SequencingPretrainer` on a `PretrainDataset`: fresh init
    from `args.seed` and the pretrained weights of the flags, then the step
    loop, each batch masked on the host and planned for one objective drawn
    uniformly from `cfg.multimodal_pretrain_objectives`
    (`resolve_objectives`). The host draws come from one
    `default_rng(args.seed)`, in the JAX package's order: first the plan of
    every objective on the first (unshuffled) batch, which its init traces,
    then for each step `choose_objective`, `mask_tokens_sentence` and
    `plan_objective`; so one seed gives the same objectives and plans.
    `pretrain/{name}` scalars at the logging steps; at each save with
    `--evaluate_during_training` and a `dev_dataset`, `evaluate_pretraining`
    (no best checkpoint, no resume, as in the JAX package). args as
    `run_finetune`'s, plus mlm_probability, evaluate_during_training,
    per_gpu_eval_batch_size and max_eval_steps. `layout`: data-parallel
    only (n_model 1), as the JAX package pretrains."""
    layout = layout or Layout()
    if layout.n_model > 1:
        raise ValueError("pretraining is data-parallel only: its layout "
                         "must have one model rank")
    batch_size = _global_batch(args, layout)
    steps_per_epoch = max(1, len(train_dataset) // batch_size)
    if args.max_steps > 0:
        total_steps = args.max_steps
        epochs = total_steps // steps_per_epoch + 1
    else:
        # below one epoch, total_steps is 0 and the one epoch run still
        # takes its first step (at learning rate 0), as the JAX loop does
        epochs = int(args.num_train_epochs)
        total_steps = steps_per_epoch * epochs
        epochs = max(1, epochs)
    objectives, use_mlm = resolve_objectives(
        cfg.multimodal_pretrain_objectives)
    if "visual_mlm" in (cfg.multimodal_pretrain_objectives or []):
        logger.warning(
            "--multimodal_pretrain_objectives visual_mlm is a dead flag in "
            "the reference (config-only, never read by any model); it is "
            "accepted but has no effect here either")
    model, optimizer = _model_and_optimizer(model, args, device, total_steps,
                                            layout)
    host_rng = np.random.default_rng(args.seed)

    def plan(batch, objective):
        nb = {k: np.asarray(batch[k]) for k in PRETRAIN_KEYS if k in batch}
        nb["input_ids"], nb["mlm_labels"] = mask_batch(cfg, args, nb,
                                                       host_rng)
        nb, aux = plan_objective(objective, nb, cfg, host_rng)
        return nb, {k: v for k, v in aux.items()
                    if isinstance(v, np.ndarray) and v.ndim > 0}

    # the draws of the JAX package's init, which traces every objective
    sample = next(data_loader(train_dataset, batch_size))
    for objective in objectives:
        plan(sample, objective)

    def prepare(batch):
        objective = choose_objective(objectives, host_rng)
        return (objective, *plan(batch, objective))

    def step_fn(model, optimizer, planned, step, seed):
        objective, nb, aux = planned
        return pretrain_step(model, optimizer, nb, aux, objective, step,
                             seed, use_mlm)

    eval_fn = None
    if args.evaluate_during_training and dev_dataset is not None:
        def eval_fn(m):
            return evaluate_pretraining(
                cfg, m, args, dev_dataset, use_mlm=use_mlm,
                max_eval_steps=args.max_eval_steps)

    return _train_loop(cfg, model, optimizer, train_dataset, args, epochs,
                       total_steps, step_fn, eval_fn=eval_fn,
                       tokenizer=tokenizer, prepare=prepare, tag="pretrain",
                       layout=layout)


# the entries of a collated batch that pretraining reads
PRETRAIN_KEYS = ("input_ids", "attention_mask", "token_type_ids", "images")


def mask_batch(cfg, args, batch, rng):
    return mask_tokens_sentence(
        batch["input_ids"], mlm_probability=args.mlm_probability,
        pad_id=cfg.pad_id, cls_id=cfg.cls_id, mask_id=cfg.mask_id,
        vocab_size=cfg.encoder.vocab_size,
        ignore_index=cfg.mlm_ignore_index, rng=rng)


def evaluate_pretraining(cfg, model, args, dev_dataset, use_mlm: bool = True,
                         seed: int = 0, max_eval_steps=None) -> Dict:
    """Pretraining dev evaluation, as the JAX package's: the `mlm_only`
    objective, deterministic, over `dev_dataset` in batches of
    `per_gpu_eval_batch_size` (else the train batch; the final batch padded
    to it), masked on the host from `default_rng(seed)`; each loss averaged
    over the batches as `eval_{name}`, and `eval_perplexity` =
    exp(min(eval_mlm, 30)). Empty without a batch."""
    device = next(model.parameters()).device
    batch_size = getattr(args, "per_gpu_eval_batch_size", None) or \
        args.per_gpu_train_batch_size
    host_rng = np.random.default_rng(seed)
    was_training = model.training
    model.eval()
    totals: Dict[str, float] = {}
    n_batches = 0
    for batch in data_loader(dev_dataset, batch_size):
        nb = {k: np.asarray(batch[k]) for k in PRETRAIN_KEYS if k in batch}
        nb["input_ids"], nb["mlm_labels"] = mask_batch(cfg, args, nb,
                                                       host_rng)
        with torch.inference_mode():
            losses = model(device_batch(nb, device), "mlm_only", {},
                           deterministic=True, use_mlm=use_mlm)
        for k, v in losses.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        n_batches += 1
        if max_eval_steps and n_batches >= max_eval_steps:
            break
    model.train(was_training)
    if n_batches == 0:
        return {}
    res = {f"eval_{k}": v / n_batches for k, v in totals.items()}
    if "eval_mlm" in res:
        res["eval_perplexity"] = float(np.exp(min(res["eval_mlm"], 30.0)))
    return res


def _train_loop(cfg, model, optimizer, train_dataset, args, epochs: int,
                total_steps: int, step_fn: Callable,
                eval_fn: Optional[Callable] = None, tokenizer=None,
                start_step: int = 0,
                prepare: Optional[Callable] = None,
                tag: str = "train",
                layout: Optional[Layout] = None) -> TrainResult:
    """The step loop of the trainers: `epochs` shuffled passes of global
    batches, cut at `total_steps`; `batch = prepare(batch)` on the host,
    then `step_fn(model, optimizer, batch, step, seed)`, whose returned
    tensors are logged as `{tag}/{name}`; saves with `eval_fn` (its results
    as `eval/{name}`, or `{tag}/{name}` under another tag, and the best
    checkpoint) and the final save (once: not again after a save at the
    last step); the `--profile_dir` window around steps 2-4."""
    layout = layout or Layout()
    writer = MetricWriter(os.path.join(args.output_dir, "logs"))
    device = next(model.parameters()).device
    tracer = StepTraceWindow(getattr(args, "profile_dir", None),
                             cuda=device.type == "cuda")
    result = TrainResult(model, optimizer, start_step, time.perf_counter())
    best_score = float("-inf")
    global_step = saved_at = start_step
    eval_tag = "eval" if tag == "train" else tag
    for epoch in range(epochs):
        for batch in prefetch(data_loader(train_dataset,
                                          _global_batch(args, layout),
                                          shuffle=True, seed=args.seed,
                                          epoch=epoch)):
            if prepare is not None:
                batch = prepare(batch)
            tracer.before_step(global_step - start_step)
            out = step_fn(model, optimizer, batch, global_step, args.seed)
            if tracer.after_step(global_step - start_step):
                logger.info("profiler trace written to %s", args.profile_dir)
            global_step += 1
            if global_step % args.logging_steps == 0:
                _log_step(writer, result, out, global_step, start_step, tag)
            if args.save_steps and global_step % args.save_steps == 0:
                best_score = _save_and_eval(
                    args, cfg, model, optimizer, global_step, tokenizer,
                    writer, eval_fn, best_score, eval_tag)
                saved_at = global_step
            if global_step >= total_steps:
                break
        if global_step >= total_steps:
            break
    tracer.close()  # the run ended inside the profiling window
    if saved_at != global_step or global_step == start_step:
        # the final save, unless the last step's save wrote this checkpoint
        # (the JAX loop writes it a second time, unchanged)
        save_checkpoint(args.output_dir, global_step, model, optimizer, cfg,
                        vars(args), tokenizer=tokenizer)
    writer.close()
    result.global_step = global_step
    return result


def _global_batch(args, layout: Layout) -> int:
    return args.per_gpu_train_batch_size * layout.n_data


def _model_and_optimizer(model, args, device, total_steps: int,
                         layout: Layout, pipeline: bool = False):
    """The model's fresh init from `args.seed` and pretrained weights, on
    `device`, sharded over `layout` (its model dim pipeline stages with
    `pipeline`), and its AdamW."""
    model = init_weights(model, args.seed)
    load_pretrained_weights(model, args)
    model = parallelize(model.to(device), layout,
                        sequence_parallel=bool(getattr(
                            args, "sequence_parallel", False)),
                        fsdp=bool(getattr(args, "fsdp", False)),
                        pipeline=pipeline)
    optimizer = AdamW(
        model, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=total_steps,
        weight_decay=args.weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        grad_accum_steps=args.gradient_accumulation_steps)
    return model, optimizer


def _log_step(writer, result: TrainResult, out: Dict, global_step: int,
              start_step: int, tag: str = "train") -> None:
    """Each tensor of the step's output (loss, gradient norm, a
    pretraining step's loss terms) and steps/s of a logged step (the host
    waits for the step's loss here)."""
    vals = {k: float(v) for k, v in out.items() if torch.is_tensor(v)}
    now = time.perf_counter()
    for k, v in vals.items():
        writer.scalar(f"{tag}/{k}", v, global_step)
    writer.scalar(f"{tag}/steps_per_sec", (global_step - start_step)
                  / (now - result.start_time), global_step)
    result.history.append({"step": global_step, **vals, "time": now})
    logger.info("step %d loss %.4f", global_step, vals["loss"])


def _save_and_eval(args, cfg, model, optimizer, step: int, tokenizer, writer,
                   eval_fn: Optional[Callable], best_score: float,
                   eval_tag: str = "eval") -> float:
    """`checkpoint-{step}`, then `eval_fn(model)` when given (its results
    logged as `{eval_tag}/{name}`), and `checkpoint-best` when its partial +
    exact match beats `best_score` (an eval without them, such as
    pretraining's, keeps none); returns the best score."""
    save_checkpoint(args.output_dir, step, model, optimizer, cfg, vars(args),
                    tokenizer=tokenizer)
    if eval_fn is None:
        return best_score
    with gathered(model):
        res = eval_fn(model)
    for k, v in res.items():
        writer.scalar(f"{eval_tag}/{k}", v, step)
    logger.info("eval @%d: %s", step, res)
    if not {"partial_match", "exact_match"} & set(res):
        return best_score
    score = res.get("partial_match", 0) + res.get("exact_match", 0)
    if score > best_score:
        save_checkpoint(args.output_dir, step, model, optimizer, cfg,
                        vars(args), name="best", tokenizer=tokenizer)
        return score
    return best_score
