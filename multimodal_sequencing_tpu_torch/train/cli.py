"""Eval entry point (counterpart of `train/cli.py`: the eval parser,
`build_config` and `main_eval`, for `--sort_method heat_map`).

  python -m multimodal_sequencing_tpu_torch.trainers.eval \\
      --model_name_or_path simple --model_size large \\
      --replace_token_type_embeddings --task_name wikihow_sort \\
      --sort_method heat_map --hierarchical_version v1 \\
      --data_dir <dir> --max_seq_length 320 --per_seq_max_length 60 \\
      --per_gpu_eval_batch_size 8 --output_dir <dir> [--device cuda]

The flags keep the JAX package's names and defaults. `--device` (default
`cuda`) picks the device; without a card the run fails unless `--device cpu`
is given. With no checkpoint the model is a fresh init seeded from
`--seed`; `--model_name_or_path_1 <dir>` loads the port's own checkpoint
format, `config.json` + `model.pt` (`save_model`).
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
from typing import Optional

import torch

from .. import resolve_device
from .evaluation import SORT_METHODS

logger = logging.getLogger(__name__)

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "model.pt"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    add = p.add_argument

    # --- model / data --------------------------------------------------------
    add("--model_name_or_path", type=str, default="simple")
    add("--model_name_or_path_1", type=str, default=None)
    add("--tokenizer_name", type=str, default="")
    add("--model_size", type=str, default="large",
        choices=["tiny", "base", "large"])
    add("--data_dir", type=str, default=None)
    add("--data_name", type=str, default="wikihow")
    add("--task_name", type=str, default=None)
    add("--task_type", type=str, default=None)
    add("--eval_splits", type=str, nargs="+", default=["test"])
    add("--data_splits", type=str, nargs="+", default=None)
    add("--max_story_length", type=int, default=5)
    add("--min_story_length", type=int, default=5)
    add("--max_seq_length", type=int, default=300)
    add("--per_seq_max_length", type=int, default=60)
    add("--replace_token_type_embeddings", action="store_true")

    # --- heads / decoding ----------------------------------------------------
    add("--hierarchical_version", type=str, default="v0",
        choices=["v0", "v1", "v2", "v3", "p0", "p1"])
    add("--heatmap_decode_method", type=str, default="naive_v2_sum",
        choices=["super_naive", "naive", "naive_v2", "naive_v2_sum",
                 "naive_sum", "naive_v3", "mst", "topological"])
    add("--heatmap_decode_beam_size", type=int, default=2)

    # --- loop ----------------------------------------------------------------
    add("--per_gpu_eval_batch_size", type=int, default=8)
    add("--max_eval_steps", type=int, default=None)
    add("--seed", type=int, default=42)
    add("--output_dir", type=str, default="outputs/run")
    add("--output_root", type=str, default=None)
    add("--metrics", type=str, nargs="+", default=None)
    add("--multiref_metrics", type=str, default="max")
    add("--gelu_approximate", action="store_true")
    add("--gelu_impl", type=str, default="logit_erf",
        choices=["erf", "fast_erf", "logit_erf", "tanh"],
        help="the erf forms all run as exact erf GELU in the port")
    add("--sort_method", type=str, default="topological",
        choices=SORT_METHODS)
    add("--eval_on_every_iter", type=int, default=None)
    add("--device", type=str, default="cuda",
        help="device to run on: cuda (default) or cpu")
    return p


def resolve_output_dir(args) -> str:
    if args.output_root:
        return os.path.join(args.output_root, args.output_dir)
    return args.output_dir


def build_config(args):
    """argparse namespace -> (MultimodalConfig, tokenizer)."""
    from ..models.config import EncoderConfig, MultimodalConfig
    from ..data.tokenization import load_tokenizer

    tokenizer = load_tokenizer(args.tokenizer_name or args.model_name_or_path)
    vocab = len(tokenizer)
    if args.model_size == "tiny":
        enc = EncoderConfig.tiny(vocab_size=vocab)
    elif args.model_size == "base":
        enc = EncoderConfig.roberta_base(vocab_size=vocab)
    else:
        enc = EncoderConfig.roberta_large(vocab_size=vocab)
    if args.replace_token_type_embeddings:
        enc.type_vocab_size = args.max_story_length
    if args.gelu_approximate:
        enc.gelu_approximate = True
    enc.gelu_impl = args.gelu_impl
    cfg = MultimodalConfig(
        encoder=enc,
        max_story_length=args.max_story_length,
        min_story_length=args.min_story_length,
        max_seq_length=args.max_seq_length,
        per_seq_max_length=args.per_seq_max_length,
        cls_id=tokenizer.cls_token_id,
        pad_id=tokenizer.pad_token_id,
        mask_id=getattr(tokenizer, "mask_token_id", None) or 4,
        hierarchical_version=args.hierarchical_version,
        heatmap_decode_method=args.heatmap_decode_method,
        heatmap_decode_beam_size=args.heatmap_decode_beam_size,
    )
    return cfg, tokenizer


def _data_name(args) -> str:
    """The data name of `--task_name {data}_{task}`; the sort evaluation
    reads the sort examples whatever the task type."""
    task_name = args.task_name or f"{args.data_name}_{args.task_type}"
    return task_name.partition("_")[0]


def _split_version(split: str):
    """'train-acl22' -> (split='train', version_text='acl22')."""
    if "-" in split:
        base, version = split.split("-", 1)
        return base, version
    return split, None


def load_examples(args, data_name, split):
    from ..data.registry import get_processor
    base_split, version = _split_version(split)
    proc = get_processor(
        f"{data_name}_sort", data_dir=args.data_dir,
        min_story_length=args.min_story_length,
        max_story_length=args.max_story_length, version_text=version)
    if base_split == "train":
        return proc.get_train_examples()
    if base_split in ("dev", "val"):
        return proc.get_dev_examples()
    return proc.get_test_examples()


def main_eval(argv=None):
    """Parse the flags, evaluate every split; returns {split: metrics}."""
    return run_eval(argv)[0]


def run_eval(argv=None):
    """The body of `main_eval`; also returns the `SortEvaluator`, whose
    counts and per-batch times a caller may read."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    args.output_dir = resolve_output_dir(args)
    cfg, tokenizer = build_config(args)
    data_name = _data_name(args)
    if args.sort_method != "heat_map":
        raise NotImplementedError(
            f"--sort_method {args.sort_method}: the port evaluates heat_map "
            f"so far; the other methods come with later slices")
    from ..data.packing import StoryPacker
    from .evaluation import SortEvaluator

    packer = StoryPacker(tokenizer, args.max_seq_length,
                         args.per_seq_max_length)
    evaluator = SortEvaluator(cfg, packer, device,
                              micro_batch=args.per_gpu_eval_batch_size * 4)
    path = args.model_name_or_path_1 or args.model_name_or_path
    models = {"heatmap": load_model_for_eval(cfg, args, path, device)}
    results = _eval_splits(args, tokenizer, data_name, evaluator, models)
    return results, evaluator


def _eval_splits(args, tokenizer, data_name, evaluator, models):
    from ..data.datasets import SortDataset, data_loader
    results = {}
    for split in args.data_splits or args.eval_splits:
        examples = load_examples(args, data_name, split)
        ds = SortDataset(examples, tokenizer, max_length=args.max_seq_length,
                         per_seq_max_length=args.per_seq_max_length,
                         max_story_length=args.max_story_length,
                         seed=args.seed)
        loader = data_loader(ds, args.per_gpu_eval_batch_size)
        res = evaluator.evaluate(
            loader, args.sort_method, models,
            metrics=args.metrics, output_dir=args.output_dir,
            data_split=split, max_batches=args.max_eval_steps, args_ns=args,
            every_n=args.eval_on_every_iter)
        results[split] = res
        logger.info("split %s: %s", split, res)
    return results


def load_model_for_eval(cfg, args, path: Optional[str], device):
    """The heat-map model on `device` in the config's compute dtype: the
    checkpoint at `path` when it is a directory, else a fresh init seeded
    from `--seed`."""
    from ..models.config import MultimodalConfig
    from ..models.sequencer import HEATMAP_VERSIONS, SequencingModel, init_weights

    role_cfg = copy.deepcopy(cfg)
    if role_cfg.hierarchical_version not in HEATMAP_VERSIONS:
        role_cfg.hierarchical_version = "v1"
    if path and os.path.isdir(path):
        with open(os.path.join(path, CONFIG_NAME)) as f:
            saved = MultimodalConfig.from_json(f.read())
        role_cfg.encoder = saved.encoder
        role_cfg.hierarchical_version = saved.hierarchical_version
        model = SequencingModel(role_cfg)
        state = torch.load(os.path.join(path, WEIGHTS_NAME),
                           map_location="cpu", weights_only=True)
        model.load_state_dict(state)
    else:
        model = init_weights(SequencingModel(role_cfg), args.seed,
                             role_cfg.encoder.initializer_range)
    model = model.to(device=device, dtype=role_cfg.encoder.compute_dtype)
    return model.eval()


def save_model(model, cfg, path: str) -> None:
    """Write the port's checkpoint format: `config.json` + `model.pt`."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG_NAME), "w") as f:
        f.write(cfg.to_json())
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, WEIGHTS_NAME))
