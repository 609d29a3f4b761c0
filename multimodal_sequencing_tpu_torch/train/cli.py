"""CLI flag surface and entry points (counterpart of `train/cli.py`).

  python -m multimodal_sequencing_tpu_torch.trainers.train \\
      --model_name_or_path simple --model_size large \\
      --replace_token_type_embeddings --do_train --task_name wikihow_hl_v1 \\
      --hierarchical_version v1 --data_dir <dir> --max_seq_length 320 \\
      --per_seq_max_length 60 --per_gpu_train_batch_size 8 \\
      --output_dir <dir> [--do_eval] [--device cuda]
  python -m multimodal_sequencing_tpu_torch.trainers.eval \\
      --model_name_or_path <dir>/checkpoint-N --task_name wikihow_sort \\
      --sort_method heat_map ... [--device cuda]

`--wrapper_model_type berson` trains the BERSON ordering wrapper
(`models/berson.py`) over the text encoder or, with `--multimodal`, the
CLIP encoder (`--wrapper_model_with_heatmap`, `--multimodal_loss`,
`--additional_wrapper_level_objectives time_contrastive`, `--beam_size`,
`--pairwise_loss_lam`); its `--evaluate_during_training` and `--do_eval`
run the beam search over `BersonDataset` stories, the sweep writing
`eval_results_split_{split}_{checkpoint}.txt`. `trainers.eval --sort_method
berson` evaluates a BERSON checkpoint (its `config.json` records
`wrapper_model_type`) with the beam width and lambda of the flags.

`build_parser` has every option of the JAX package's parser, with the same
names, types, defaults and choices, plus `--device` (default `cuda`; without
a card the run fails unless `--device cpu` is given). Options of paths the
port does not run yet raise `NotImplementedError` when set.

Training from a local HF model directory (`--model_name_or_path <dir>`, or
`--config_name <dir>`) takes the encoder's shape from its `config.json` and
its weights from its `pytorch_model.bin` (`models/convert.py`). Checkpoints
are the port's own format (`train/checkpoint.py`) and carry the tokenizer,
so a checkpoint serves as `--model_name_or_path` of the eval; the eval
refuses any other directory, an HF one included, as the JAX package's
restore does.

`--multimodal` (with `--multimodal_model_type clip`, the default) trains and
evaluates the CLIP encoder: step images from the data directory, shipped
as uint8 and normalized on the device (`--host_image_preprocess`: f32 from
the host), `--clip_model_name RN50` or `ViT-B/32` (`--model_size tiny`:
the `tiny_rn` / `tiny_vit` towers), `--clip_visual_model_weights` (OpenAI
CLIP weights, or a checkpoint of this package), `--freeze_vision_model`,
`--multimodal_text_part` / `--multimodal_img_part`. A multimodal checkpoint
keeps its tower's config in `vision_config.json`, which the eval reads.

`trainers.run_pretraining` (`main_pretrain`) pretrains MLM and the
sequentiality objectives (`--multimodal_pretrain_objectives`, one drawn a
batch, `--mlm_probability`) over the stories of `--data_dirs` /
`--data_names`, text or CLIP (`--multimodal`, `--multimodal_img_part` for
image-only pretraining); its checkpoint's tower feeds a fine-tune run's
`--clip_visual_model_weights`.

`--hierarchical_version v0` trains the classification head on the
`{data}_pairwise`, `_head`, `_abductive` (`--abd_pred_method`) or
`_pure_class` task of WikiHow or RecipeQA (`num_labels` 2, 2,
`--max_story_length` and N!; `--order_criteria` labels the pairs), and the
eval's baseline sort methods decode with such models: `topological`
(`--model_name_or_path_1`: a pairwise model; `--device_decode` decodes on
the card), `head_and_topological` / `head_and_sequential` (a head model,
then `--model_name_or_path_2` a pairwise one), `head_and_sequential_abductive`
(and `--model_name_or_path_3` an abductive one) and `pure_class`. A role
whose path is not a directory gets a fresh model. RecipeQA reads
`texts/{split}.json` or, for a split `{split}-{version}`,
`new_splits/{split}-{version}.json`; `--caption_transformations` edit the
step texts (`data/caption_transforms.py`).

`--hierarchical_version p0|p1` trains a pointer head on `{data}_hl_v1` or
`_pure_class` stories, and `--task_name {data}_pure_decode` the
pure_decode encoder-decoder (`models/pure_decode.py`; its checkpoint's
`config.json` has `hierarchical_version` "decode");
`--hl_include_objectives` adds the auxiliary objectives (`head`, `binary`
/ `pairwise`, `itm`, `mlm`, `mlm_wo_loss`, and for the heat-map heads
`heatmap_pairwise_ranking`). Their `--do_eval` runs `pure_decode`: the
beam-5 generate of a pure_decode model, or a pointer model's exhaustive
permutation argmax; `trainers.eval --sort_method pure_decode` evaluates a
pure_decode checkpoint, or with `--hierarchical_version p0|p1` a pointer
checkpoint.

Parallel training (`main_train`, its BERSON branch and `main_pretrain`):
under `torchrun` (NCCL, one card a rank) or with `--num_cpu_devices N`
(N gloo ranks on the CPU, spawned by the CLI itself: the counterpart of the
JAX package's virtual CPU mesh), `--model_parallel_size M` lays the ranks
out as (N / M data, M model) with tensor parallelism over the model dim,
`--sequence_parallel` adds its sequence-parallel regions and `--fsdp`
shards the parameters and moments over the data dim
(`parallel/sharding_rules.py`); pretraining is data-parallel only, as in
the JAX package. One run gives the single process's losses, weights and
checkpoints on the same global batch (`--per_gpu_train_batch_size` x the
data ranks). `--profile_dir DIR` writes a torch.profiler Chrome trace of
train steps 2-4 into DIR (`utils/profiling.py`). `--pipeline_parallel_size
P --pipeline_microbatches M` runs the sequencer's text encoder (v0, v1-v3,
p0/p1) or BERSON's text trunk as P GPipe stages over the model dim
(`parallel/pipeline.py`; N / P data ranks, with or without `--fsdp`) in M
microbatches (BERSON: M or P); its checkpoints and evals are the
unpipelined model's. `--no_cuda` is `--device cpu`.

`--eval_all_checkpoints` / `--iters_to_eval` sweep the checkpoints under a
run directory. A fresh eval model is seeded from 0, as
the JAX eval's `PRNGKey(0)`, and a fresh train model from `--seed`.
`--use_cached` keeps the examples of each split in a pickle under the data
directory, named as the JAX package names its cache but ending in
`_torch.pkl`: each package unpickles only its own example classes.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import math
import os
import socket
import sys
import time
from typing import List, Optional

import torch

from .. import resolve_device
from ..models.convert import HF_WEIGHTS_NAMES
from ..parallel.mesh import init_distributed, is_rank0, make_mesh
from ..parallel.sharding_rules import gathered
from ..models.sequencer import HEATMAP_VERSIONS, POINTER_VERSIONS
from .checkpoint import CONFIG_NAME, WEIGHTS_NAME, save_model  # noqa: F401
from .evaluation import SORT_METHODS

logger = logging.getLogger(__name__)


def build_parser(kind: str = "train") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    add = p.add_argument

    # --- model / data --------------------------------------------------------
    add("--model_name_or_path", type=str, default="simple")
    add("--model_name_or_path_1", type=str, default=None)
    add("--model_name_or_path_2", type=str, default=None)
    add("--model_name_or_path_3", type=str, default=None)
    add("--config_name", type=str, default="")
    add("--tokenizer_name", type=str, default="")
    add("--model_size", type=str, default="large",
        choices=["tiny", "base", "large"])
    add("--data_dir", type=str, default=None)
    add("--data_dirs", type=str, nargs="+", default=None)
    add("--data_name", type=str, default="wikihow")
    add("--data_names", type=str, nargs="+", default=None)
    add("--task_name", type=str, default=None)
    add("--task_type", type=str, default=None)
    add("--train_split", type=str, default="train")
    add("--eval_splits", type=str, nargs="+", default=["test"])
    add("--data_splits", type=str, nargs="+", default=None)
    add("--order_criteria", type=str, default="tight",
        choices=["tight", "loose"])
    add("--max_story_length", type=int, default=5)
    add("--min_story_length", type=int, default=5)
    add("--max_seq_length", type=int, default=300)
    add("--per_seq_max_length", type=int, default=60)
    add("--caption_transformations", type=str, nargs="+", default=None)
    add("--paired_with_image", type=str, default="true")
    add("--replace_token_type_embeddings", action="store_true")

    # --- multimodal ----------------------------------------------------------
    add("--multimodal", action="store_true")
    add("--multimodal_model_type", type=str, default="clip",
        choices=["naive", "visualbert", "vilbert", "vlbert", "uniter",
                 "clip"])
    add("--vision_model", type=str, default="resnet50")
    add("--clip_model_name", type=str, default="RN50",
        choices=["RN50", "ViT-B/32"])
    add("--clip_visual_model_weights", type=str, default=None)
    add("--vision_model_checkpoint", type=str, default=None)
    add("--vision_feature_dim", type=int, default=None)
    add("--freeze_vision_model", action="store_true")
    add("--multimodal_text_part", action="store_true")
    add("--multimodal_img_part", action="store_true")
    add("--multimodal_fusion_method", type=str, default="sum",
        choices=["sum", "mul", "text_only", "img_only"])
    add("--multimodal_loss", action="store_true")
    add("--include_num_img_regional_features", type=int, default=None)
    add("--include_full_img_features", action="store_true")
    add("--vision_image_size", type=int, default=None)
    add("--clip_ref_fold_quirk", action="store_true")
    add("--device_image_preprocess", action="store_true", default=True)
    add("--host_image_preprocess", dest="device_image_preprocess",
        action="store_false")

    # --- heads / decoding ----------------------------------------------------
    add("--hierarchical_version", type=str, default="v0",
        choices=["v0", "v1", "v2", "v3", "p0", "p1"])
    add("--heatmap_decode_method", type=str, default="naive_v2_sum",
        choices=["super_naive", "naive", "naive_v2", "naive_v2_sum",
                 "naive_sum", "naive_v3", "mst", "topological"])
    add("--heatmap_decode_beam_size", type=int, default=2)
    add("--device_decode", action="store_true")
    add("--hl_include_objectives", type=str, nargs="+", default=None)
    add("--wrapper_model_type", type=str, default=None)
    add("--wrapper_model_with_heatmap", action="store_true")
    add("--additional_wrapper_level_objectives", type=str, nargs="+",
        default=None)
    add("--beam_size", type=int, default=16)
    add("--pairwise_loss_lam", type=float, default=0.6)

    # --- pretraining ---------------------------------------------------------
    add("--multimodal_pretrain_objectives", type=str, nargs="+",
        default=None)
    add("--mlm_probability", type=float, default=0.15)
    add("--mlm_ignore_index", type=int, default=-100)

    # --- loop ----------------------------------------------------------------
    add("--do_train", action="store_true")
    add("--do_eval", action="store_true")
    add("--evaluate_during_training", action="store_true")
    add("--per_gpu_train_batch_size", type=int, default=8)
    add("--per_gpu_eval_batch_size", type=int, default=8)
    add("--gradient_accumulation_steps", type=int, default=1)
    add("--learning_rate", type=float, default=5e-6)
    add("--weight_decay", type=float, default=0.0)
    add("--adam_epsilon", type=float, default=1e-8)
    add("--max_grad_norm", type=float, default=1.0)
    add("--num_train_epochs", type=float, default=3.0)
    add("--max_steps", type=int, default=-1)
    add("--max_eval_steps", type=int, default=None)
    add("--warmup_steps", type=int, default=0)
    add("--logging_steps", type=int, default=50)
    add("--save_steps", type=int, default=500)
    add("--iters_to_eval", type=str, nargs="+", action="extend",
        default=None)
    add("--eval_all_checkpoints", action="store_true")
    add("--seed", type=int, default=42)
    add("--fp16", action="store_true",
        help="accepted for reference compatibility; the compute dtype is "
             "EncoderConfig.dtype (bfloat16)")
    add("--fp16_opt_level", type=str, default="O1")
    add("--local_rank", type=int, default=-1)
    add("--no_cuda", action="store_true")
    add("--overwrite_output_dir", action="store_true")
    add("--overwrite_cache", action="store_true")
    add("--use_cached", action="store_true")
    add("--do_not_load_optimizer", action="store_true")
    add("--output_dir", type=str, default="outputs/run")
    add("--output_root", type=str, default=None)
    add("--debug", action="store_true")
    add("--metrics", type=str, nargs="+", default=None)
    add("--multiref_metrics", type=str, default="max")
    add("--eval_save_all_results", action="store_true")

    # --- eval-only -----------------------------------------------------------
    add("--gelu_approximate", action="store_true",
        help="tanh-approximate GELU (the same as --gelu_impl tanh)")
    add("--gelu_impl", type=str, default="logit_erf",
        choices=["erf", "fast_erf", "logit_erf", "tanh"],
        help="erf-GELU form (ops/gelu.py): logit_erf (default), fast_erf, "
             "erf, or the tanh approximation")
    add("--attention_dropout_mode", type=str, default="probs",
        choices=["probs", "folded"],
        help="probs = HF dropout on the attention probabilities, fused into "
             "the flash kernels; folded = no probability dropout")
    add("--model_parallel_size", type=int, default=1)
    add("--pipeline_parallel_size", type=int, default=1)
    add("--pipeline_microbatches", type=int, default=2)
    add("--profile_dir", type=str, default=None)
    add("--num_cpu_devices", type=int, default=0)
    add("--sequence_parallel", action="store_true")
    add("--fsdp", action="store_true")
    add("--prng_impl", type=str, default="rbg",
        choices=["threefry2x32", "rbg", "unsafe_rbg"],
        help="read by the JAX package only")
    add("--sort_method", type=str, default="topological",
        choices=SORT_METHODS)
    add("--abd_pred_method", type=str, default="binary")
    add("--eval_on_every_iter", type=int, default=None)

    # --- the port's own ------------------------------------------------------
    add("--device", type=str, default="cuda",
        help="device to run on: cuda (default) or cpu")
    return p


def check_pipeline_flags(args, kind: str) -> None:
    """The JAX package's refusals of `--pipeline_parallel_size` beside the
    other layouts, with its errors (`train/cli.py:736-752`,
    `train/loop.py:69-84`, `:310-313`)."""
    if max(1, args.pipeline_parallel_size) <= 1:
        return
    if kind == "pretrain":
        raise NotImplementedError(
            "--pipeline_parallel_size pipelines the finetune text "
            "encoder stack (run_finetune); pretraining trains with dp")
    tp = max(1, args.model_parallel_size) > 1
    if args.wrapper_model_type == "berson":
        if tp:
            raise NotImplementedError(
                "--pipeline_parallel_size and --model_parallel_size both "
                "consume the mesh model axis — pick one for BERSON")
        if args.sequence_parallel:
            raise NotImplementedError(
                "--sequence_parallel is exclusive with the pipelined "
                "BERSON trunk")
        if args.multimodal:
            raise NotImplementedError(
                "pipelined BERSON covers the text trunk; multimodal "
                "inner encoders train with dp/tp/fsdp")
    elif tp or args.sequence_parallel:
        raise ValueError(
            "--pipeline_parallel_size is mutually exclusive with "
            "--model_parallel_size/--sequence_parallel (all "
            "consume the model axis)")


def parse_args(kind: str, argv=None):
    parser = build_parser(kind)
    args = resolve_args(parser.parse_args(argv))
    if kind != "eval":
        check_pipeline_flags(args, kind)
    extra = set(args.additional_wrapper_level_objectives or []) - {
        "time_contrastive"}
    if extra:
        # the JAX package reads time_contrastive alone and skips the rest
        logger.warning("--additional_wrapper_level_objectives %s: not an "
                       "objective of the wrapper; ignored, as in the JAX "
                       "package", sorted(extra))
    return args


def _is_detectron2(args) -> bool:
    return bool(args.multimodal
                and str(args.vision_model).startswith("detectron2"))


def resolve_args(args):
    """`--vision_image_size` defaults by vision family: 256 for detectron2_*
    (the reference's transform size), 224 otherwise. `--no_cuda` asks for
    the CPU: `--device cpu` (the JAX package accepts the flag and ignores
    it)."""
    if args.vision_image_size is None:
        args.vision_image_size = 256 if _is_detectron2(args) else 224
    if args.no_cuda:
        args.device = "cpu"
    return args


def resolve_output_dir(args) -> str:
    if args.output_root:
        return os.path.join(args.output_root, args.output_dir)
    return args.output_dir


def local_hf_model_files(path: Optional[str]) -> List[str]:
    """The files that make directory `path` a local HF model to the JAX
    package: a `config.json` with a top-level `hidden_size`, from which it
    builds the encoder (`train/cli.py::_encoder_config_from_local_hf`), and
    `pytorch_model.bin` or `model.safetensors`, which it looks for as weights
    (`models/convert.py::load_pretrained_weights`). Empty for a name that is
    not a directory (such as `simple`) and for a port checkpoint, whose
    `config.json` keeps `hidden_size` under `encoder`."""
    if not path or not os.path.isdir(path):
        return []
    found = [name for name in HF_WEIGHTS_NAMES
             if os.path.exists(os.path.join(path, name))]
    config = os.path.join(path, CONFIG_NAME)
    if os.path.exists(config):
        with open(config) as f:
            hf = json.load(f)
        if isinstance(hf, dict) and "hidden_size" in hf:
            found.insert(0, CONFIG_NAME)
    return found


def build_config(args):
    """argparse namespace -> (MultimodalConfig, tokenizer)."""
    from ..models.config import EncoderConfig, MultimodalConfig
    from ..data.tokenization import load_tokenizer

    tokenizer = load_tokenizer(args.tokenizer_name or args.model_name_or_path)
    vocab = len(tokenizer)
    enc = _encoder_config_from_local_hf(args)
    if enc is None:
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
    enc.attention_dropout_mode = args.attention_dropout_mode
    if args.sequence_parallel:
        enc.sequence_parallel = True
    cfg = MultimodalConfig(
        encoder=enc,
        max_story_length=args.max_story_length,
        min_story_length=args.min_story_length,
        max_seq_length=args.max_seq_length,
        per_seq_max_length=args.per_seq_max_length,
        cls_id=tokenizer.cls_token_id,
        pad_id=tokenizer.pad_token_id,
        mask_id=getattr(tokenizer, "mask_token_id", None) or 4,
        mlm_ignore_index=args.mlm_ignore_index,
        multimodal=args.multimodal,
        multimodal_model_type=args.multimodal_model_type,
        vision_model=args.vision_model,
        vision_feature_dim=args.vision_feature_dim,
        clip_model_name=args.clip_model_name,
        freeze_vision_model=args.freeze_vision_model,
        multimodal_text_part=args.multimodal_text_part,
        multimodal_img_part=args.multimodal_img_part,
        multimodal_fusion_method=args.multimodal_fusion_method,
        num_img_regional_features=args.include_num_img_regional_features,
        include_full_img_features=bool(args.include_full_img_features),
        image_size=(args.vision_image_size, args.vision_image_size),
        hierarchical_version=args.hierarchical_version,
        hl_include_objectives=args.hl_include_objectives or [],
        heatmap_decode_method=args.heatmap_decode_method,
        heatmap_decode_beam_size=args.heatmap_decode_beam_size,
        device_decode=args.device_decode,
        wrapper_model_type=args.wrapper_model_type,
        wrapper_model_with_heatmap=args.wrapper_model_with_heatmap,
        multimodal_pretrain_objectives=(
            args.multimodal_pretrain_objectives or []),
        mlm_probability=args.mlm_probability,
    )
    if args.multimodal_fusion_method != "sum":
        logger.warning(
            "--multimodal_fusion_method %s has no effect (as in the JAX "
            "package and the reference, whose only reader hardcodes 'mul')",
            args.multimodal_fusion_method)
    return cfg, tokenizer


def vision_config(cfg, args):
    """The CLIP tower's config for a multimodal `cfg` (None otherwise):
    `models.config.clip_vision_config` with `--model_size tiny`, at
    `--vision_image_size`, with `--clip_ref_fold_quirk`."""
    from ..models.config import clip_vision_config
    if not cfg.multimodal:
        return None
    return clip_vision_config(cfg, tiny=args.model_size == "tiny",
                              image_resolution=args.vision_image_size,
                              ref_fold_quirk=args.clip_ref_fold_quirk)


def _encoder_config_from_local_hf(args):
    """The encoder of the first of `--config_name`, `--model_name_or_path`
    that is a directory whose `config.json` has a top-level `hidden_size`
    (an HF config); None when neither is."""
    from ..models.config import EncoderConfig
    for cand in (args.config_name, args.model_name_or_path):
        if not cand or not os.path.isdir(cand):
            continue
        path = os.path.join(cand, CONFIG_NAME)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            hf = json.load(f)
        if "hidden_size" not in hf:
            continue
        model_type = hf.get("model_type", "roberta")
        return EncoderConfig(
            vocab_size=hf.get("vocab_size", 50265),
            hidden_size=hf["hidden_size"],
            num_hidden_layers=hf.get("num_hidden_layers", 12),
            num_attention_heads=hf.get("num_attention_heads", 12),
            intermediate_size=hf.get("intermediate_size",
                                     4 * hf["hidden_size"]),
            max_position_embeddings=hf.get("max_position_embeddings", 514),
            type_vocab_size=hf.get("type_vocab_size", 1),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            pad_token_id=hf.get("pad_token_id",
                                1 if model_type == "roberta" else 0),
            position_offset=2 if model_type == "roberta" else 0,
            hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
            attention_probs_dropout_prob=hf.get(
                "attention_probs_dropout_prob", 0.1),
        )
    return None


def _parse_task(args):
    """task_name '{data}_{tasktype}' -> (data_name, task_type)."""
    task_name = args.task_name or f"{args.data_name}_{args.task_type}"
    data_name, _, task_type = task_name.partition("_")
    return data_name, task_type


def _split_version(split: str):
    """'train-acl22' -> (split='train', version_text='acl22')."""
    if "-" in split:
        base, version = split.split("-", 1)
        return base, version
    return split, None


def _data_dir(args) -> str:
    """`--data_dir`, else the first of `--data_dirs`."""
    return args.data_dir or (args.data_dirs[0] if args.data_dirs else "")


def example_cache_path(args, data_name, task_type, split) -> str:
    """The JAX package's cache path for these examples with `_torch.pkl`
    in place of `.pkl`: `cached_{split}_{model}_{len}_{data}_{task}`
    under the data directory."""
    model_tag = os.path.basename(
        str(args.model_name_or_path).rstrip("/")) or "model"
    return os.path.join(
        _data_dir(args), f"cached_{split.replace('/', '_')}_{model_tag}_"
                       f"{args.max_seq_length}_{data_name}_{task_type}"
                       f"_torch.pkl")


def make_processor(args, data_name: str, split: str, for_task: str):
    """The processor of `{data_name}_{for_task}` for `split` (a
    `{split}-{version}` name reads that version's file), with the split's
    caption transformations; returns (processor, base split)."""
    from ..data.caption_transforms import select_caption_transforms
    from ..data.registry import get_processor
    base_split, version = _split_version(split)
    proc = get_processor(
        f"{data_name}_{for_task}", data_dir=_data_dir(args),
        order_criteria=args.order_criteria,
        min_story_length=args.min_story_length,
        max_story_length=args.max_story_length, version_text=version,
        caption_transforms=select_caption_transforms(args, data_name,
                                                     base_split),
        pure_class=for_task == "pure_class",
        paired_with_image=args.multimodal)
    return proc, base_split


def load_examples(args, data_name, task_type, split):
    """The examples of `task_type` (pairs, triples or whole stories) of a
    split. With `--use_cached`, read them from `example_cache_path` when it
    exists (unless `--overwrite_cache`), else write them there."""
    import pickle
    cache_path = None
    if args.use_cached and _data_dir(args):
        cache_path = example_cache_path(args, data_name, task_type, split)
        if os.path.exists(cache_path) and not args.overwrite_cache:
            logger.info("loading cached examples from %s", cache_path)
            with open(cache_path, "rb") as f:
                return pickle.load(f)
    proc, base_split = make_processor(args, data_name, split, task_type)
    if base_split == "train":
        examples = proc.get_train_examples()
    elif base_split in ("dev", "val"):
        examples = proc.get_dev_examples()
    else:
        examples = proc.get_test_examples()
    if cache_path:
        try:
            with open(cache_path, "wb") as f:
                pickle.dump(examples, f)
            logger.info("cached %d examples to %s", len(examples), cache_path)
        except OSError as e:
            logger.warning("could not write cache %s: %s", cache_path, e)
    return examples


def dataset_kwargs(args) -> dict:
    """Dataset arguments shared by the train dataset and the eval loader,
    so both ship images through one pipeline."""
    return dict(max_length=args.max_seq_length,
                per_seq_max_length=args.per_seq_max_length,
                max_story_length=args.max_story_length, seed=args.seed,
                multimodal=args.multimodal,
                image_size=(args.vision_image_size, args.vision_image_size),
                uint8_images=args.device_image_preprocess,
                image_transform=("detectron2" if _is_detectron2(args)
                                 else "imagenet"),
                num_img_regional_features=(
                    args.include_num_img_regional_features))


# the tasks each head trains on ("decode": the pure_decode encoder-decoder)
TRAIN_TASKS = {"v0": ("pairwise", "head", "abductive", "pure_class"),
               "v1": ("hl_v1", "pure_class"), "decode": ("pure_decode",)}
for _v in ("v2", "v3", "p0", "p1"):
    TRAIN_TASKS[_v] = TRAIN_TASKS["v1"]


def num_labels_of(task_type: str, max_story_length: int) -> int:
    """The classification head's width for a v0 task or eval role: 2 for
    pairwise and abductive, a class per step for head, per permutation for
    pure_class."""
    if task_type in ("pairwise", "abductive"):
        return 2
    if task_type == "head":
        return max_story_length
    if task_type == "pure_class":
        return math.factorial(max_story_length)
    raise ValueError(f"no classification head for {task_type!r}")


def make_dataset(args, tokenizer, task_type, examples, version="v0"):
    """The training set of `task_type` for the head `version`: step pairs,
    scrambled stories labelled by their first step, step triples, or
    scrambled stories labelled by permutation id (v0) or by order (the
    heat-map and pointer heads, the pure_decode decoder)."""
    from ..data.datasets import (AbductiveDataset, HeadPredDataset,
                                 PairwiseDataset, PureClassDataset)
    if task_type not in TRAIN_TASKS.get(version, ()):
        raise ValueError(
            f"task {task_type!r} does not train the {version} head (it "
            f"trains on {TRAIN_TASKS.get(version)})")
    common = dataset_kwargs(args)
    if task_type == "pairwise":
        return PairwiseDataset(examples, tokenizer, **common)
    if task_type == "head":
        return HeadPredDataset(examples, tokenizer, scramble=True, **common)
    if task_type == "abductive":
        return AbductiveDataset(examples, tokenizer,
                                pred_method=args.abd_pred_method, **common)
    return PureClassDataset(examples, tokenizer, scramble=True,
                            decode=version != "v0", **common)


def _sort_loader(args, tokenizer, data_name, split):
    from ..data.datasets import SortDataset, data_loader
    ds = SortDataset(load_examples(args, data_name, "sort", split), tokenizer,
                     **dataset_kwargs(args))
    return data_loader(ds, args.per_gpu_eval_batch_size)


def build_berson(cfg, args):
    """The BERSON wrapper of the flags (JAX `build_model`'s berson branch)."""
    from ..models.berson import BersonOrdering
    extra = args.additional_wrapper_level_objectives or []
    return BersonOrdering(cfg, vision_config(cfg, args),
                          beam_size=args.beam_size,
                          pairwise_loss_lam=args.pairwise_loss_lam,
                          time_contrastive="time_contrastive" in extra,
                          multimodal_loss=args.multimodal_loss)


def _evaluator(args, cfg, tokenizer, device):
    from ..data.packing import StoryPacker
    from .evaluation import SortEvaluator
    packer = StoryPacker(tokenizer, args.max_seq_length,
                         args.per_seq_max_length)
    return SortEvaluator(cfg, packer, device,
                         micro_batch=args.per_gpu_eval_batch_size * 4)


# ----- train ----------------------------------------------------------------


def main_train(argv=None):
    """Fine-tune the sequencer (a v0 classification head on its task, a
    heat-map or pointer head, with the auxiliary objectives), the
    pure_decode encoder-decoder (task `pure_decode`), or with
    `--wrapper_model_type berson` the BERSON wrapper; with `--do_eval`
    evaluate the checkpoints afterwards (the model in memory when there is
    none). Returns the loop's `TrainResult` (its `eval_results` maps
    checkpoint name -> metrics, for BERSON checkpoint name -> split ->
    metrics)."""
    args = parse_args("train", argv)
    if args.num_cpu_devices and "WORLD_SIZE" not in os.environ:
        return spawn_cpu_ranks("main_train", argv, args.num_cpu_devices)
    logging.basicConfig(level=logging.INFO)
    if args.multimodal_loss and args.wrapper_model_type != "berson":
        # the reference reads --multimodal_loss only inside the BERSON
        # wrapper
        logger.warning("--multimodal_loss has no effect without "
                       "--wrapper_model_type berson; ignoring")
    device, layout = _ranks(args)
    args.output_dir = resolve_output_dir(args)
    os.makedirs(args.output_dir, exist_ok=True)
    cfg, tokenizer = build_config(args)
    data_name, task_type = _parse_task(args)
    if task_type == "hl_v1" and cfg.hierarchical_version == "v0":
        args.hierarchical_version = cfg.hierarchical_version = "v1"
    if args.wrapper_model_type == "berson":
        return _train_berson(args, cfg, tokenizer, data_name, task_type,
                             device, layout)
    if task_type == "pure_decode":
        # the encoder-decoder over index tokens
        cfg.hierarchical_version = "decode"
    if cfg.hierarchical_version == "v0":
        cfg.num_labels = num_labels_of(task_type, args.max_story_length)
    from ..models.pure_decode import EncoderIndexDecoder
    from ..models.sequencer import SequencingModel
    from .checkpoint import find_checkpoints, restore_checkpoint
    from .loop import run_finetune

    dataset = make_dataset(
        args, tokenizer, task_type,
        load_examples(args, data_name, task_type, args.train_split),
        cfg.hierarchical_version)
    model = (EncoderIndexDecoder(cfg) if cfg.hierarchical_version == "decode"
             else SequencingModel(cfg, vision_config(cfg, args)))
    eval_fn = None
    if args.evaluate_during_training or args.do_eval:
        eval_fn = _make_dev_eval_fn(args, cfg, tokenizer, data_name, device)
    result = run_finetune(cfg, model, dataset, args, device,
                          eval_fn=eval_fn if args.evaluate_during_training
                          else None, tokenizer=tokenizer, layout=layout)
    logger.info("training done at step %d; checkpoints in %s",
                result.global_step, args.output_dir)
    if args.do_eval and eval_fn is not None:
        ckpts = find_checkpoints(
            args.output_dir,
            None if args.eval_all_checkpoints else args.iters_to_eval)
        if not ckpts:
            with gathered(result.model):
                res = eval_fn(result.model)
            result.eval_results[f"checkpoint-{result.global_step}"] = res
            logger.info("final-state eval: %s", res)
        for ck in ckpts:
            restore_checkpoint(ck, result.model)
            with gathered(result.model):
                res = eval_fn(result.model)
            result.eval_results[os.path.basename(ck)] = res
            logger.info("eval %s: %s", os.path.basename(ck), res)
    return result


def _ranks(args):
    """(this rank's device, the layout of the ranks): one process, or the
    process group of `torchrun` / `--num_cpu_devices` as a (data, model)
    mesh of `--model_parallel_size` model ranks, or of
    `--pipeline_parallel_size` stages (JAX's `make_mesh(n_model=pp)`)."""
    device = init_distributed("cpu" if args.num_cpu_devices
                              else args.device)
    pp = max(1, args.pipeline_parallel_size)
    n_model = pp if pp > 1 else max(1, args.model_parallel_size)
    return device, make_mesh(n_model=n_model, device_type=device.type)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_cpu_ranks(entry: str, argv, n: int):
    """`--num_cpu_devices N`: run entry point `entry` of this module on N
    gloo ranks on the CPU, each a process of its own; returns rank 0's
    `TrainResult` without its model and optimizer (`model` and `optimizer`
    None). A rank that fails stops the others and raises RuntimeError."""
    import torch.multiprocessing as mp
    argv = list(sys.argv[1:] if argv is None else argv)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_cpu_rank,
                         args=(entry, argv, rank, n, port, results))
             for rank in range(n)]
    for p in procs:
        p.start()
    result = None
    try:
        while any(p.is_alive() for p in procs) or not results.empty():
            if not results.empty():
                result = results.get()
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"--num_cpu_devices: rank "
                                   f"{procs.index(failed[0])} exited with "
                                   f"code {failed[0].exitcode}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return result


def _cpu_rank(entry: str, argv, rank: int, n: int, port: int, results):
    os.environ.update(WORLD_SIZE=str(n), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    import torch.distributed as dist
    result = globals()[entry](argv)
    if rank == 0:
        result.model = result.optimizer = None
        results.put(result)
    dist.destroy_process_group()


def _train_berson(args, cfg, tokenizer, data_name, task_type, device,
                  layout):
    """`main_train`'s BERSON branch: train, then with `--do_eval` run the
    beam-search eval of every checkpoint (or the final model) over every
    eval split, each result written to
    `eval_results_split_{split}_{checkpoint}.txt`."""
    from ..data.datasets import BersonDataset
    from .checkpoint import find_checkpoints, restore_checkpoint
    from .loop import run_berson_training

    dataset = BersonDataset(
        load_examples(args, data_name, task_type, args.train_split),
        tokenizer, scramble=True, **dataset_kwargs(args))
    eval_fn = None
    if args.evaluate_during_training:
        eval_fn = _make_berson_eval_fn(args, tokenizer, data_name,
                                       args.eval_splits[0], device)
    result = run_berson_training(cfg, build_berson(cfg, args), dataset, args,
                                 device, eval_fn=eval_fn, tokenizer=tokenizer,
                                 layout=layout)
    logger.info("training done at step %d; checkpoints in %s",
                result.global_step, args.output_dir)
    if not args.do_eval:
        return result
    ckpts = find_checkpoints(
        args.output_dir,
        None if args.eval_all_checkpoints else args.iters_to_eval)
    for split in args.eval_splits:
        eval_fn = _make_berson_eval_fn(args, tokenizer, data_name, split,
                                       device)
        if eval_fn is None:
            continue
        for ck in ckpts or [None]:
            if ck:
                restore_checkpoint(ck, result.model)
            with gathered(result.model):
                res = eval_fn(result.model)
            tag = (os.path.basename(ck.rstrip("/")) if ck
                   else f"checkpoint-{result.global_step}")
            logger.info("berson eval %s split %s: %s", tag, split, res)
            result.eval_results.setdefault(tag, {})[split] = res
            if not is_rank0():
                continue
            with open(os.path.join(
                    args.output_dir,
                    f"eval_results_split_{split}_{tag}.txt"), "w") as f:
                for k, v in sorted(res.items()):
                    f.write(f"{k} = {v}\n")
    return result


def _make_berson_eval_fn(args, tokenizer, data_name, split, device):
    """The beam-search metrics (partial match, exact match, tau) of a BERSON
    model over `BersonDataset` stories of `split`, as the JAX package's
    `_make_berson_eval_fn`: the orders as the beam search returns them,
    against the labels padded with the dead step indices. None when the
    split has no data."""
    import numpy as np
    from ..data.datasets import BersonDataset, data_loader
    from ..utils.metrics import compute_metrics
    from .steps import device_batch
    try:
        examples = load_examples(args, data_name, "sort", split)
    except (FileNotFoundError, ValueError) as e:
        logger.warning("no dev split for berson eval: %s", e)
        return None
    ds = BersonDataset(examples, tokenizer, scramble=True,
                       **dataset_kwargs(args))

    def eval_fn(model):
        model.eval()
        preds, labels = [], []
        for bi, batch in enumerate(data_loader(
                ds, args.per_gpu_eval_batch_size)):
            if args.max_eval_steps is not None and bi >= args.max_eval_steps:
                break
            with torch.inference_mode():
                pred = model.beam_search(device_batch(batch, device))
            for i, p in enumerate(pred.cpu().numpy()):
                if batch["valid"][i]:
                    preds.append(p.tolist())
                    labels.append(np.asarray(batch["labels"][i]))
        return {m: compute_metrics(args, m, preds, labels)
                for m in ("partial_match", "exact_match", "tau")}

    return eval_fn


def _make_dev_eval_fn(args, cfg, tokenizer, data_name, device):
    """Decode metrics on the first eval split during and after training:
    `heat_map` for a heat-map head, `pure_decode` for a pointer head (the
    `pointer` role) or the encoder-decoder, `topological` with the model as
    the pairwise role for v0 (whatever its task, as in the JAX package);
    the loop keys the best checkpoint on partial + exact match."""
    split = args.eval_splits[0]
    try:
        load_examples(args, data_name, "sort", split)
    except (FileNotFoundError, ValueError) as e:
        logger.warning("no dev split for eval-during-training: %s", e)
        return None
    evaluator = _evaluator(args, cfg, tokenizer, device)
    method, role = EVAL_OF_VERSION[cfg.hierarchical_version]

    def eval_fn(model):
        return evaluator.evaluate(
            _sort_loader(args, tokenizer, data_name, split), method,
            {role: model}, max_batches=args.max_eval_steps,
            args_ns=args,
            output_dir=(args.output_dir if args.eval_save_all_results
                        else None),
            data_split=split)

    return eval_fn


# ----- pretrain -------------------------------------------------------------


def main_pretrain(argv=None):
    """Pretrain `SequencingPretrainer` (MLM and the
    `--multimodal_pretrain_objectives`) on the stories of every
    (`--data_dirs`, `--data_names`) pair, concatenated (else `--data_dir`,
    `--data_name`), from `--train_split`. With `--evaluate_during_training`
    the dev MLM loss and perplexity of the first pair's first
    `--eval_splits` split run at each save; with `--do_eval` after training
    too, written to `eval_results_pretrain.txt`. Returns the loop's
    `TrainResult` (`eval_results`: the final evaluation)."""
    from ..data.datasets import PretrainDataset
    from ..models.pretrainer import SequencingPretrainer, resolve_objectives
    from .loop import evaluate_pretraining, run_pretraining

    args = parse_args("pretrain", argv)
    if args.num_cpu_devices and "WORLD_SIZE" not in os.environ:
        return spawn_cpu_ranks("main_pretrain", argv, args.num_cpu_devices)
    logging.basicConfig(level=logging.INFO)
    if max(1, args.model_parallel_size) > 1:
        logger.warning("--model_parallel_size: pretraining is "
                       "data-parallel only, as in the JAX package; every "
                       "rank is a data rank")
    device = init_distributed("cpu" if args.num_cpu_devices else args.device)
    layout = make_mesh(device_type=device.type)
    args.output_dir = resolve_output_dir(args)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.task_type is None:
        args.task_type = "pretrain"
    cfg, tokenizer = build_config(args)
    names = args.data_names or [args.data_name]
    dirs = args.data_dirs or [args.data_dir]
    examples = []
    for data_name, data_dir in zip(names, dirs):
        sub = copy.copy(args)
        sub.data_dir, sub.data_dirs = data_dir, None
        examples.extend(load_examples(sub, data_name, "pretrain",
                                      args.train_split))
    args.data_dir = dirs[0]
    dataset = PretrainDataset(examples, tokenizer, **dataset_kwargs(args))
    model = SequencingPretrainer(cfg, vision_config(cfg, args))
    dev_dataset = None
    if args.evaluate_during_training or args.do_eval:
        try:
            dev_dataset = PretrainDataset(
                load_examples(args, names[0], "pretrain", args.eval_splits[0]),
                tokenizer, **dataset_kwargs(args))
        except (FileNotFoundError, ValueError) as e:
            logger.warning("no pretrain dev split (%s); eval disabled", e)
    result = run_pretraining(cfg, model, dataset, args, device,
                             tokenizer=tokenizer, dev_dataset=dev_dataset,
                             layout=layout)
    logger.info("pretraining done at step %d", result.global_step)
    if args.do_eval and dev_dataset is not None:
        with gathered(result.model):
            res = evaluate_pretraining(
                cfg, result.model, args, dev_dataset,
                use_mlm=resolve_objectives(
                    cfg.multimodal_pretrain_objectives)[1],
                max_eval_steps=args.max_eval_steps)
        logger.info("pretrain eval: %s", res)
        if is_rank0():
            with open(os.path.join(args.output_dir,
                                   "eval_results_pretrain.txt"), "w") as f:
                for k, v in res.items():
                    f.write(f"{k} = {v}\n")
        result.eval_results = res
    return result


# ----- eval -----------------------------------------------------------------


def main_eval(argv=None):
    """Parse the flags, evaluate every split; returns {split: metrics}."""
    return run_eval(argv)[0]


def run_eval(argv=None):
    """The body of `main_eval`; also returns the `SortEvaluator`, whose
    counts and per-batch times a caller may read.

    `--eval_all_checkpoints` (every checkpoint) or `--iters_to_eval` (those
    named) evaluates each checkpoint under `--model_name_or_path_1` (else
    `--model_name_or_path`) when that is a directory, else under
    `--output_dir`. With more than one, the results are keyed by checkpoint
    name and each split is written as `{split}_{name}`. `pure_decode` takes
    a pure_decode model, or with `--hierarchical_version p0|p1` a pointer
    model (the `pointer` role)."""
    args = parse_args("eval", argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    args.output_dir = resolve_output_dir(args)
    cfg, tokenizer = build_config(args)
    data_name, _ = _parse_task(args)
    roles = ROLES_BY_METHOD[args.sort_method]
    if (args.sort_method == "pure_decode"
            and args.hierarchical_version in POINTER_VERSIONS):
        roles = ["pointer"]
    evaluator = _evaluator(args, cfg, tokenizer, device)
    base_path = args.model_name_or_path_1 or args.model_name_or_path
    paths = [base_path]
    if args.eval_all_checkpoints or args.iters_to_eval:
        from .checkpoint import find_checkpoints
        root = (base_path if base_path and os.path.isdir(base_path)
                else args.output_dir)
        paths = find_checkpoints(
            root, None if args.eval_all_checkpoints else args.iters_to_eval
        ) or paths
    all_results = {}
    for path in paths:
        # the first role takes the swept path, the others
        # --model_name_or_path_2 and _3
        role_paths = [path, args.model_name_or_path_2,
                      args.model_name_or_path_3]
        models = {role: load_model_for_eval(
            cfg, role_path, device, vision_config(cfg, args), role=role,
            beam_size=args.beam_size,
            pairwise_loss_lam=args.pairwise_loss_lam)
            for role, role_path in zip(roles, role_paths)}
        tag = os.path.basename(str(path).rstrip("/")) if len(paths) > 1 \
            else None
        results = {}
        for split in args.data_splits or args.eval_splits:
            res = evaluator.evaluate(
                _sort_loader(args, tokenizer, data_name, split),
                args.sort_method, models, metrics=args.metrics,
                output_dir=args.output_dir,
                data_split=split if tag is None else f"{split}_{tag}",
                max_batches=args.max_eval_steps, args_ns=args,
                every_n=args.eval_on_every_iter)
            results[split] = res
            logger.info("%ssplit %s: %s", f"[{tag}] " if tag else "", split,
                        res)
        if tag:
            all_results[tag] = results
        else:
            all_results = results
    return all_results, evaluator


# the models each sort method evaluates with, in the order of
# --model_name_or_path_1 (or --model_name_or_path), _2 and _3
ROLES_BY_METHOD = {
    "topological": ["pairwise"],
    "head_and_topological": ["head", "pairwise"],
    "head_and_sequential": ["head", "pairwise"],
    "head_and_sequential_abductive": ["head", "pairwise", "abductive"],
    "pure_class": ["pure_class"],
    "pure_decode": ["pure_decode"],
    "heat_map": ["heatmap"],
    "berson": ["berson"],
}
# the v0 roles, each with the head width of its task (`num_labels_of`)
V0_ROLES = ("pairwise", "abductive", "head", "pure_class")
# the head versions a checkpoint of each sequencer role may have
ROLE_VERSIONS = {"heatmap": HEATMAP_VERSIONS, "pointer": POINTER_VERSIONS,
                 "pure_decode": ("decode",)}
ROLE_VERSIONS.update(dict.fromkeys(V0_ROLES, ("v0",)))
# the (sort method, role) that evaluate a model of each head version: the
# dev eval's, and the method a checkpoint in another role is sent to
EVAL_OF_VERSION = {"v0": ("topological", "pairwise"),
                   "p0": ("pure_decode", "pointer"),
                   "p1": ("pure_decode", "pointer"),
                   "decode": ("pure_decode", "pure_decode")}
EVAL_OF_VERSION.update(dict.fromkeys(HEATMAP_VERSIONS,
                                     ("heat_map", "heatmap")))


def _method_of(version: str) -> str:
    """The eval flags for a checkpoint of head `version`."""
    method, role = EVAL_OF_VERSION[version]
    return method + (f" --hierarchical_version {version}"
                     if role == "pointer" else "")

# the saved config's fields that decide a checkpoint's parameters (the
# VisualBERT and naive towers' among them)
_SAVED_FIELDS = ("encoder", "hierarchical_version", "num_labels",
                 "multimodal",
                 "multimodal_model_type", "clip_model_name",
                 "multimodal_text_part", "multimodal_img_part",
                 "use_positional_embedding", "use_token_type_embedding",
                 "image_size", "wrapper_model_with_heatmap",
                 "hl_include_objectives", "vision_model",
                 "vision_feature_dim", "vision_stride_in_1x1",
                 "num_img_regional_features", "include_full_img_features",
                 "bypass_transformer", "visual_feat_dim")


def load_model_for_eval(cfg, path: Optional[str], device, vision_cfg=None,
                        role: str = "heatmap", beam_size: int = 16,
                        pairwise_loss_lam: float = 0.6):
    """The model of an eval `role` on `device`, ready for inference: the
    heat-map sequencer (`heatmap`), a p0/p1 pointer sequencer (`pointer`),
    the pure_decode encoder-decoder (`pure_decode`), a v0 classification
    sequencer (`pairwise` and `abductive`: 2 labels, `head`:
    `max_story_length`, `pure_class`: N!) or `BersonOrdering` (`berson`,
    built with `beam_size` and `pairwise_loss_lam` and without the
    image-stream pairwise head, as the JAX eval builds it). The checkpoint
    at `path` when it is a directory (its saved encoder, head version and
    width, heat-map aux, auxiliary objectives and multimodal fields, and
    its tower's `vision_config.json`; `vision_cfg` where a multimodal
    checkpoint has none), else a fresh init seeded from 0 (with
    `vision_cfg`'s tower). A directory that is not a checkpoint of this
    package (a local HF model, a run directory), a checkpoint of another
    model, head version or head width than the role's (the error names
    the sort method for it), and a BERSON checkpoint trained with
    `--multimodal_loss` (whose image-stream head the eval model lacks: the
    JAX eval's restore refuses it too) raise ValueError."""
    from ..models.berson import BersonOrdering
    from ..models.config import CLIPVisionConfig, MultimodalConfig
    from ..models.pure_decode import EncoderIndexDecoder
    from .checkpoint import VISION_CONFIG_NAME
    from ..models.sequencer import (SequencingModel, cast_for_inference,
                                    init_weights)

    berson = role == "berson"
    role_cfg = copy.deepcopy(cfg)
    if role in V0_ROLES:
        role_cfg.num_labels = num_labels_of(role, cfg.max_story_length)
    if not berson and role_cfg.hierarchical_version not in \
            ROLE_VERSIONS[role]:
        role_cfg.hierarchical_version = ROLE_VERSIONS[role][0]

    def build(vcfg):
        if berson:
            return BersonOrdering(role_cfg, vcfg, beam_size=beam_size,
                                  pairwise_loss_lam=pairwise_loss_lam)
        if role == "pure_decode":
            return EncoderIndexDecoder(role_cfg)
        return SequencingModel(role_cfg, vcfg)

    if path and os.path.isdir(path):
        if not os.path.exists(os.path.join(path, WEIGHTS_NAME)):
            hf = local_hf_model_files(path)
            raise ValueError(
                f"{path} is not a checkpoint of this package (no "
                f"{WEIGHTS_NAME})"
                + (f"; it is a local HF model ({', '.join(hf)}), which the "
                   f"eval does not load, as in the JAX package: train on it "
                   f"first" if hf else ""))
        with open(os.path.join(path, CONFIG_NAME)) as f:
            saved = MultimodalConfig.from_json(f.read())
        version = saved.hierarchical_version
        if (saved.wrapper_model_type == "berson") != berson:
            raise ValueError(
                f"{path} is a checkpoint of "
                f"{'BERSON' if not berson else 'the sequencer'}; "
                f"evaluate it with --sort_method "
                f"{_method_of(version) if berson else 'berson'}")
        if not berson and (
                version not in ROLE_VERSIONS[role]
                or (role in V0_ROLES
                    and saved.num_labels != role_cfg.num_labels)):
            raise ValueError(
                f"{path} is a checkpoint of the {version} head with "
                f"{saved.num_labels} labels; the {role} role takes the "
                + (f"v0 head with {role_cfg.num_labels} labels"
                   if role in V0_ROLES else
                   f"{'/'.join(ROLE_VERSIONS[role])} head")
                + f" (evaluate it with --sort_method "
                  f"{_method_of(version)})")
        for name in _SAVED_FIELDS:
            setattr(role_cfg, name, getattr(saved, name))
        vision_path = os.path.join(path, VISION_CONFIG_NAME)
        if os.path.exists(vision_path):
            with open(vision_path) as f:
                vision_cfg = CLIPVisionConfig.from_json(f.read())
        model = build(vision_cfg)
        weights = torch.load(os.path.join(path, WEIGHTS_NAME),
                             map_location="cpu", weights_only=True)
        if berson and any(k.startswith("img_projection.") for k in weights):
            raise ValueError(
                f"{path} was trained with --multimodal_loss: the eval's "
                f"BERSON has no image-stream pairwise head for its "
                f"img_projection / img_pairwise weights (the JAX eval's "
                f"restore refuses such a checkpoint as well); evaluate it "
                f"with main_train's --do_eval")
        model.load_state_dict(weights)
    else:
        model = init_weights(build(vision_cfg), 0)
    return cast_for_inference(model.to(device)).eval()
