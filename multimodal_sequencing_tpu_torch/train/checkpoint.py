"""Checkpoints with the JAX package's directory contract (counterpart of
`train/checkpoint.py`).

`checkpoint-{step}` (or `checkpoint-best`) folders holding `config.json`,
`model.pt` (the weights' state dict, BatchNorm statistics included, the
format `main_eval` loads), for a multimodal model `vision_config.json` (its
CLIP tower's config, which `config.json` shares with the JAX package and so
cannot hold),
`optimizer.pt` (global step, optimizer counts and moments),
`training_args.json` and the tokenizer's own files (`simple_tokenizer.json`
for the built-in tokenizer), so `trainers.eval --model_name_or_path
<checkpoint>` loads both the tokenizer and the weights. Resume parses the global step from the folder name.
The JAX package's orbax checkpoints are not read here (orbax imports JAX);
weights cross over through `models/convert.py::params_from_jax`.

A parallelized model (`parallel/sharding_rules.py`) saves the same files:
every rank gathers the whole tensors (a collective), rank 0 writes them,
and the others wait for it; a restore loads the whole tensors and each
rank keeps its part. So a checkpoint of any rank layout loads into a
single-process eval, and the reverse.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

import torch

from ..parallel.mesh import barrier, is_rank0
from ..parallel.sharding_rules import full_state_dict, load_full_state_dict

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "model.pt"
OPTIMIZER_NAME = "optimizer.pt"
ARGS_NAME = "training_args.json"
VISION_CONFIG_NAME = "vision_config.json"


def save_model(model, cfg, path: str, state=None) -> None:
    """`config.json` + `model.pt` (+ `vision_config.json`) in `path`
    (`state`: the model's whole-tensor state dict, when already
    gathered). On a parallelized model every rank calls it; rank 0
    writes."""
    state = full_state_dict(model) if state is None else state
    if not is_rank0():
        return
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG_NAME), "w") as f:
        f.write(cfg.to_json())
    vision_cfg = getattr(model, "vision_cfg", None)
    if vision_cfg is not None:
        with open(os.path.join(path, VISION_CONFIG_NAME), "w") as f:
            f.write(vision_cfg.to_json())
    torch.save(state, os.path.join(path, WEIGHTS_NAME))


def save_checkpoint(output_dir: str, step: int, model, optimizer, cfg,
                    training_args: Optional[dict] = None,
                    name: Optional[str] = None, tokenizer=None) -> str:
    """Write `checkpoint-{step}` (or `checkpoint-{name}`); returns its path."""
    tag = name if name is not None else str(step)
    ckpt_dir = os.path.join(os.path.abspath(output_dir), f"checkpoint-{tag}")
    weights = full_state_dict(model)
    state = dict(optimizer.state_dict())
    for key in ("mu", "nu", "acc"):
        if key in state:
            state[key] = {n: t.detach().cpu() for n, t in state[key].items()}
    if is_rank0():
        save_model(model, cfg, ckpt_dir, weights)
        torch.save({"step": step, "optimizer": state},
                   os.path.join(ckpt_dir, OPTIMIZER_NAME))
        if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
            tokenizer.save_pretrained(ckpt_dir)
        if training_args is not None:
            with open(os.path.join(ckpt_dir, ARGS_NAME), "w") as f:
                json.dump(training_args, f, indent=2, default=str)
    barrier()
    return ckpt_dir


def restore_checkpoint(ckpt_dir: str, model, optimizer=None) -> int:
    """Load `model.pt` into `model` and, when `optimizer` is given, its
    state (`--do_not_load_optimizer` passes None: weights only). Returns the
    saved global step."""
    load_full_state_dict(model, torch.load(os.path.join(ckpt_dir, WEIGHTS_NAME),
                                           map_location="cpu",
                                           weights_only=True))
    saved = torch.load(os.path.join(ckpt_dir, OPTIMIZER_NAME),
                       map_location="cpu", weights_only=True)
    if optimizer is not None:
        optimizer.load_state_dict(saved["optimizer"])
    return int(saved["step"])


def parse_step_from_name(path: str) -> int:
    """global_step from a checkpoint folder name; 0 for `checkpoint-best`."""
    m = re.search(r"checkpoint-(\d+)", os.path.basename(path.rstrip("/")))
    return int(m.group(1)) if m else 0


def find_checkpoints(output_dir: str, iters_to_eval=None):
    """Checkpoint folders under output_dir in numeric step order (named
    tags such as checkpoint-best first), optionally filtered by
    `--iters_to_eval` entries (numbers or 'best')."""
    dirs = sorted(glob.glob(os.path.join(output_dir, "checkpoint-*")),
                  key=parse_step_from_name)
    if not iters_to_eval:
        return dirs
    wanted = {str(x) for x in iters_to_eval}
    return [d for d in dirs
            if os.path.basename(d).split("checkpoint-")[-1] in wanted]
